"""The port's ``ppermute`` / ``psum`` / ``pmax`` over a list of tiles that
may live in several processes.

The reference's tiled steps (pedoni_tpu/parallel/tile2d.py:234-260,
spatial.py:232-243) move fixed-size buffers between mesh neighbours with
``lax.ppermute`` and reduce their metrics with ``psum`` / ``pmax``
(tile2d.py:355-358, spatial.py:303-312).  Here the tiles (strips, for
parallel/spatial.py) are numbered 0..n-1 and a transport moves the same
buffers between them:

- ``shift(*moves)``: each move is ``(perm, send, recv)``, where ``perm``
  lists (source tile, destination tile) pairs, as ppermute's does, and
  ``send`` / ``recv`` hold this process's tiles' buffers in tile order; the
  destination's buffer is overwritten with the source's.  A tile that is
  no pair's destination keeps what its buffer held, so a caller that
  wants ppermute's zeros passes zero buffers (spatial) and one that wants
  its ghosts kept passes the ghosts (tile2d);
- ``all_sum`` / ``all_max``: a 1-d tensor of metrics, already reduced over
  this process's tiles, reduced over every process (``all_reduce_metrics``
  reduces a step's metrics; one process has nothing to reduce);
- ``collect``: every tile's tensor of one shape, on the first process (or
  on all), for a gather of the whole grid;
- ``check_same``: raise unless every process holds the same tensors
  (``check_replicated``: the replicated initial state and the first spawn
  candidates; one process has nothing to check).

Two implementations: ``Local`` (every tile in this process: copies between
tensors) and ``ProcessGroup`` (``torch.distributed``'s default group,
which the caller has initialized: rank r owns a contiguous block of n /
world tiles; pairs inside a rank copy, pairs across ranks go through
``batch_isend_irecv``, the metrics through ``all_reduce``).  NCCL sends
the card's tensors (one rank a card; the caller sets its card with
``torch.cuda.set_device``).  Gloo sends host tensors only, so on a card
each crossing buffer is staged through a pinned host buffer: this is what
lets two ranks share one card, where NCCL refuses.  The backend is the
group's own; nothing switches it, or the device, behind the caller's back.

``run_ranks`` starts the processes of a group and stops all of them when
one fails or a time limit passes.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
import tempfile
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..models.sfm import spawn_sampler

Move = tuple[Sequence[tuple[int, int]], Sequence[torch.Tensor],
             Sequence[torch.Tensor]]


def _digest(tensors: Sequence[torch.Tensor]) -> int:
    """A 56-bit hash of the tensors' bytes, shapes and dtypes (a host copy)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return int.from_bytes(h.digest()[:7], "little")


class Local:
    """Every tile in this process: ``shift`` copies between tensors (across
    devices where the tiles' devices differ), ``all_sum`` is the
    identity."""

    rank = 0
    world = 1

    def __init__(self, n_tiles: int) -> None:
        self.n_tiles = n_tiles
        self.tiles = range(n_tiles)

    def shift(self, *moves: Move) -> None:
        for perm, send, recv in moves:
            for s, d in perm:
                recv[d].copy_(send[s])

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def collect(self, own: Sequence[torch.Tensor], everywhere: bool = False
                ) -> list[torch.Tensor]:
        return list(own)


class ProcessGroup:
    """The tiles of ``torch.distributed``'s default group, which must be
    initialized: rank r owns tiles [r * n / world, (r + 1) * n / world).
    Gloo or NCCL, as the group was made; on gloo, tensors on a card cross
    through pinned host buffers (``_buffer``)."""

    def __init__(self, n_tiles: int) -> None:
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroup needs torch.distributed initialized")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        if n_tiles % self.world:
            raise ValueError(f"{n_tiles} tiles do not divide over "
                             f"{self.world} processes")
        self.n_tiles = n_tiles
        self.per = n_tiles // self.world
        self.tiles = range(self.rank * self.per, (self.rank + 1) * self.per)
        self.backend = dist.get_backend()
        self._pinned: dict[tuple, torch.Tensor] = {}

    def owner(self, tile: int) -> int:
        return tile // self.per

    def _buffer(self, t: torch.Tensor, key: tuple) -> torch.Tensor:
        """A contiguous tensor that the backend can send or receive for
        ``t``: on gloo, for a card's tensor, a pinned host buffer kept for
        ``key`` (allocating pinned memory is slow); else a new tensor on
        ``t``'s device."""
        if self.backend == "gloo" and t.is_cuda:
            key = (key, tuple(t.shape), t.dtype)
            if key not in self._pinned:
                self._pinned[key] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
            return self._pinned[key]
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)

    def shift(self, *moves: Move) -> None:
        """Pairs within this rank copy; pairs across ranks are posted in one
        ``batch_isend_irecv`` (each pair's tag its place in ``moves``, the
        same on both ranks), and the received buffers are copied into
        place once all have arrived."""
        first = self.tiles.start
        ops, landed = [], []
        tag = 0
        for perm, send, recv in moves:
            for s, d in perm:
                mine_s, mine_d = s in self.tiles, d in self.tiles
                if mine_s and mine_d:
                    recv[d - first].copy_(send[s - first])
                elif mine_s:
                    buf = self._buffer(send[s - first], ("send", tag))
                    buf.copy_(send[s - first])
                    ops.append(dist.P2POp(dist.isend, buf, self.owner(d), tag=tag))
                elif mine_d:
                    buf = self._buffer(recv[d - first], ("recv", tag))
                    ops.append(dist.P2POp(dist.irecv, buf, self.owner(s), tag=tag))
                    landed.append((recv[d - first], buf))
                tag += 1
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for dst, buf in landed:
            dst.copy_(buf)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.to("cpu" if self.backend == "gloo" else x.device, copy=True)
        dist.all_reduce(y, op=op)
        return y.to(x.device)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def collect(self, own: Sequence[torch.Tensor], everywhere: bool = False
                ) -> list[torch.Tensor] | None:
        """Every tile's tensor (one shape and dtype for all), in tile order,
        on the device of ``own[0]``: on rank 0, or on every rank with
        ``everywhere``; None on the others."""
        mine = torch.stack(list(own))
        dev = mine.device
        if self.backend == "gloo":
            mine = mine.cpu()
        if everywhere:
            parts = [torch.empty_like(mine) for _ in range(self.world)]
            dist.all_gather(parts, mine)
        else:
            parts = ([torch.empty_like(mine) for _ in range(self.world)]
                     if self.rank == 0 else None)
            dist.gather(mine, parts, dst=0)
            if parts is None:
                return None
        return [t.to(dev) for part in parts for t in part.unbind(0)]

    def check_same(self, what: str, tensors: Sequence[torch.Tensor]) -> None:
        """One MAX ``all_reduce`` of (hash, -hash): equal hashes on every
        rank, or a ValueError naming ``what``."""
        h = _digest(tensors)
        dev = tensors[0].device if self.backend == "nccl" else "cpu"
        both = torch.tensor([h, -h], dtype=torch.int64, device=dev)
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        hi, lo = int(both[0]), -int(both[1])
        if hi != lo:
            raise ValueError(f"{what} differs between the {self.world} "
                             f"processes (hashes {lo:#x} .. {hi:#x}): every "
                             "rank must build from the same seed and inputs")


Transport = Local | ProcessGroup


def check_replicated(transport: Transport, cfg, agents,
                     generator: torch.Generator | None = None) -> None:
    """Across processes every rank holds the same flat agents and draws the
    same spawn candidates from a generator of the same seed, with no
    communication (the reference's replicated key, spatial.py:176-183):
    one ``all_reduce`` checks the agents and the first candidates that
    ``generator`` will draw (a copy of it draws them), and a ValueError is
    raised where they differ."""
    if transport.world == 1:
        return
    same = list(agents)
    if generator is not None and cfg.spawn.total > 0:
        ahead = torch.Generator(device=generator.device)
        ahead.set_state(generator.get_state())
        same += list(spawn_sampler(cfg, generator.device)(ahead))
    transport.check_same("the initial state or the first spawn candidates", same)


def transport_for(n_tiles: int) -> Transport:
    """``ProcessGroup`` where torch.distributed is initialized with a world
    size above 1, else ``Local``: the counterpart of the reference's
    ``jax.devices()``, which is global once ``jax.distributed`` is up."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return ProcessGroup(n_tiles)
    return Local(n_tiles)


def run_ranks(argv_of: Callable[[int, str], list[str]], world: int,
              timeout: float, env: dict[str, str] | None = None,
              cwd: str | None = None) -> list[str]:
    """Start ``world`` processes, ``argv_of(rank, store)`` each (``store``:
    the path of a fresh file for ``init_process_group``'s
    ``file://`` rendezvous), and wait for all of them.  When one exits
    non-zero, or ``timeout`` seconds pass, every one still running is
    killed and a RuntimeError carries each rank's exit code and the end of
    its output.  Returns each rank's standard output."""
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as files:
        store = os.path.join(tmp, "store")
        logs = [files.enter_context(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                for r in range(world)]
        procs = []
        failed = None
        try:
            for r in range(world):
                procs.append(subprocess.Popen(argv_of(r, store), stdout=logs[r],
                                              stderr=subprocess.STDOUT, env=env,
                                              cwd=cwd))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    failed = "a rank failed"
                    break
                if time.monotonic() > deadline:
                    failed = f"timed out after {timeout:.0f} s"
                    break
                time.sleep(0.05)
            if failed is None and any(p.returncode != 0 for p in procs):
                failed = "a rank failed"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
    if failed is not None:
        detail = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{out[-3000:]}"
                           for r, (p, out) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{world} ranks: {failed}\n{detail}")
    return outs


SUMMED = ("n_active", "n_spawned", "n_dropped", "n_overflow", "n_exited")
MAXED = ("max_demand", "max_mover_demand")


def all_reduce_metrics(transport: Transport, m):
    """StepMetrics reduced over this process's tiles, reduced over every
    process: one SUM and one MAX ``all_reduce`` of the packed 0-d values,
    so that every rank returns the same metrics (``m`` itself in one
    process)."""
    if transport.world == 1:
        return m
    s = transport.all_sum(torch.stack([getattr(m, f) for f in SUMMED]))
    x = transport.all_max(torch.stack([getattr(m, f) for f in MAXED]))
    return m._replace(**dict(zip(SUMMED, s.unbind())),
                      **dict(zip(MAXED, x.unbind())))
