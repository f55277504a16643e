"""Checkpoint / resume, in the reference's npz schema (pedoni_tpu/
checkpoint.py:17-54), so a checkpoint crosses between the two packages
and between the flat and the grid backend with its agents exact: it holds
the flat agents, which the grid backend bins on restore.

Fields: ``version``, ``pos``, ``vel``, ``speed``, ``dest``, ``active``,
``key``, ``step`` and ``step_count``, with the reference's dtypes and
shapes.  ``key`` is the reference's JAX PRNG key, which torch cannot
continue: the port writes a zero placeholder of the key's dtype and shape
(uint32 [2]), so that the reference's ``load_state`` reads the file, and
stores its own ``torch.Generator`` state in a field of its own,
``torch_generator`` (with ``torch_generator_device``, the generator's
device type), which the reference ignores.  Restoring a checkpoint that
has no such field (one the reference wrote), or one written for a
generator on another device type, reseeds the simulator's generator from
its options' ``seed``: the agents resume exactly, the spawn stream does
not.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from .models.sfm import AgentState, SimState

log = logging.getLogger(__name__)

FORMAT_VERSION = 1
KEY_PLACEHOLDER = np.zeros((2,), np.uint32)  # jax.random.PRNGKey's shape


def save_state(state: SimState, path: str | Path, step_count: int = 0,
               generator: torch.Generator | None = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    a = state.agents
    extra = {}
    if generator is not None:
        extra = dict(torch_generator=generator.get_state().numpy(),
                     torch_generator_device=generator.device.type)
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        pos=a.pos.cpu().numpy(),
        vel=a.vel.cpu().numpy(),
        speed=a.speed.cpu().numpy(),
        dest=a.dest.cpu().numpy(),
        active=a.active.cpu().numpy(),
        key=KEY_PLACEHOLDER,
        step=np.int32(state.step),
        step_count=step_count,
        **extra,
    )


def load_state(path: str | Path) -> tuple[SimState, int]:
    """(flat state on the CPU, step_count) from a checkpoint of either
    package."""
    state, step_count, _generator = _read(path)
    return state, step_count


def _read(path: str | Path) -> tuple[SimState, int, tuple[str, torch.Tensor] | None]:
    """``load_state``'s result and the port's generator field, as
    (device type, state), or None where the file has none."""
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        agents = AgentState(
            pos=torch.from_numpy(np.array(z["pos"], np.float32)),
            vel=torch.from_numpy(np.array(z["vel"], np.float32)),
            speed=torch.from_numpy(np.array(z["speed"], np.float32)),
            dest=torch.from_numpy(np.array(z["dest"], np.int32)),
            active=torch.from_numpy(np.array(z["active"], bool)),
        )
        generator = None
        if "torch_generator" in z.files:
            generator = (str(z["torch_generator_device"]),
                         torch.from_numpy(np.array(z["torch_generator"])))
        state = SimState(agents=agents, step=int(z["step"]))
        return state, int(z["step_count"]), generator


def save(sim, path: str | Path) -> None:
    """Checkpoint a Simulator: its flat agents, step counters and
    generator state."""
    save_state(sim.flat_state(), path, step_count=sim.step_count,
               generator=sim.generator)


def restore(sim, path: str | Path) -> None:
    """Restore a Simulator in place (``Simulator.load_flat_state``: a
    checkpoint larger than the simulator's capacity raises it to the
    checkpoint's capacity, rebuilding the flat backends' step; a smaller one
    is padded with inactive slots, the reference's checkpoint.py:64-87).
    One process only."""
    state, step_count, generator = _read(path)
    sim.load_flat_state(state)
    sim.step_count = step_count
    if generator is not None and generator[0] == sim.generator.device.type:
        sim.generator.set_state(generator[1])
    else:
        sim.generator.manual_seed(sim.options.seed)
        log.info("%s carries no %s generator state: generator reseeded from "
                 "seed %d", path, sim.generator.device.type, sim.options.seed)
