"""What the program adapters share: the problem as the program's scenario
and agents, and the step metrics as plain ints."""

from __future__ import annotations

import torch

from pedoni_tpu_torch.convert import agents_from_numpy
from pedoni_tpu_torch.models.sfm import SimState
from pedoni_tpu_torch.scenario import Scenario, Segment, loads_scenario
from pedoni_tpu_torch.sim import Simulator, SimulatorOptions


def scenario(problem: dict) -> Scenario:
    """The open-field problem's geometry as the program's Scenario."""
    geo = problem["geometry"]

    def seg(s):
        return Segment(line=(tuple(map(float, s[0])), tuple(map(float, s[1]))),
                       width=float(s[2]))

    return Scenario(size=tuple(map(float, geo["size"])),
                    waypoints=tuple(seg(s) for s in geo["waypoints"]),
                    obstacles=tuple(seg(s) for s in geo["obstacles"]),
                    pedestrians=())


def flat_state(problem: dict, device: torch.device) -> SimState:
    a = problem["agents"]
    return SimState(agents=agents_from_numpy(a["pos"], a["vel"], a["speed"],
                                             a["dest"], a["active"], device),
                    step=0)


def simulator(problem: dict, seed: int, device: torch.device,
              backend: str) -> Simulator:
    """The CLI's Simulator (``-b <backend>``) on the problem's scenario."""
    opts = SimulatorOptions(backend=backend, neighbor_grid_unit=problem["cell_unit"],
                            field_grid_unit=problem["geometry"]["unit"],
                            table_capacity=problem["table_capacity"],
                            seed=seed, device=device.type)
    return Simulator(opts, loads_scenario(problem["toml"]))


def metrics(m) -> dict:
    """Step metrics (device tensors or host numbers) as ints by name."""
    return {k: int(v) for k, v in m._asdict().items()}


def flat_rows(agents) -> dict:
    """The live agents of flat agent tensors, in row order, on the host."""
    act = agents.active
    return {"pos": agents.pos[act].cpu().numpy(),
            "vel": agents.vel[act].cpu().numpy(),
            "speed": agents.speed[act].cpu().numpy(),
            "dest": agents.dest[act].cpu().numpy()}


def grid_rows(d: torch.Tensor) -> dict:
    """The live agents of a cell-resident grid D [ny+2, K, 8, NXL] (ch 0-1
    pos, 2-3 vel, 4 speed, 5 dest, 6 active; cell (cy, cx) at row cy + 1,
    lane cx + 1), with their cells, on the host."""
    dd = d.permute(0, 3, 1, 2)  # [ny2, NXL, K, 8]
    live = dd[..., 6] > 0.5
    at = torch.nonzero(live)
    r = dd[live].cpu().numpy()
    at = at.cpu().numpy()
    return {"pos": r[:, 0:2].copy(), "vel": r[:, 2:4].copy(),
            "speed": r[:, 4].copy(), "dest": r[:, 5].astype("int32"),
            "cy": at[:, 0] - 1, "cx": at[:, 1] - 1}


def save(sim, path) -> None:
    """The Simulator's checkpoint (agents, counters, generator state)."""
    from pedoni_tpu_torch import checkpoint
    checkpoint.save(sim, path)


def restore(sim, path) -> None:
    """The Simulator put back to a checkpoint, re-binned at its current
    sizes (``checkpoint.restore``)."""
    from pedoni_tpu_torch import checkpoint
    checkpoint.restore(sim, path)
