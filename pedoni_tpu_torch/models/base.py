"""Model abstraction: the reference's ``PedestrianModel`` trait
(pedoni-simulator/src/models/mod.rs:13-25) over the flat step, in torch
(counterpart of pedoni_tpu/models/base.py).

The flat step (models/sfm.py) is what runs on the device; this layer gives
users of the reference the same five-method object surface:

    model = SocialForceModel(options, scenario, field, device="cuda")
    model.spawn_pedestrians(field, new_pedestrians)
    model.update_states(scenario, field)
    model.list_pedestrians()
    model.get_pedestrian_count()

``Pedestrian`` mirrors the exchange struct (models/mod.rs:29-32).
"""

from __future__ import annotations

import abc
import dataclasses
import logging
from typing import Sequence

import numpy as np
import torch

from ..field import Field, FieldMaps
from ..physics import Physics
from ..scenario import Scenario
from .sfm import (AgentState, SimState, StepConfig, StepMetrics, device_inputs,
                  make_initial_state, make_step)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Pedestrian:
    """Exchange struct (models/mod.rs:29-32)."""

    pos: tuple[float, float]
    destination: int = 0


class PedestrianModel(abc.ABC):
    """The reference trait (models/mod.rs:13-25)."""

    @abc.abstractmethod
    def spawn_pedestrians(self, field: Field,
                          new_pedestrians: Sequence[Pedestrian]) -> None: ...

    @abc.abstractmethod
    def update_states(self, scenario: Scenario, field: Field) -> None: ...

    @abc.abstractmethod
    def list_pedestrians(self) -> list[Pedestrian]: ...

    @abc.abstractmethod
    def get_pedestrian_count(self) -> int: ...


class SocialForceModel(PedestrianModel):
    """Object-style wrapper over the flat step, spawning driven by the host.

    The trait's constructor spawns nothing: the reference's Simulator
    pushes once-group pedestrians through ``spawn_pedestrians`` (lib.rs:
    37-52), so every spawn group is stripped from the step here, and
    ``update_states`` runs it with external spawning only.  ``options`` is
    any object with the Simulator's option names (``physics``,
    ``neighbor_grid_unit``, ...); missing ones take the reference's
    defaults."""

    def __init__(self, options, scenario: Scenario, field: Field,
                 capacity: int = 4096, seed: int = 0,
                 device: torch.device | str = "cuda") -> None:
        physics = getattr(options, "physics", None) or Physics()
        bare = Scenario(size=scenario.size, waypoints=scenario.waypoints,
                        obstacles=scenario.obstacles, pedestrians=())
        self.cfg = StepConfig.build(
            bare,
            physics=physics,
            capacity=capacity,
            neighbor_grid_unit=getattr(options, "neighbor_grid_unit", 1.4),
            field_unit=getattr(options, "field_grid_unit", 0.25),
            use_neighbor_grid=getattr(options, "use_neighbor_grid", True),
            use_distance_map=getattr(options, "use_distance_map", True),
        )
        self.device = torch.device(device)
        self.maps = FieldMaps.from_field(field)
        dfield, self._obstacles = device_inputs(self.cfg, self.maps, self.device)
        self._field_rows = dfield.rows
        self._step = make_step(self.cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state: SimState = make_initial_state(self.cfg, self.generator,
                                                  self.device)
        self.metrics: StepMetrics | None = None  # of the last update_states

    def spawn_pedestrians(self, field: Field,
                          new_pedestrians: Sequence[Pedestrian]) -> None:
        """Place new pedestrians in free slots, at rest, each with a desired
        speed drawn from N(speed_mean, speed_std) (clamped at 0.1) by
        ``np.random.default_rng(step + 1)``, the reference's draw."""
        if not new_pedestrians:
            return
        a = {name: t.cpu().numpy().copy()
             for name, t in self.state.agents._asdict().items()}
        free = np.nonzero(~a["active"])[0]
        n = min(len(new_pedestrians), len(free))
        if n < len(new_pedestrians):
            log.warning("spawn overflow: dropping %d agents",
                        len(new_pedestrians) - n)
        rng = np.random.default_rng(self.state.step + 1)
        phys = self.cfg.physics
        for slot, p in zip(free[:n], new_pedestrians):
            a["pos"][slot] = p.pos
            a["dest"][slot] = p.destination
            a["vel"][slot] = 0.0
            a["speed"][slot] = max(rng.normal(phys.speed_mean, phys.speed_std), 0.1)
            a["active"][slot] = True
        self.state = self.state._replace(agents=AgentState(
            **{name: torch.from_numpy(v).to(self.device) for name, v in a.items()}))

    def update_states(self, scenario: Scenario, field: Field) -> None:
        self.state, self.metrics = self._step(self.state, self._field_rows,
                                              self._obstacles)

    def list_pedestrians(self) -> list[Pedestrian]:
        a = self.state.agents
        pos = a.pos[a.active].cpu().numpy()
        dest = a.dest[a.active].cpu().numpy()
        return [Pedestrian(pos=(float(p[0]), float(p[1])), destination=int(d))
                for p, d in zip(pos, dest)]

    def get_pedestrian_count(self) -> int:
        return int(self.state.agents.active.sum())
