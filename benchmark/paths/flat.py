"""The flat step (``models/sfm.py::make_step``: flat_sample, the cell
sort, flat_scatter, flat_pairwise, flat_integrate), the port's default
backend, as the benchmark drives it: built as ``pedoni_tpu_torch.bench
--backend xla`` builds it for the bulk driver, as ``Simulator(backend=
"xla")`` (the CLI's ``-b auto`` on a card) for the tick driver.  It
despawns an agent outside the neighbour grid's whole cells, which reach
past the field's edge."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from pedoni_tpu_torch.field import Field, FieldMaps
from pedoni_tpu_torch.models.sfm import StepConfig, device_inputs, make_step
from pedoni_tpu_torch.sim import Simulator

from . import common

BACKEND = "xla"
DESPAWN_OUTSIDE = "cells"


class Bulk:
    """The flat step on the flat agents of the problem."""

    def __init__(self, problem: dict, device: torch.device):
        sc = common.scenario(problem)
        maps = FieldMaps.from_field(Field.from_scenario(
            sc, unit=problem["geometry"]["unit"]))
        cfg = StepConfig.build(sc, capacity=problem["capacity"],
                               neighbor_grid_unit=problem["cell_unit"],
                               table_capacity=problem["table_capacity"])
        field, self.obstacles = device_inputs(cfg, maps, device)
        self.rows_in = field.rows
        self.initial = self.state = common.flat_state(problem, device)
        self._step = make_step(cfg)
        self.k_cap = cfg.table_capacity
        self.k_cells = None

    def step(self, state):
        return self._step(state, self.rows_in, self.obstacles)

    @staticmethod
    def clone(state):
        return state._replace(agents=type(state.agents)(
            *(t.clone() for t in state.agents)))


def rows(state) -> dict:
    """The live agents of a flat state, in row order, on the host."""
    return common.flat_rows(state.agents)


def sim_judging(sim: Simulator) -> SimpleNamespace:
    """How the Simulator's step holds agents in cells, for the check."""
    return SimpleNamespace(k_cap=sim.cfg.table_capacity, k_cells=None)
