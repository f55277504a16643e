"""The grid step (``models/sfm_grid.make_step_grid``: spawn scatter, the
fused step kernel, the hybrid of the incremental and full rebins) as the
benchmark drives it: built as ``pedoni_tpu_torch.bench`` builds it for the
bulk driver, as ``Simulator(backend="grid")`` for the tick driver.  It
despawns an agent outside the field's rectangle, as the reference
simulator does."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from pedoni_tpu_torch.field import Field, FieldMaps
from pedoni_tpu_torch.models import sfm_grid
from pedoni_tpu_torch.models.sfm import StepConfig
from pedoni_tpu_torch.sim import Simulator

from . import common

BACKEND = "grid"
DESPAWN_OUTSIDE = "field"
ROW_BLOCK = 2  # as bench.py builds the grid step


class Bulk:
    """The hybrid grid step on the binned problem (bench.py's ``build``)."""

    def __init__(self, problem: dict, device: torch.device):
        sc = common.scenario(problem)
        maps = FieldMaps.from_field(Field.from_scenario(
            sc, unit=problem["geometry"]["unit"]))
        cfg = StepConfig.build(sc, capacity=problem["capacity"],
                               neighbor_grid_unit=problem["cell_unit"],
                               table_capacity=problem["table_capacity"])
        sfm_grid.check_fits(sfm_grid.device_bytes(cfg, ROW_BLOCK), device)
        self.fwp, self.fobs = sfm_grid.field_tensors(cfg, maps, device,
                                                     row_block=ROW_BLOCK)
        self.initial = common.flat_state(problem, device)
        self.state = sfm_grid.bin_state(cfg, self.initial, row_block=ROW_BLOCK)
        self._step = sfm_grid.make_step_grid(cfg, row_block=ROW_BLOCK)
        self.k_cells = cfg.table_capacity
        self.k_cap = None  # a cell holds at most K: no rank cap

    def step(self, state):
        return self._step(state, self.fwp, self.fobs)

    @staticmethod
    def clone(state):
        return state._replace(d=state.d.clone())


def rows(state) -> dict:
    """The live agents of a grid state, with their cells, on the host."""
    return common.grid_rows(state.d)


def sim_judging(sim: Simulator) -> SimpleNamespace:
    """How the Simulator's step holds agents in cells, for the check."""
    return SimpleNamespace(k_cap=None, k_cells=sim.options.table_capacity)
