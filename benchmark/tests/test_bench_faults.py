"""Runs with the timed path broken underneath come out not correct: a step
that returns its state unchanged, half of the agents left unstepped, one
agent's answer (its velocity, by 0.01 m/s) altered where it is produced.
The cells run on one chip, so no exchange between chips can be left out."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import tiny


def _flat_fault(kind: str):
    from pedoni_tpu_torch.models import sfm
    real = sfm.flat_integrate

    def broken(sp, active, phys, **kw):
        pos, vel = real(sp, active, phys, **kw)
        if kind == "unchanged":
            return sp[:, 0:2].clone(), sp[:, 2:4].clone()
        if kind == "half":  # the second half of the live agents unstepped
            live = torch.nonzero(active).flatten()
            rest = live[live.numel() // 2:]
            pos, vel = pos.clone(), vel.clone()
            pos[rest], vel[rest] = sp[rest, 0:2], sp[rest, 2:4]
            return pos, vel
        live = torch.nonzero(active).flatten()[:1]
        vel = vel.clone()
        vel[live, 0] += 0.01
        return pos, vel
    return sfm, "flat_integrate", broken


def _grid_fault(kind: str):
    from pedoni_tpu_torch.models import sfm_grid
    real = sfm_grid.fused_step

    def broken(d, *a, **k):
        out = real(d, *a, **k)
        g = out[0] if isinstance(out, tuple) else out
        if kind == "unchanged":
            g[:, :, 0:4] = d[:, :, 0:4]
        elif kind == "half":  # the second half of the live slots unstepped
            live = torch.nonzero(d[:, :, 6] > 0.5)
            r, s, x = live[live.shape[0] // 2:].unbind(1)
            for c in range(4):
                g[r, s, c, x] = d[r, s, c, x]
        else:
            at = torch.nonzero(g[:, :, 6] > 0.5)[0]
            g[at[0], at[1], 2, at[2]] += 0.01
        return out
    return sfm_grid, "fused_step", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["b.flat", "b.grid", "t.flat", "t.grid"])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, cell, kind):
    root, man = tiny_root
    mod, name, broken = (_grid_fault if cell.endswith("grid") else _flat_fault)(kind)
    monkeypatch.setattr(mod, name, broken)
    code, res = tiny.run(root, man, cell, seconds=0.3)
    assert code == 0 and res["correct"] is False, res["checks"]
