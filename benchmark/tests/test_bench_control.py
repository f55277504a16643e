"""The controls: the plain reference in bfloat16 in the program's place,
with its state in bfloat16 or in float32, fails the comparison that the
program passes, and the reference in float32 passes it at this size
(``benchmark/control.py``, at a size a test can hold; on the card at the
cells' own size)."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_the_controls_fail_where_the_program_passes(tiny_root, cell):
    root, man = tiny_root
    r = control.readings(cell, 2**32 + 7, root, man, torch.device("cpu"))
    assert r["program"]["passes"], r["program"]
    assert r["f32"]["passes"], r["f32"]
    for name in control.CONTROLS:
        assert not r[name]["passes"], (name, r[name])
