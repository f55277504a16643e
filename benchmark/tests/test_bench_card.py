"""On the card: the test-sized cells through the hand kernels, correct,
and a traced run's per-layer metrics.  Run on an NVIDIA GPU with
``python -m pytest benchmark/tests -m cuda``."""

from __future__ import annotations

import pytest

from benchmark.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_a_small_cell_on_the_card_is_correct(tiny_root, card, cell):
    root, man = tiny_root
    code, res = tiny.run(root, man, cell, device=card)
    assert code == 0 and res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["b.grid", "t.flat"])
def test_a_traced_run_on_the_card(tiny_root, card, cell):
    root, man = tiny_root
    code, res = tiny.run(root, man, cell, trace=1, device=card)
    assert code == 0 and res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
    assert res["metrics"]
