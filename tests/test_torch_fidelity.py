"""The port's evacuation fidelity (pedoni_tpu_torch/fidelity.py) against
the reference's harness and the f64 oracle, on the CPU:

- the copies: ``fidelity.GEOMETRIES`` (sources, seeds, table capacities),
  CAP, UNIT and EVAC_MAX equal tests/test_oracle.py's, and so do the
  initial arrays of every geometry at every seed;
- oracle parity (tests/test_oracle.py:387-430's rule): from the identical
  initial state, a backend evacuates within max(3, round(0.05 o)) steps of
  the oracle's o (tests/oracle_sfm.py, fed the port's Field copy), and the
  grid loses no agent.  Tier-1 runs the first seed of each geometry on
  ``grid``, the main path (the step kernel's and both rebins' twins);
  every seed on ``xla``, ``grid`` and ``pallas`` is ``-m slow``.  The
  reference's narrow_gap reads its own scenario file, which this
  repository does not hold: the package carries no copy of it and its
  case skips with that reason;
- statistical parity on gap.toml (``-m slow``): the port's ``Simulator``
  on each backend and the reference's (its default ``xla`` step, on CPU
  JAX: its interpret-mode kernels are too slow for 8 evacuations) at seeds
  1-8.  The random streams differ, so counts are compared as
  distributions: every count lies in the reference's frozen band [160,
  340] (tests/test_regression_bands.py), and each backend's mean lies
  within three standard errors of the reference's, |mean_port - mean_ref|
  <= 3 sqrt(sd_port^2 / 8 + sd_ref^2 / 8), with sample standard deviations.
"""

import pathlib

import numpy as np
import pytest
import torch

import test_oracle as T
from oracle_sfm import oracle_step
from pedoni_tpu_torch import fidelity as F
from test_regression_bands import GAP_BAND, _evac_steps as reference_evac_steps

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP_SEEDS = tuple(range(1, 9))


def _in_this_repository(source) -> bool:
    kind, src = source
    return kind == "inline" or ROOT in pathlib.Path(src).resolve().parents


def test_the_package_carries_each_geometry_this_repository_holds():
    """Every reference geometry whose scenario is inline or a file of this
    repository, and only those: narrow_gap reads the reference's own
    narrow-gap.toml."""
    assert (F.CAP, F.UNIT, F.EVAC_MAX) == (T.CAP, T.UNIT, T._EVAC_MAX)
    here = {g for g, (source, *_) in T._EVAC_GEOMS.items()
            if _in_this_repository(source)}
    assert set(F.GEOMETRIES) == here == set(T._EVAC_GEOMS) - {"narrow_gap"}


@pytest.mark.parametrize("geometry", sorted(F.GEOMETRIES))
def test_geometries_copy_the_reference_harness(geometry):
    (kind, src), init, seeds, table = T._EVAC_GEOMS[geometry]
    g = F.GEOMETRIES[geometry]
    assert (g.seeds, g.table_capacity) == (seeds, table)
    got_kind, got_src = g.source
    if got_kind == "file":
        assert kind == "file" and got_src.resolve() == src.resolve()
    else:
        assert (got_kind, got_src) == (kind, src)
    for seed in seeds:
        for got, want in zip(F.initial(geometry, seed), T._evac_initial(init, seed)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_gap_distribution_takes_the_sample_sd_and_refuses_a_stuck_seed(
        monkeypatch):
    counts = {1: 230, 2: 214, 3: 261}
    monkeypatch.setattr(F, "evac_steps", lambda backend, seed, device: counts[seed])
    d = F.gap_distribution("grid", 3, device="cpu")
    assert d.steps == [230, 214, 261] and d.mean == 235
    assert d.sd == pytest.approx(np.std([230, 214, 261], ddof=1))
    counts[2] = -1  # evac_steps' count past EVAC_MAX
    with pytest.raises(RuntimeError, match="seed 2 did not evacuate"):
        F.gap_distribution("grid", 3, device="cpu")


_ORACLE: dict = {}


def _holds_to_the_oracle(geometry: str, seed: int, backend: str) -> None:
    key = (geometry, seed)
    if key not in _ORACLE:  # one oracle run serves the three backends
        _ORACLE[key] = F.evac_steps_oracle(geometry, seed, oracle_step)
    o = _ORACLE[key]
    b, lost = F.evac_steps_from(geometry, seed, backend, device="cpu")
    assert o <= F.EVAC_MAX and b <= F.EVAC_MAX, (
        f"{geometry} seed {seed}: evacuation did not complete: oracle {o}, "
        f"{backend} {b}")
    assert abs(b - o) <= max(3, round(0.05 * o)), (
        f"{backend} {geometry} seed {seed}: evacuated in {b} steps, oracle "
        f"{o}: outside the 5% parity band")
    # a cell-table overflow in a queue would end the evacuation early
    assert lost == 0, f"grid {geometry} seed {seed}: {lost} agents lost"


@pytest.mark.parametrize("geometry", sorted(T._EVAC_GEOMS))
def test_grid_evacuation_matches_oracle(geometry):
    """The first seed of each geometry on the grid backend (gap 252, multiwp
    358, funnel 408 oracle steps at seed 1)."""
    if geometry not in F.GEOMETRIES:
        pytest.skip(f"{geometry} reads the reference's own scenario file, "
                    "which this repository does not hold")
    _holds_to_the_oracle(geometry, F.GEOMETRIES[geometry].seeds[0], "grid")


SLOW_CASES = [(g, s, b) for g in sorted(F.GEOMETRIES)
              for s in F.GEOMETRIES[g].seeds for b in F.BACKENDS
              if (b, s) != ("grid", F.GEOMETRIES[g].seeds[0])]


@pytest.mark.slow
@pytest.mark.parametrize("geometry,seed,backend", SLOW_CASES)
def test_evacuation_matches_oracle(geometry, seed, backend):
    _holds_to_the_oracle(geometry, seed, backend)


@pytest.fixture(scope="module")
def reference_gap_steps():
    return [reference_evac_steps("xla", s) for s in GAP_SEEDS]


@pytest.mark.slow
@pytest.mark.parametrize("backend", F.BACKENDS)
def test_gap_distribution_matches_reference(backend, reference_gap_steps):
    port = F.gap_distribution(backend, len(GAP_SEEDS), device="cpu").steps
    ref = reference_gap_steps
    for name, steps in (("reference", ref), (backend, port)):
        assert all(GAP_BAND[0] <= s <= GAP_BAND[1] for s in steps), (
            f"{name}: {steps} outside {GAP_BAND}")
    n = len(GAP_SEEDS)
    se = np.sqrt(np.var(port, ddof=1) / n + np.var(ref, ddof=1) / n)
    assert abs(np.mean(port) - np.mean(ref)) <= 3 * se, (
        f"{backend} {port} (mean {np.mean(port):.1f}) against the reference's "
        f"{ref} (mean {np.mean(ref):.1f}): more than 3 standard errors "
        f"({se:.2f}) apart")
