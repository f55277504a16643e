"""The port's trajectory writer (pedoni_tpu_torch/native: trajlog.cpp,
TrajectoryWriter, read_trajectory): tests/test_trajlog.py run against it,
``traj.bin`` byte-equal to the reference writer's on the same frames, and
the reference's fallback (one .npz a frame) without the native library."""

import numpy as np
import pytest

import test_trajlog as ref
from pedoni_tpu import native as ref_native
from pedoni_tpu_torch import native


@pytest.mark.parametrize("name", ["test_trajectory_roundtrip",
                                  "test_trajectory_magic_check"])
def test_reference_trajlog_test_on_the_port(name, tmp_path, monkeypatch):
    monkeypatch.setattr(ref, "native", native)
    getattr(ref, name)(tmp_path)


def _frames(seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for step in (10, 20, 30, 40):
        n = int(rng.integers(0, 3000))
        out.append((step, rng.uniform(-5, 200, (n, 2)).astype(np.float32),
                    rng.integers(0, 9, n).astype(np.int32)))
    return out


def test_trajectory_bytes_equal_to_reference(tmp_path):
    assert native.available() and ref_native.available()
    paths = {}
    for name, mod in (("port", native), ("reference", ref_native)):
        paths[name] = tmp_path / f"{name}.bin"
        with mod.TrajectoryWriter(paths[name]) as w:
            assert w.native
            for step, pos, dest in _frames():
                w.append(step, pos, dest)
    assert paths["port"].read_bytes() == paths["reference"].read_bytes()
    assert paths["port"].read_bytes()[:8] == native.TRAJ_MAGIC == ref_native.TRAJ_MAGIC


def test_trajectory_falls_back_to_npz(tmp_path, monkeypatch):
    """Without the native library a frame is one compressed .npz beside the
    path, as the reference writes it."""
    monkeypatch.setattr(native, "_load", lambda: None)
    (step, pos, dest), = _frames()[:1]
    with native.TrajectoryWriter(tmp_path / "traj.bin") as w:
        assert not w.native and w.pending() == 0
        w.append(step, pos, dest)
    with np.load(tmp_path / f"traj_{step:08d}.npz") as z:
        np.testing.assert_array_equal(z["pos"], pos)
        np.testing.assert_array_equal(z["dest"], dest)
