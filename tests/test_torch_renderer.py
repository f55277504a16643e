"""tests/test_renderer.py run against the port's copy of the terminal
renderer (pedoni_tpu_torch/renderer.py): the reference's tests, with the
names they read (TerminalRenderer, SnapshotStream, KeyPoller,
loads_scenario) pointed at the port's for the test's duration."""

import pytest

import pedoni_tpu.renderer
import test_renderer as ref
from pedoni_tpu_torch import renderer, scenario


@pytest.fixture(autouse=True)
def port_renderer(monkeypatch):
    monkeypatch.setattr(ref, "TerminalRenderer", renderer.TerminalRenderer)
    monkeypatch.setattr(ref, "SnapshotStream", renderer.SnapshotStream)
    monkeypatch.setattr(ref, "loads_scenario", scenario.loads_scenario)
    # test_arrow_key_decode imports KeyPoller from the reference's module
    monkeypatch.setattr(pedoni_tpu.renderer, "KeyPoller", renderer.KeyPoller)


@pytest.mark.parametrize("name", ["test_camera_pan_zoom", "test_density_glyphs",
                                  "test_snapshot_stream_decouples",
                                  "test_arrow_key_decode"])
def test_reference_renderer_test_on_the_port(name):
    getattr(ref, name)()


def test_save_frame_writes_a_png(tmp_path):
    """``save_frame`` (lazy matplotlib) writes a PNG of the crowd."""
    import numpy as np

    sc = scenario.loads_scenario(ref.SCENARIO)
    path = tmp_path / "f.png"
    renderer.save_frame(sc, np.array([[20.0, 30.0], [150.0, 60.0]], np.float32),
                        np.zeros(2, np.int32), str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _read_png(path):
    """(height, width, RGB pixels) of an 8-bit RGB PNG with filter 0 rows."""
    import struct
    import zlib

    import numpy as np

    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    i, chunks = 8, {}
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        tag, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        crc = struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0]
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        chunks[tag] = chunks.get(tag, b"") + body
        i += 12 + n
    w, h, depth, kind = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, kind) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_plain_frame_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib, ``frames.save_frame`` writes a plain raster: the
    obstacle grey, each agent a dot of its destination's colour, y down."""
    import sys

    import numpy as np

    from pedoni_tpu_torch import frames

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    sc = scenario.loads_scenario(ref.SCENARIO)  # 200 x 100 m, wall at x 100
    path = tmp_path / "plain.png"
    frames.save_frame(sc, np.array([[20.0, 30.0], [150.0, 80.0]], np.float32),
                      np.array([0, 3], np.int32), str(path))
    img = _read_png(path)
    scale = img.shape[1] / 200.0
    assert img.shape == (480, 960, 3)
    px = lambda x, y: tuple(img[int(y * scale), int(x * scale)])  # noqa: E731
    assert px(20, 30) == tuple(frames._DEST_RGB[0])
    assert px(150, 80) == tuple(frames._DEST_RGB[3])
    assert px(100, 20) == frames._OBSTACLE_RGB  # the wall: y 0..50
    assert px(100, 80) == (255, 255, 255)
