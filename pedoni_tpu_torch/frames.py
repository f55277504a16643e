"""PNG frames of the crowd, with or without matplotlib.

``save_frame`` is ``renderer.save_frame`` (the reference's matplotlib
snapshot) where matplotlib is installed.  Where it is not -- machines that
carry PyTorch for the card and little else -- it writes a plain raster of
the same picture with numpy and zlib: obstacles grey, waypoints orange,
each agent a 3 x 3 pixel dot in the renderer's destination colours (the
reference's 6-colour cycle, renderer/mod.rs:9-16), y pointing down as in
``renderer.save_frame``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .field import rasterize_quad
from .scenario import Scenario
from .utils.geometry import widen_segment

# matplotlib's tab:red, tab:orange, gold, tab:green, tab:cyan, tab:purple
_DEST_RGB = np.array([(214, 39, 40), (255, 127, 14), (255, 215, 0),
                      (44, 160, 44), (23, 190, 207), (148, 103, 189)], np.uint8)
_OBSTACLE_RGB = (102, 102, 102)
_WAYPOINT_RGB = (255, 200, 120)


def save_frame(scenario: Scenario, pos: np.ndarray, dest: np.ndarray,
               path: str) -> None:
    """Save a snapshot of the crowd state as a PNG at ``path``."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        save_frame_plain(scenario, pos, dest, path)
        return
    from .renderer import save_frame as save_frame_matplotlib

    save_frame_matplotlib(scenario, pos, dest, path)


def save_frame_plain(scenario: Scenario, pos: np.ndarray, dest: np.ndarray,
                     path: str, width: int = 960) -> None:
    """The snapshot as an RGB raster ``width`` pixels wide, without
    matplotlib."""
    w_m, h_m = scenario.size
    scale = width / w_m
    height = max(1, int(round(h_m * scale)))
    img = np.full((height, width, 3), 255, np.uint8)
    for segs, rgb in ((scenario.obstacles, _OBSTACLE_RGB),
                      (scenario.waypoints, _WAYPOINT_RGB)):
        for seg in segs:
            mask = np.zeros((height, width), bool)
            rasterize_quad(mask, widen_segment(seg.p0, seg.p1, seg.width) * scale)
            img[mask] = rgb
    if len(pos):
        px = np.floor(np.asarray(pos, np.float64) * scale).astype(np.int64)
        rgb = _DEST_RGB[np.asarray(dest, np.int64) % len(_DEST_RGB)]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                x, y = px[:, 0] + dx, px[:, 1] + dy
                ok = (x >= 0) & (x < width) & (y >= 0) & (y < height)
                img[y[ok], x[ok]] = rgb[ok]
    with open(path, "wb") as f:
        f.write(_png(img))


def _png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``img`` [H, W, 3] uint8: each row with filter 0,
    one zlib stream."""
    height, width, _ = img.shape
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           img.reshape(height, width * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
