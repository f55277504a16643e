"""Host-side geometry helpers (NumPy).

Behavioural counterparts of the reference's ``pedoni-simulator/src/util.rs``:

- ``widen_segment``        <- ``line_with_width`` (util.rs:106-111): a segment
  plus width becomes the 4 corners of a rectangle.
- ``distance_from_segment``<- ``distance_from_line`` (util.rs:92-103): vector
  from the closest point on a segment to a query point.
"""

from __future__ import annotations

import numpy as np


def widen_segment(p0, p1, width: float) -> np.ndarray:
    """Return the 4 corners [4, 2] of the rectangle formed by sweeping the
    segment p0->p1 with the given total width (util.rs:106-111)."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    d = p1 - p0
    norm = np.linalg.norm(d)
    if norm == 0.0:
        a = np.zeros(2)
    else:
        a = d / norm
    b = np.array([a[1], -a[0]]) * 0.5 * width
    return np.stack([p0 - b, p0 + b, p1 + b, p1 - b])


def distance_from_segment(points, p0, p1) -> np.ndarray:
    """Vector from the closest point on segment [p0, p1] to each query point.

    ``points`` is [..., 2]; returns the same shape.  Matches util.rs:92-103,
    including the degenerate zero-length-segment branch (which the reference
    computes as ``a - line[0]``).
    """
    points = np.asarray(points, dtype=np.float64)
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    a = points - p0
    b = p1 - p0
    b_len2 = float(b @ b)
    if b_len2 == 0.0:
        return a - p0
    t = np.clip((a @ b) / b_len2, 0.0, 1.0)
    return a - t[..., None] * b
