"""``benchmark/work``'s counts on hand-built cases."""

from __future__ import annotations

import numpy as np

from benchmark.work import step_work as sw

GEO = {"size": [30.0, 30.0], "unit": 0.25, "waypoints": [[[1, 1], [1, 29], 1.0]],
       "obstacles": []}


def test_pairs_in_the_window_and_the_cutoff():
    # cells of 1.5 m: a (0.5, 0.5) and b (2.0, 0.5) are neighbour cells,
    # 1.5 m apart (within 2 m); c (3.9, 0.5) is two cells from a (out of
    # its window) and 1.9 m from b (within); d (20, 20) is alone
    pos = np.array([[0.5, 0.5], [2.0, 0.5], [3.9, 0.5], [20.0, 20.0]], np.float32)
    tests, within = sw.pairs(pos, GEO["size"], 1.5)
    assert tests == 4  # a-b, b-a, b-c, c-b
    assert within == 4
    pos = np.array([[0.5, 0.5], [2.9, 0.5]], np.float32)  # neighbours, 2.4 m apart
    assert sw.pairs(pos, GEO["size"], 1.5) == (2, 0)


def test_texels_are_the_4x4_blocks_counted_once():
    # one agent at texel centre (10.5, 10.5): the sample point (10, 10),
    # the block x, y in 9..12 in the potential and in the distance map
    pos = np.array([[10.5 * 0.25 + 0.125, 10.5 * 0.25 + 0.125]], np.float32)
    assert sw.texels(pos, np.zeros(1), GEO) == (16, 16)
    # a second agent one texel right shares 12 of its 16 texels
    pos2 = np.concatenate([pos, pos + np.float32([0.25, 0.0])])
    assert sw.texels(pos2, np.zeros(2), GEO) == (20, 20)


def test_count_and_bound():
    pos = np.array([[0.5, 0.5], [2.0, 0.5]], np.float32)
    w = sw.count({"pos": pos, "dest": np.zeros(2, np.int32)}, GEO, 1.5)
    assert w["ops"] == 2 * sw.TEST_OPS + 2 * sw.PAIR_OPS + 2 * sw.AGENT_OPS
    assert w["bytes"] == 2 * 40 + 4 * w["texels"]
    t, what = sw.bound_seconds(w)
    assert t == max(w["bytes"] / 3.35e12, w["ops"] / 67e12)
    assert what == ("bytes" if w["bytes"] / 3.35e12 >= w["ops"] / 67e12
                    else "operations")
