"""The comparison that decides ``correct``: a step of the program, its
input and output agents as the program holds them, against the plain
reference's step from the same input.

The program's rows come in any order (the flat step sorts its agents by
cell every step), so each agent the reference keeps is matched to the
program's row with the same desired speed (f32 bits) and destination, the
nearest in position.  The numbers, each with its limit in the cell's file
(``benchmark/cells/<cell>.json``):

- ``vel_gap``: the widest gap between a matched agent's new velocity and
  the reference's, beyond the agent's knife-edge margin (``allow``), in
  units of the agent's f32 rounding scale (``scale``: float32's unit
  roundoff times the sizes its velocity sums), so that a crowd squeezed
  into a jam, whose terms are large and cancel, is held to its own
  rounding and not to an open field's;
- ``pos_gap_ulp``: the same for positions, beyond the velocity margin's
  share, in f32 spacings of the position (the program keeps f32);
- ``lost``: agents the reference keeps that the program lacks, less, where
  the program keeps agents in cells, those that a full cell of its output
  explains (its reported overflow) and those whose new position lies off
  the grid (its rebin drops them a step before the reference's despawn
  would; its reported ``n_exited``);
- ``extra``: program rows that no kept agent matches and that are no
  agent spawned this step;
- ``cells_off``: agents filed in a cell other than floor(pos / unit), where
  the program keeps agents in cells;
- ``count_gap``: the program's reported live count (less, where it keeps
  agents in cells, what its rebin dropped: overflow and agents off the
  grid) against its rows, plus its reported overflow and exits against
  the agents that explain lost ones, plus its reported spawns (less those
  it dropped) against the spawned rows found.

A program row that no agent matches is taken as spawned this step when its
origin, pos - 0.05 vel (it started at rest), lies on the origin line of a
flow bound for its destination and its desired speed is at least 0.1; the
reference is then run again with those agents at their origins.
"""

from __future__ import annotations

import numpy as np
import torch

from . import step as ref_step

MATCH_TOL = 0.01  # m, beyond the velocity margin's share
SPAWN_TOL = 1e-3  # m, an origin off its line
SPEED_MIN = 0.1


def _key(speed: np.ndarray, dest: np.ndarray) -> torch.Tensor:
    bits = np.asarray(speed, np.float32).view(np.int32).astype(np.int64)
    return torch.as_tensor(bits * (1 << 20) + np.asarray(dest, np.int64))


def match(ref_pos, ref_key, tol, out_pos, out_key) -> np.ndarray:
    """For each reference agent the index of its program row, or -1: same
    key, nearest position within ``tol`` [N], each row used once."""
    n, m = len(ref_key), len(out_key)
    if n == 0 or m == 0:
        return np.full(n, -1, np.int64)
    rp = torch.as_tensor(np.asarray(ref_pos, np.float64))
    op = torch.as_tensor(np.asarray(out_pos, np.float64))
    order = torch.argsort(out_key, stable=True)
    ks = out_key[order]
    lo = torch.searchsorted(ks, ref_key)
    hi = torch.searchsorted(ks, ref_key, right=True)
    best = torch.full((n,), -1, dtype=torch.long)
    bestd = torch.full((n,), float("inf"), dtype=torch.float64)
    for o in range(int((hi - lo).max())):
        c = lo + o
        cand = order[torch.clamp(c, max=m - 1)]
        d = (op[cand] - rp).abs().amax(1)
        better = (c < hi) & (d < bestd)
        best = torch.where(better, cand, best)
        bestd = torch.where(better, d, bestd)
    best = torch.where(bestd <= torch.as_tensor(tol), best, -1)
    taken = best >= 0
    if taken.any():  # a row claimed twice goes to the nearer claim
        idx = torch.nonzero(taken).flatten()
        srt = idx[torch.argsort(bestd[idx], stable=True)]
        srt = srt[torch.argsort(best[srt], stable=True)]
        rows = best[srt]
        dup = torch.zeros_like(rows, dtype=torch.bool)
        dup[1:] = rows[1:] == rows[:-1]
        best[srt[dup]] = -1
    return best.numpy()


def _on_segment(p: np.ndarray, a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ab = b - a
    t = np.clip(((p - a) @ ab) / max(float(ab @ ab), 1e-300), 0.0, 1.0)
    return np.abs(p - (a + t[:, None] * ab)).max(1)


def spawned(rows: dict, geometry: dict, groups: list) -> np.ndarray:
    """Mask of ``rows`` that are agents spawned this step."""
    pos = np.asarray(rows["pos"], np.float64)
    vel = np.asarray(rows["vel"], np.float64)
    origin = pos - 0.05 * vel
    ok = np.zeros(len(pos), bool)
    for g in groups:
        p0, p1, _w = geometry["waypoints"][g["origin"]]
        ok |= ((np.asarray(rows["dest"]) == g["destination"])
               & (_on_segment(origin, p0, p1) <= SPAWN_TOL))
    return ok & (np.asarray(rows["speed"], np.float32) >= np.float32(SPEED_MIN))


def _cat(a: dict, b: dict) -> dict:
    return {k: np.concatenate([np.asarray(a[k]), np.asarray(b[k])])
            for k in ("pos", "vel", "speed", "dest")}


def judge(field: dict, inp: dict, out: dict, metrics: dict, problem: dict,
          k_cap: int | None, k_cells: int | None, reference=None) -> dict:
    """The numbers of one step.  ``inp`` / ``out``: the program's live
    agents before and after (pos, vel, speed, dest; ``cx``, ``cy`` where
    the program keeps agents in cells, with ``k_cells`` slots a cell);
    ``metrics``: its step metrics (``n_active``, ``n_overflow``; None for
    a copy, as the binning);
    ``problem``: geometry, groups, cell unit; ``k_cap``: the flat step's
    cell capacity.  ``reference(agents) -> step result`` computes the
    expected step (by default the f64 reference on the CPU)."""
    geo = problem["geometry"]
    if reference is None:
        def reference(agents):
            return ref_step.step(field, agents, geo["size"], geo["unit"],
                                 problem["cell_unit"], k_cap,
                                 outside=problem["outside"])
    out_key = _key(out["speed"], out["dest"])
    agents = {k: np.asarray(inp[k]) for k in ("pos", "vel", "speed", "dest")}
    n_old = len(agents["speed"])
    res = reference(agents)
    keep = res["alive"] | res["unsure"]
    tol = MATCH_TOL + 0.05 * res["allow"]
    got = np.full(n_old, -1, np.int64)
    got[keep] = match(res["pos"][keep], _key(agents["speed"][keep], agents["dest"][keep]),
                      tol[keep], out["pos"], out_key)
    free = np.ones(len(out_key), bool)
    free[got[got >= 0]] = False
    # a free row that carries the key of an input agent left unmatched is
    # that agent (pushed off by a spawn the first pass did not know), not a
    # spawn, however near an origin line it stands
    left = np.isin(out_key.numpy(), _key(agents["speed"][got < 0],
                                         agents["dest"][got < 0]).numpy())
    new = free & ~left & spawned(out, geo, problem["groups"])
    n_new = int(new.sum())
    if n_new:
        sp = {"pos": np.asarray(out["pos"], np.float64)[new]
              - 0.05 * np.asarray(out["vel"], np.float64)[new],
              "vel": np.zeros((n_new, 2)), "speed": np.asarray(out["speed"])[new],
              "dest": np.asarray(out["dest"])[new]}
        sp["pos"] = sp["pos"].astype(np.float32)
        agents = _cat(agents, sp)
        res = reference(agents)
        keep = res["alive"] | res["unsure"]
        tol = MATCH_TOL + 0.05 * res["allow"]
        got = np.full(len(agents["speed"]), -1, np.int64)
        got[keep] = match(res["pos"][keep],
                          _key(agents["speed"][keep], agents["dest"][keep]),
                          tol[keep], out["pos"], out_key)
        free = np.ones(len(out_key), bool)
        free[got[got >= 0]] = False
    hit = got >= 0
    opos = np.asarray(out["pos"], np.float64)
    ovel = np.asarray(out["vel"], np.float64)
    dv = np.abs(ovel[got[hit]] - res["vel"][hit]).max(1) if hit.any() else np.zeros(0)
    dp = np.abs(opos[got[hit]] - res["pos"][hit]).max(1) if hit.any() else np.zeros(0)
    spacing = np.spacing(np.abs(opos[got[hit]]).astype(np.float32)).max(1) \
        if hit.any() else np.zeros(0)
    allow = res["allow"][hit]
    ratio = np.maximum(dv - allow, 0.0) / res["scale"][hit]
    vel_gap = float(np.max(ratio, initial=0.0))
    worst = {}
    if hit.any():
        w = int(np.argmax(ratio))
        worst = {"pos": np.asarray(res["pos"][hit][w]).tolist(), "dv": float(dv[w]),
                 "allow": float(allow[w]), "scale": float(res["scale"][hit][w])}
    pos_gap = float(np.max((dp - 0.05 * allow) / spacing, initial=0.0))

    missing = res["alive"] & ~res["unsure"] & ~hit
    explained = exited = 0
    cells_off = 0
    n_overflow = int((metrics or {}).get("n_overflow", 0))
    if "cx" in out:
        ocx, ocy = np.asarray(out["cx"]), np.asarray(out["cy"])
        ecx, ecy = ref_step.cells_f32(out["pos"], problem["cell_unit"])
        cells_off = int(((ocx != ecx) | (ocy != ecy)).sum())
        if missing.any():
            ids, cnt = np.unique(ocy.astype(np.int64) * (1 << 32) + ocx,
                                 return_counts=True)
            full = dict(zip(ids.tolist(), cnt.tolist()))
            mcx, mcy = ref_step.cells_f32(res["pos"][missing].astype(np.float32),
                                          problem["cell_unit"])
            nx = int(np.ceil(geo["size"][0] / problem["cell_unit"]))
            ny = int(np.ceil(geo["size"][1] / problem["cell_unit"]))
            off = (mcx < 0) | (mcx >= nx) | (mcy < 0) | (mcy >= ny)
            exited = int(off.sum())
            mid = (mcy * (1 << 32) + mcx)[~off].tolist()
            explained = sum(1 for c in mid if full.get(c, 0) >= k_cells)
    lost = int(missing.sum()) - explained - exited
    extra = int((free & ~new).sum()) if n_new else int(free.sum())
    if metrics is None:
        count_gap = 0
    elif "cx" in out:  # the rebin drops overflow and agents off the grid
        n_exited = int(metrics.get("n_exited", 0))
        count_gap = (abs(int(metrics["n_active"]) - n_overflow - n_exited
                         - len(out_key))
                     + abs(explained - n_overflow) + abs(exited - n_exited))
    else:
        count_gap = abs(int(metrics["n_active"]) - len(out_key))
    if metrics is not None and problem["groups"]:
        count_gap += abs(n_new - (int(metrics.get("n_spawned", 0))
                                  - int(metrics.get("n_dropped", 0))))
    return {"numbers": {"vel_gap": vel_gap, "pos_gap_ulp": pos_gap, "lost": lost,
                        "extra": extra, "cells_off": cells_off,
                        "count_gap": count_gap},
            "info": {"agents": int(hit.sum()), "spawned": n_new,
                     "vel_err": float(dv.max(initial=0.0)),
                     "pos_err": float(dp.max(initial=0.0)),
                     "allowed": int((allow > 0).sum()),
                     "allow_max": float(allow.max(initial=0.0)),
                     "unsure": int(res["unsure"].sum()),
                     "overflow": explained, "exited": exited, "worst": worst}}
