"""A scenario file that the repository ships (``scenarios/*.toml``), read
as it stands: its TOML text, its geometry, its spawn groups and the
simulator's settings, as ``random_field.generate`` gives them.

The configuration names the file (``scenario_file``, relative to the
checkout's root) and its SHA-256 (``sha256``); a file whose hash differs is
refused, so the cell runs the deployment it names or none.  Only periodic
spawn groups are taken: the check (``reference/compare.py``) finds a
spawned agent on its origin line, at rest.  The seed of a run does not
enter here: it drives the simulator's spawn stream.
"""

from __future__ import annotations

import hashlib
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout


def read(config: dict) -> str:
    """The configuration's scenario file as text, refused (ValueError) where
    its SHA-256 is not the configuration's."""
    data = (ROOT / config["scenario_file"]).read_bytes()
    got = hashlib.sha256(data).hexdigest()
    if got != config["sha256"]:
        raise ValueError(f"{config['scenario_file']}: SHA-256 {got}, the "
                         f"configuration names {config['sha256']}")
    return data.decode()


def generate(config: dict, traffic: dict, seed: int) -> dict:
    """The problem of ``config`` at the cell unit of ``traffic``."""
    text = read(config)
    data = tomllib.loads(text)

    def seg(t):
        return [list(map(float, t["line"][0])), list(map(float, t["line"][1])),
                float(t.get("width", 1.0))]

    groups = []
    for p in data.get("pedestrians", []):
        if p["spawn"]["kind"] != "periodic":
            raise ValueError(f"{config['scenario_file']}: a {p['spawn']['kind']!r} "
                             "spawn group; the check takes periodic ones only")
        groups.append({"origin": int(p["origin"]),
                       "destination": int(p["destination"]),
                       "frequency": float(p["spawn"]["frequency"])})
    return {
        "toml": text,
        "geometry": {"size": [float(v) for v in data["field"]["size"]],
                     "unit": float(config["field_unit"]),
                     "waypoints": [seg(t) for t in data["waypoints"]],
                     "obstacles": [seg(t) for t in data.get("obstacles", [])]},
        "groups": groups,
        "cell_unit": float(traffic["cell_unit"]),
        "table_capacity": int(config["table_capacity"]),
    }
