"""A procedurally generated field (the repository's scenarios/generate.py,
from its parameters): scattered obstacles and four periodic corner-to-
corner flows, as TOML text and as geometry.

The seed of a run does not enter here: the scenario is fixed by the
configuration's own generator seed, and a run's seed drives the
simulator's spawn stream.  ``toml_text`` prints exactly what
``scenarios/generate.py`` prints for the same parameters (benchmark/tests
hold it equal to ``scenarios/random.toml``).
"""

from __future__ import annotations

import math
import random
import tomllib


def toml_text(size: float, obstacles: int, freq: float, seed: int,
              max_obstacle_len: float) -> str:
    rng = random.Random(seed)
    s = float(size)
    m = s * 0.05  # corner margin
    out = ["# generated by scenarios/generate.py "
           f"--size {s} --obstacles {obstacles} --freq {float(freq)} --seed {seed}",
           "[field]", f"size = [{s}, {s}]"]
    corners = [((m, 2 * m), (2 * m, m)), ((s - m, 2 * m), (s - 2 * m, m)),
               ((m, s - 2 * m), (2 * m, s - m)),
               ((s - m, s - 2 * m), (s - 2 * m, s - m))]
    for (x0, y0), (x1, y1) in corners:
        out += ["", "[[waypoints]]", f"line = [[{x0:g}, {y0:g}], [{x1:g}, {y1:g}]]"]
    for _ in range(obstacles):
        x = rng.uniform(3 * m, s - 3 * m)
        y = rng.uniform(3 * m, s - 3 * m)
        length = rng.uniform(1.0, max_obstacle_len)
        angle = rng.uniform(0.0, 6.28318)
        dx = math.cos(angle) * length / 2
        dy = math.sin(angle) * length / 2
        w = rng.uniform(0.3, 1.5)
        out += ["", "[[obstacles]]",
                f"line = [[{x - dx:.2f}, {y - dy:.2f}], [{x + dx:.2f}, {y + dy:.2f}]]",
                f"width = {w:.2f}"]
    for origin, dest in [(0, 3), (3, 0), (1, 2), (2, 1)]:
        out += ["", "[[pedestrians]]", f"origin = {origin}",
                f"destination = {dest}",
                f'spawn = {{ kind = "periodic", frequency = {float(freq):g} }}']
    return "\n".join(out) + "\n"


def generate(config: dict, traffic: dict, seed: int) -> dict:
    """The problem of ``config`` at the cell unit of ``traffic``: the TOML
    text, its geometry, the spawn groups and the simulator's settings."""
    text = toml_text(**config["scenario"])
    data = tomllib.loads(text)

    def seg(t):
        return [list(map(float, t["line"][0])), list(map(float, t["line"][1])),
                float(t.get("width", 1.0))]

    return {
        "toml": text,
        "geometry": {"size": [float(v) for v in data["field"]["size"]],
                     "unit": float(config["field_unit"]),
                     "waypoints": [seg(t) for t in data["waypoints"]],
                     "obstacles": [seg(t) for t in data["obstacles"]]},
        "groups": [{"origin": int(p["origin"]), "destination": int(p["destination"]),
                    "frequency": float(p["spawn"]["frequency"])}
                   for p in data["pedestrians"]],
        "cell_unit": float(traffic["cell_unit"]),
        "table_capacity": int(config["table_capacity"]),
    }
