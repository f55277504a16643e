"""Scenario schema and TOML loader.

Mirrors the serde schema of the reference (``pedoni-simulator/src/scenario.rs``)
so every scenario file written for it loads unchanged:

- ``[field] size = [w, h]``                       (scenario.rs:18-20)
- ``[[waypoints]] line = [[x,y],[x,y]], width``   (scenario.rs:39-43, width
  defaults to 1.0 via scenario.rs:4-6)
- ``[[obstacles]] line, width``                   (scenario.rs:23-27)
- ``[[pedestrians]] origin, destination,
     spawn = {kind = "periodic", frequency} | {kind = "once", count}``
                                                  (scenario.rs:55-66)

Unknown keys are ignored, matching serde's default behaviour (e.g. the stray
``unit`` key in the reference's random.toml:3 is silently dropped).
"""

from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path
from typing import Sequence

import numpy as np

Vec2 = tuple[float, float]


@dataclasses.dataclass(frozen=True)
class Segment:
    """A line segment with a width — the geometry primitive for both
    obstacles and waypoints."""

    line: tuple[Vec2, Vec2]
    width: float = 1.0

    @property
    def p0(self) -> np.ndarray:
        return np.asarray(self.line[0], dtype=np.float64)

    @property
    def p1(self) -> np.ndarray:
        return np.asarray(self.line[1], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class SpawnConfig:
    """Tagged spawn config: ``kind`` is "periodic" (Poisson arrivals with
    mean ``frequency`` per second) or "once" (``count`` agents at t=0)."""

    kind: str  # "periodic" | "once"
    frequency: float = 0.0
    count: int = 0

    def __post_init__(self) -> None:
        if self.kind not in ("periodic", "once"):
            raise ValueError(f"unknown spawn kind: {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class PedestrianGroup:
    origin: int
    destination: int
    spawn: SpawnConfig


@dataclasses.dataclass(frozen=True)
class Scenario:
    size: Vec2
    waypoints: tuple[Segment, ...] = ()
    obstacles: tuple[Segment, ...] = ()
    pedestrians: tuple[PedestrianGroup, ...] = ()

    def __post_init__(self) -> None:
        n_wp = len(self.waypoints)
        for group in self.pedestrians:
            if not (0 <= group.origin < n_wp) or not (0 <= group.destination < n_wp):
                raise ValueError(
                    f"pedestrian group references waypoint out of range "
                    f"(origin={group.origin}, destination={group.destination}, "
                    f"n_waypoints={n_wp})"
                )

    @property
    def periodic_groups(self) -> tuple[PedestrianGroup, ...]:
        return tuple(g for g in self.pedestrians if g.spawn.kind == "periodic")

    @property
    def once_groups(self) -> tuple[PedestrianGroup, ...]:
        return tuple(g for g in self.pedestrians if g.spawn.kind == "once")


def _as_vec2(value: Sequence[float], what: str) -> Vec2:
    if len(value) != 2:
        raise ValueError(f"{what} must be a pair, got {value!r}")
    return (float(value[0]), float(value[1]))


def _parse_segment(table: dict, what: str) -> Segment:
    line = table.get("line")
    if line is None or len(line) != 2:
        raise ValueError(f"{what} requires 'line' of two points")
    return Segment(
        line=(_as_vec2(line[0], what), _as_vec2(line[1], what)),
        width=float(table.get("width", 1.0)),
    )


def _parse_spawn(table: dict) -> SpawnConfig:
    kind = table.get("kind")
    if kind == "periodic":
        return SpawnConfig(kind="periodic", frequency=float(table["frequency"]))
    if kind == "once":
        return SpawnConfig(kind="once", count=int(table["count"]))
    raise ValueError(f"spawn requires kind = 'periodic' or 'once', got {kind!r}")


def parse_scenario(data: dict) -> Scenario:
    field = data.get("field")
    if field is None or "size" not in field:
        raise ValueError("scenario requires [field] with a 'size'")
    return Scenario(
        size=_as_vec2(field["size"], "field.size"),
        waypoints=tuple(
            _parse_segment(w, "waypoint") for w in data.get("waypoints", [])
        ),
        obstacles=tuple(
            _parse_segment(o, "obstacle") for o in data.get("obstacles", [])
        ),
        pedestrians=tuple(
            PedestrianGroup(
                origin=int(p["origin"]),
                destination=int(p["destination"]),
                spawn=_parse_spawn(p["spawn"]),
            )
            for p in data.get("pedestrians", [])
        ),
    )


def load_scenario(path: str | Path) -> Scenario:
    with open(path, "rb") as f:
        return parse_scenario(tomllib.load(f))


def loads_scenario(text: str) -> Scenario:
    return parse_scenario(tomllib.loads(text))
