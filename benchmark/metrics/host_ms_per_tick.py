"""Host time a tick: the traced window's wall time less the device's busy
time, over the ticks (the Simulator's host path, ``sim.py``)."""


def read(s: dict) -> float | None:
    if not s["units"]:
        return None
    return (s["window_s"] - s["busy_s"]) / s["units"] * 1e3
