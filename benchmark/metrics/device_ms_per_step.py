"""The device's busy time a step (the union of its operations' intervals
in the trace, over the steps)."""


def read(s: dict) -> float | None:
    if not s["units"] or s["busy_s"] <= 0:
        return None
    return s["busy_s"] / s["units"] * 1e3
