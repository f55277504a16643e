"""The step's share of its roofline: the least time of the work a step
needs (``benchmark/work/step_work.py``, from the problem's agents, texels
and neighbour window) over the device's busy time a step."""


def read(s: dict) -> float | None:
    if not s["units"] or s["busy_s"] <= 0 or not s.get("bound_s"):
        return None
    return 100.0 * s["bound_s"] / (s["busy_s"] / s["units"])
