"""Device operations a step or tick in the trace (the step's launches,
with the window's restores and, in a tick, the Simulator's), left out
where the trace lost launches of a hand kernel (``launches_per_step.bulk``
and ``launches_per_step.tick``)."""


def read(s: dict) -> float | None:
    if not s["units"] or not s["launches_ok"]:
        return None
    return s["device_ops"] / s["units"]
