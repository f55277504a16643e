"""The share of the traced window in which the device ran nothing
(``device_idle.bulk`` and ``device_idle.tick``)."""


def read(s: dict) -> float | None:
    if s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
