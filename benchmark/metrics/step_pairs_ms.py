"""The device time of the grid step's pair pass a tick: every kernel named
``step_pairs`` or ``step_pairs_<variant>`` (``csrc/step_kernel.cu``: the
chunked and segment variants past a K) in the trace, over the ticks
(``step_pairs_ms.tick``).  None where the summary holds no ticks or no such
kernel."""


def read(s: dict) -> float | None:
    if not s["units"]:
        return None
    hits = [v[0] for name, v in s["by_kernel"].items()
            if name == "step_pairs" or name.startswith("step_pairs_")]
    if not hits:
        return None
    return sum(hits) / s["units"] * 1e3
