"""The host's time in the program's step, over the steps or ticks: the
summed host time of the ``flat.step`` and ``grid.step`` spans
(``pedoni_tpu_torch/utils/trace.py``), what one step costs the host to
enqueue, waits for a full launch queue included (``step_host_ms.bulk`` and
``step_host_ms.tick``).  None where the summary holds no program spans."""


def read(s: dict) -> float | None:
    spans = s.get("program_spans")
    if not spans or not s["units"]:
        return None
    steps = [spans[n] for n in ("flat.step", "grid.step") if n in spans]
    if not any(v["n"] for v in steps):
        return None
    return sum(v["s"] for v in steps) / s["units"] * 1e3
