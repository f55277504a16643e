"""How long a tick waits for its device work and its metrics copy: the
summed host time of the Simulator's ``sim.fetch`` span
(``pedoni_tpu_torch/utils/trace.py``), over the ticks.  None where the
summary holds no program spans."""


def read(s: dict) -> float | None:
    fetch = (s.get("program_spans") or {}).get("sim.fetch")
    if not fetch or not fetch["n"] or not s["units"]:
        return None
    return fetch["s"] / s["units"] * 1e3
