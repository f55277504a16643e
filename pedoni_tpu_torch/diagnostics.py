"""Per-step metric collection and JSON export.

Keeps the exact JSON schema of the reference's diagnostic log
(diagnostic.rs:6-50, written by pedoni/src/main.rs:119-130) so existing
analysis tooling carries over:

    {
      "model": str, "scenario": str, "total_steps": int,
      "preprocess_metrics": {"time_calc_field": float},
      "step_metrics": {
        "active_ped_count": [int], "time_spawn": [float],
        "time_calc_state": [float], "time_calc_state_kernel": [float|null]
      }
    }

Our fused device step has no separate spawn phase, so ``time_spawn``
records 0.0 on ordinary steps and the whole step time goes to
``time_calc_state``; under ``--profile`` both the spawn slot and the
kernel-time slot are populated every 100 steps from isolated timed fences
(Simulator.measure_spawn_time / measure_kernel_time — the reference
measured kernel time and threw it away, sfm_gpu.rs:229-236).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class StepRecord:
    active_ped_count: int
    time_spawn: float
    time_calc_state: float
    time_calc_state_kernel: Optional[float] = None


@dataclasses.dataclass
class DiagnosticLog:
    model: str = ""
    scenario: str = ""
    total_steps: int = 0
    time_calc_field: float = 0.0
    active_ped_count: list = dataclasses.field(default_factory=list)
    time_spawn: list = dataclasses.field(default_factory=list)
    time_calc_state: list = dataclasses.field(default_factory=list)
    time_calc_state_kernel: list = dataclasses.field(default_factory=list)

    def push(self, rec: StepRecord) -> None:
        self.total_steps += 1
        self.active_ped_count.append(int(rec.active_ped_count))
        self.time_spawn.append(float(rec.time_spawn))
        self.time_calc_state.append(float(rec.time_calc_state))
        self.time_calc_state_kernel.append(rec.time_calc_state_kernel)

    def to_dict(self) -> dict:
        return {
            "model": self.model,
            "scenario": self.scenario,
            "total_steps": self.total_steps,
            "preprocess_metrics": {"time_calc_field": self.time_calc_field},
            "step_metrics": {
                "active_ped_count": self.active_ped_count,
                "time_spawn": self.time_spawn,
                "time_calc_state": self.time_calc_state,
                "time_calc_state_kernel": self.time_calc_state_kernel,
            },
        }

    def write(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
