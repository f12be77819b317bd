"""Straggler detection (answers `src/repro/runtime/straggler.py`).

The level-by-level selection cannot proceed without every lane, so
mitigation happens at the supervision layer: persistent outliers in the
per-dispatch wall times (read after the device has finished,
runtime/supervisor.py) trigger an action — exclude the slow worker at
the next re-plan, and a pre-emptive checkpoint. The policy is
deterministic, so synthetic timing traces test it.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerMonitor:
    window: int = 20              # sliding window of per-step durations
    threshold: float = 2.0        # flag if > threshold × median
    patience: int = 3             # consecutive flags before action
    _hist: List[float] = dataclasses.field(default_factory=list)
    _flags: int = 0
    actions: List[Dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, duration_s: float,
                host: Optional[int] = None) -> Optional[str]:
        """Record a step duration; returns an action string when triggered."""
        self._hist.append(duration_s)
        if len(self._hist) > self.window:
            self._hist.pop(0)
        if len(self._hist) < max(5, self.window // 2):
            return None
        med = statistics.median(self._hist[:-1])
        if med > 0 and duration_s > self.threshold * med:
            self._flags += 1
        else:
            self._flags = 0
        if self._flags >= self.patience:
            self._flags = 0
            action = {"kind": "straggler", "step": step, "host": host,
                      "duration": duration_s, "median": med,
                      "action": "exclude_on_next_reshard"}
            self.actions.append(action)
            return action["action"]
        return None
