"""Compatibility façade (answers `src/repro/core/functions.py`):
objectives live in core/objective.py."""
from __future__ import annotations

from repro_torch.core.objective import (DEFAULT_SAT_CAP, RuleObjective,
                                        RuleState, make_objective, register,
                                        registry)

__all__ = ["DEFAULT_SAT_CAP", "RuleObjective", "RuleState",
           "make_objective", "register", "registry"]
