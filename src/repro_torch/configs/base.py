"""Submodular problem configs (answers `src/repro/configs/base.py`,
`SubmodularConfig` only: the port runs no model of the LLM zoo)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SubmodularConfig:
    """A GreedyML problem instance description."""

    objective: str               # 'kcover' | 'kdom' | 'kmedoid' | 'facility'
    k: int                       # cardinality constraint
    n: int                       # ground-set size
    universe: int = 0            # k-cover/k-dom: universe size (bits)
    feature_dim: int = 0         # k-medoid/facility: feature dim
    num_machines: int = 8        # leaves m of the accumulation tree
    branching: int = 8           # b; L = ceil(log_b m)
    seed: int = 0
    augment: int = 0             # k-medoid: random images added per accum step
