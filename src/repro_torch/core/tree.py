"""Accumulation tree T(m, L, b) — structure, ids, and the BSP cost model
(answers `src/repro/core/tree.py`; pure Python, no framework).

Node ids follow the paper exactly: leaves are machine ids at level 0;
``parent(id, ℓ) = b^ℓ · floor(id / b^ℓ)``; internal nodes inherit the lowest
child id; the root is (L, 0) with L = ceil(log_b m). Ragged trees (m not a
power of b) have at most one node with arity < b per level.

``MixedRadixTree`` generalizes to per-level branching (b_1, …, b_L) — the
shard_map code uses it to map tree levels onto physical mesh axes
(e.g. 512 devices = 16 × 16 × 2). Theorem 4.4 only counts levels, so the
α/(L+1) guarantee holds unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple


def level_of(machine_id: int, b: int, num_levels: int) -> int:
    """Highest level this machine participates in (Algorithm 3.1, level())."""
    if machine_id == 0:
        return num_levels
    lvl = 0
    while machine_id % (b ** (lvl + 1)) == 0:
        lvl += 1
    return lvl


def parent(machine_id: int, lvl: int, b: int) -> int:
    return (b ** lvl) * (machine_id // (b ** lvl))


def children(node_id: int, lvl: int, b: int, m: int) -> List[int]:
    """Child machine ids of node (lvl, node_id), lvl ≥ 1 (ragged-aware)."""
    step = b ** (lvl - 1)
    out = []
    for j in range(b):
        cid = node_id + j * step
        if cid < m:
            out.append(cid)
    return out


@dataclasses.dataclass(frozen=True)
class AccumulationTree:
    m: int                      # number of machines (leaves)
    b: int                      # branching factor

    @property
    def num_levels(self) -> int:
        return max(1, math.ceil(math.log(self.m, self.b))) if self.m > 1 else 1

    def nodes_at_level(self, lvl: int) -> List[int]:
        step = self.b ** lvl
        return [i for i in range(0, self.m, step)]

    def all_nodes(self) -> List[Tuple[int, int]]:
        out = [(0, i) for i in range(self.m)]
        for lvl in range(1, self.num_levels + 1):
            out.extend((lvl, i) for i in self.nodes_at_level(lvl))
        return out

    def children_of(self, lvl: int, node_id: int) -> List[int]:
        return children(node_id, lvl, self.b, self.m)

    # ------------------------------------------------------------- BSP model
    def cost_model(self, n: int, k: int, delta: float,
                   objective: str = "coverage") -> Dict[str, float]:
        """Table 1 of the paper, per-machine accounting."""
        m, b, L = self.m, self.b, self.num_levels
        per_leaf_elems = n / m
        per_leaf_calls = n * k / m
        per_interior_elems = k * b
        per_interior_calls = (k * b) * k
        total_calls_critical = per_leaf_calls + L * per_interior_calls
        if objective == "kmedoid":
            leaf_cost = delta * (n / m) ** 2 * k
            interior_cost = delta * L * (k * b) ** 2 * k
            compute = leaf_cost + interior_cost
        else:
            compute = delta * k * (n / m + L * b * k)
        comm = delta * k * L * b
        return {
            "machines": m, "branching": b, "levels": L,
            "elements_per_leaf": per_leaf_elems,
            "calls_per_leaf": per_leaf_calls,
            "elements_per_interior": per_interior_elems,
            "calls_per_interior": per_interior_calls,
            "calls_critical_path": total_calls_critical,
            "compute_cost": compute,
            "comm_cost": comm,
        }


@dataclasses.dataclass(frozen=True)
class MixedRadixTree:
    """Per-level branching factors, innermost (leaf-adjacent) level first."""

    radices: Tuple[int, ...]

    @property
    def m(self) -> int:
        return math.prod(self.radices)

    @property
    def num_levels(self) -> int:
        return len(self.radices)

    def machine_coords(self, machine_id: int) -> Tuple[int, ...]:
        out = []
        rem = machine_id
        for r in self.radices:
            out.append(rem % r)
            rem //= r
        return tuple(out)


def randgreedi_tree(m: int) -> AccumulationTree:
    """RandGreedi = the L=1 special case (branching factor m)."""
    return AccumulationTree(m=m, b=m)
