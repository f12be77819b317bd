"""Hereditary constraints beyond cardinality, batched (answers
`src/repro/core/constraints.py`).

The same fixed-shape feasibility protocol as the reference — a small
state, a feasible mask per step, an update on selection — written for a
batch of greedies: every tensor carries the leading dimensions of the
batch (the lanes of a tree level), so one constrained `greedy_batch`
serves them all and its state never leaves the device.

  PartitionMatroid  categories (…, n) int64 per-element category,
                    capacities (C,) or (…, C); state (…, C) counts
  Knapsack          costs (…, n) f32, budget () or (…,) f32; state the
                    (…,) f32 spent-so-far, one f32 add per accepted step
                    in selection order, as in the reference
  Composite         the AND of several constraints; state a tuple
  KnapsackSpec      global-id-indexed costs + one budget; `bind(ids)`
                    gives the pool-bound Knapsack of (…, n) pools

Feasibility is `spent + cost ≤ budget` in f32, computed as in jnp (one
rounded add, then the comparison), so a budget tie is decided as the
reference decides it.

A constraint is pool-bound: categories and costs index by candidate
POSITION in the pools selected from. `lift()` adds a leading batch
dimension of one (the single-pool `greedy` calls `greedy_batch` with it).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

F32 = torch.float32


def _int_index(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


@dataclasses.dataclass
class PartitionMatroid:
    """categories: (…, n) per-element category; capacities: (C,) or
    (…, C) per-category capacities."""

    categories: torch.Tensor
    capacities: torch.Tensor

    def __post_init__(self):
        self.categories = _int_index(self.categories)
        self.capacities = torch.as_tensor(
            self.capacities, device=self.categories.device).to(torch.int64)

    def init_state(self) -> torch.Tensor:
        batch = self.categories.shape[:-1]
        return torch.zeros(batch + self.capacities.shape[-1:],
                           dtype=torch.int64,
                           device=self.categories.device)

    def feasible_mask(self, counts: torch.Tensor) -> torch.Tensor:
        """(…, n) bool: adding element i keeps its category under
        capacity."""
        open_cat = counts < self.capacities
        return torch.gather(open_cat, -1, self.categories)

    def update(self, counts: torch.Tensor, element_index) -> torch.Tensor:
        """Counts after selecting position `element_index` (…,) of each
        pool."""
        cat = torch.gather(self.categories, -1,
                           _int_index(element_index).unsqueeze(-1))
        return counts.scatter_add(-1, cat, torch.ones_like(cat))

    def lift(self) -> "PartitionMatroid":
        return PartitionMatroid(self.categories.unsqueeze(0),
                                self.capacities)


def uniform_matroid(n: int, k: int, device=None) -> PartitionMatroid:
    """Cardinality-k as a 1-category partition matroid (for tests)."""
    return PartitionMatroid(torch.zeros(n, dtype=torch.int64, device=device),
                            torch.tensor([k], dtype=torch.int64,
                                         device=device))


@dataclasses.dataclass
class Knapsack:
    """costs: (…, n) f32 per-element costs (pool-positional, ≥ 0);
    budget: () or (…,) f32. State: the (…,) f32 spent-so-far."""

    costs: torch.Tensor
    budget: torch.Tensor

    def __post_init__(self):
        self.costs = torch.as_tensor(self.costs).to(F32)
        self.budget = torch.as_tensor(self.budget,
                                      device=self.costs.device).to(F32)

    def init_state(self) -> torch.Tensor:
        return torch.zeros(self.costs.shape[:-1], dtype=F32,
                           device=self.costs.device)

    def feasible_mask(self, spent: torch.Tensor) -> torch.Tensor:
        """(…, n) bool: adding element i keeps the total within budget."""
        budget = self.budget.reshape(self.budget.shape + (1,))
        return spent.unsqueeze(-1) + self.costs <= budget

    def update(self, spent: torch.Tensor, element_index) -> torch.Tensor:
        cost = torch.gather(self.costs, -1,
                            _int_index(element_index).unsqueeze(-1))
        return spent + cost.squeeze(-1)

    def lift(self) -> "Knapsack":
        return Knapsack(self.costs.unsqueeze(0),
                        self.budget.unsqueeze(0) if self.budget.dim()
                        else self.budget)


@dataclasses.dataclass
class Composite:
    """Intersection (AND) of hereditary constraints, e.g. knapsack ×
    partition matroid; the state is the tuple of the parts' states."""

    parts: Tuple

    def init_state(self) -> Tuple:
        return tuple(p.init_state() for p in self.parts)

    def feasible_mask(self, state: Tuple) -> torch.Tensor:
        mask = self.parts[0].feasible_mask(state[0])
        for p, s in zip(self.parts[1:], state[1:]):
            mask = mask & p.feasible_mask(s)
        return mask

    def update(self, state: Tuple, element_index) -> Tuple:
        return tuple(p.update(s, element_index)
                     for p, s in zip(self.parts, state))

    def lift(self) -> "Composite":
        return Composite(tuple(p.lift() for p in self.parts))


def select_state(accept: torch.Tensor, new, old):
    """Per-greedy where(accept, new, old) over a constraint state (a
    tensor with leading dims accept.shape, or a tuple of them)."""
    if isinstance(new, tuple):
        return tuple(select_state(accept, a, b) for a, b in zip(new, old))
    keep = accept.reshape(accept.shape + (1,) * (new.dim() - accept.dim()))
    return torch.where(keep, new, old)


@dataclasses.dataclass
class KnapsackSpec:
    """Global knapsack for tree selection: ``costs`` (n_total,) f32
    indexed by GLOBAL element id, one shared ``budget``. ``bind(ids)``
    gathers the pool-bound costs of (…, n) pools, so leaves and the
    gathered unions of accumulation nodes each get an aligned Knapsack.
    Invalid slots (id −1) bind at cost 0 — `valid` masks them anyway."""

    costs: torch.Tensor
    budget: float

    def __post_init__(self):
        self.costs = torch.as_tensor(self.costs).to(F32)
        self.budget = float(self.budget)

    def bind(self, ids: torch.Tensor) -> Knapsack:
        ids = torch.as_tensor(ids)
        costs = self.costs.to(ids.device)
        pool = torch.where(ids >= 0, costs[ids.clamp(min=0)],
                           torch.zeros((), dtype=F32, device=ids.device))
        return Knapsack(pool, torch.tensor(self.budget, dtype=F32,
                                           device=ids.device))

    def spent(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(…,) f32 cost of solutions ids/valid (…, k), added one element
        at a time in selection order — the spent state the greedy that
        selected them accumulated."""
        cost = self.bind(ids).costs
        total = torch.zeros(ids.shape[:-1], dtype=F32, device=ids.device)
        for j in range(ids.shape[-1]):
            total = torch.where(valid[..., j], total + cost[..., j], total)
        return total
