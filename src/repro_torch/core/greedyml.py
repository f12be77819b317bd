"""GreedyML stage by stage over stacked lane state, on one device (answers
the single-device half of `src/repro/core/greedyml.py`: `shard_lanes`,
`empty_lane_solutions`, `root_solution`, `accumulate_one_level` and
`LevelDispatcher(mesh=None)`).

The m tree machines are LANES of one stacked state (lanes, …), lane ids
mixed-radix over (b_1, …, b_L), the level-0 digit lowest — the paper's
``parent(id, ℓ) = b^ℓ·⌊id/b^ℓ⌋`` arithmetic. Level ℓ gathers, for every
lane, the solutions of the b lanes that differ from it only in digit ℓ
(in digit order) and runs a node greedy on that b·k union IN EVERY LANE,
each then keeping argmax{f(S), f(S_prev)} against its own S_prev — as the
reference's vmap over the named tree axes does, so the stacked lane state
equals the reference's lane for lane. The gather is a reshape over the
lane digits; one batched greedy serves all lanes of a stage.

Constraints: a spec with ``bind(ids)`` (core/constraints.py KnapsackSpec)
is bound to each lane's pool at the leaves and to each lane's union at
every level, as in the reference.

Stochastic greedy: the per-lane draws of stage s (0 = the leaves, ℓ + 1 =
level ℓ) come from ONE replaceable sampler,
``sampler(stage, lanes, k, n, sample) → (lanes, k, sample)`` indices.
The default, `LaneSampler`, seeds a CPU torch.Generator from
(seed, stage, lane). torch cannot reproduce JAX's PRNG stream, so the
port's random stream differs from the reference's; tests hand the
dispatcher a sampler that returns the reference's own draws.

The distributed half — a device mesh (`torch.distributed`, ROADMAP A3)
and sharded leaves (`shard > 1`, ROADMAP A5) — is not ported: asking for
either raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.greedy import (Solution, _sample_candidates,
                                     greedy_batch, replay_value,
                                     select_better)

F32 = torch.float32

Sampler = Callable[[int, int, int, int, int], torch.Tensor]


def shard_lanes(ids, payloads, valid, lanes: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split flat (n, …) candidate tensors into stacked (lanes, n/lanes, …)
    blocks — lane i gets contiguous block i."""
    n = ids.shape[0]
    if n % lanes:
        raise ValueError(f"n={n} must divide over {lanes} lanes")
    shp = (lanes, n // lanes)
    return (ids.reshape(shp), payloads.reshape(shp + payloads.shape[1:]),
            valid.reshape(shp))


def empty_lane_solutions(lanes: int, k: int,
                         payload_example: torch.Tensor) -> Solution:
    """Stacked all-invalid per-lane state."""
    dev = payload_example.device
    pay = torch.zeros((lanes, k) + tuple(payload_example.shape[1:]),
                      dtype=payload_example.dtype, device=dev)
    return Solution(torch.full((lanes, k), -1, dtype=torch.int64,
                               device=dev), pay,
                    torch.zeros((lanes, k), dtype=torch.bool, device=dev),
                    torch.zeros((lanes,), dtype=F32, device=dev),
                    torch.zeros((lanes,), dtype=torch.int64, device=dev))


def root_solution(lane_sols: Solution) -> Solution:
    """The answer after the last level: machine 0's solution (row 0)."""
    return lane_sols.map(lambda x: x[0])


def gather_groups(x: torch.Tensor, radices: Tuple[int, ...],
                  lvl: int) -> torch.Tensor:
    """(lanes, k, …) per-lane tensors → (lanes, b·k, …): every lane gets
    the concatenation, in digit order, of the b lanes that share all its
    digits but digit `lvl` (the reference's all_gather over
    tree_axes[lvl], tiled)."""
    lanes = x.shape[0]
    inner = math.prod(radices[:lvl])
    b = radices[lvl]
    outer = lanes // (inner * b)
    rest = tuple(x.shape[1:])
    grouped = x.reshape((outer, b, inner) + rest).movedim(1, 2)
    union = grouped.reshape((outer, inner, b * rest[0]) + rest[1:])
    return union.unsqueeze(1).expand((outer, b) + union.shape[1:]).reshape(
        (lanes,) + union.shape[2:])


def lane_seed(seed: int, stage: int, lane: int) -> int:
    """A 63-bit torch seed for one lane's draws at one stage."""
    words = np.random.SeedSequence([seed, stage, lane]).generate_state(2)
    return int(words[0]) << 31 ^ int(words[1])


@dataclasses.dataclass
class LaneSampler:
    """The default sampler: lane l's draws at stage s from a CPU
    torch.Generator seeded with lane_seed(seed, s, l) — the same on every
    device, so a CPU run and a card run draw alike."""

    seed: int = 0

    def __call__(self, stage: int, lanes: int, k: int, n: int,
                 sample: int) -> torch.Tensor:
        return torch.stack([
            _sample_candidates(torch.Generator().manual_seed(
                lane_seed(self.seed, stage, lane)), k, n, sample)
            for lane in range(lanes)])


def accumulate_one_level(objective, s_prev: Solution, k: int,
                         radices: Tuple[int, ...], lvl: int,
                         aug: Optional[torch.Tensor] = None,
                         cand_idx: Optional[torch.Tensor] = None,
                         sample: int = 0, node_engine: str = "auto",
                         constraint=None
                         ) -> Tuple[Solution, torch.Tensor, torch.Tensor]:
    """ONE accumulation round over stacked lanes: gather the group unions
    of level `lvl`, run the node greedy in every lane, keep argmax{f(S),
    f(S_prev)} against each lane's own S_prev. ``aug`` (A, …): extra
    evaluation elements appended to every lane's ground set; ``cand_idx``
    (lanes, k, sample): the node greedies' draws when ``sample`` is on.
    Returns (solutions, ground, ground_valid)."""
    u_ids = gather_groups(s_prev.ids, radices, lvl)
    u_pay = gather_groups(s_prev.payloads, radices, lvl)
    u_val = gather_groups(s_prev.valid, radices, lvl)
    ground, ground_valid = u_pay, u_val
    if aug is not None:
        lanes = u_pay.shape[0]
        aug = aug.to(u_pay.device, u_pay.dtype)
        ground = torch.cat([u_pay, aug.expand((lanes,) + aug.shape)], dim=1)
        ground_valid = torch.cat(
            [u_val, torch.ones((lanes, aug.shape[0]), dtype=torch.bool,
                               device=u_val.device)], dim=1)
    s_new = greedy_batch(objective, u_ids, u_pay, u_val, k, ground=ground,
                         ground_valid=ground_valid, sample=sample,
                         cand_idx=cand_idx, engine=node_engine,
                         constraint=(constraint.bind(u_ids)
                                     if constraint is not None else None))
    prev_score = replay_value(objective, s_prev.payloads, s_prev.valid,
                              ground, ground_valid)
    s_out = select_better(s_new, dataclasses.replace(s_prev,
                                                     value=prev_score))
    return s_out, ground, ground_valid


@dataclasses.dataclass
class LevelDispatcher:
    """Runs one GreedyML stage at a time over stacked per-lane state on
    the objective's device.

    ``radices``: per-level branching (innermost level first); lanes =
    prod(radices). ``engine`` drives the leaf greedies, ``node_engine``
    (default: inherit) the accumulation nodes. ``sample_leaf`` /
    ``sample_level``: stochastic greedy at the leaves / nodes, with draws
    from ``sampler`` (default `LaneSampler(seed or 0)`). ``constraint``:
    a spec with ``bind(ids)``, e.g. KnapsackSpec. ``mesh`` must be None
    and ``shard`` 1: the distributed half is not ported (ROADMAP A3, A5).
    Stages take and return stacked (lanes, …) Solutions.
    """

    objective: Any
    k: int
    radices: Tuple[int, ...]
    mesh: Any = None
    engine: str = "auto"
    node_engine: Optional[str] = None
    sample_leaf: int = 0
    sample_level: int = 0
    seed: Optional[int] = None
    shard: int = 1
    constraint: Any = None
    sampler: Optional[Sampler] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "LevelDispatcher over a device mesh (torch.distributed) is "
                "not ported yet: ROADMAP A3; pass mesh=None")
        if int(self.shard) != 1:
            raise NotImplementedError(
                "sharded leaves (shard > 1) are not ported yet: ROADMAP A5")
        self.radices = tuple(int(r) for r in self.radices)
        self.lanes = math.prod(self.radices)
        self.node_engine = self.node_engine or self.engine
        if self.sampler is None:
            self.sampler = LaneSampler(0 if self.seed is None else self.seed)

    @property
    def num_levels(self) -> int:
        return len(self.radices)

    def _draws(self, stage: int, n: int, sample: int):
        if not 0 < sample < n:
            return None
        return self.sampler(stage, self.lanes, self.k, n, sample)

    def leaves(self, ids, payloads, valid) -> Solution:
        """Leaf greedy per lane over stacked (lanes, n_l, …) pools."""
        obj = self.objective
        ids = torch.as_tensor(ids, device=obj.device).to(torch.int64)
        return greedy_batch(
            obj, ids, payloads, valid, self.k, sample=self.sample_leaf,
            cand_idx=self._draws(0, ids.shape[1], self.sample_leaf),
            engine=self.engine,
            constraint=(self.constraint.bind(ids)
                        if self.constraint is not None else None))

    def level(self, lane_sols: Solution, lvl: int,
              aug_row: Optional[torch.Tensor] = None) -> Solution:
        """One accumulation round at level `lvl` over stacked lanes."""
        n = self.radices[lvl] * lane_sols.ids.shape[1]
        out, _, _ = accumulate_one_level(
            self.objective, lane_sols, self.k, self.radices, lvl,
            aug=aug_row,
            cand_idx=self._draws(1 + lvl, n, self.sample_level),
            sample=self.sample_level, node_engine=self.node_engine,
            constraint=self.constraint)
        return out
