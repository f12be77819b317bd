"""GreedyML stage by stage over lane state, on one device or over the
ranks of a process group (answers `src/repro/core/greedyml.py`:
`shard_lanes`, `empty_lane_solutions`, `root_solution`,
`_machine_flat_id`, `_broadcast_from_root`, `accumulate_one_level`,
`accumulate_levels`, `greedyml_distributed`, `randgreedi_distributed`
and `LevelDispatcher`).

The m tree machines are LANES, lane ids mixed-radix over (b_1, …, b_L),
the level-0 digit lowest — the paper's ``parent(id, ℓ) = b^ℓ·⌊id/b^ℓ⌋``
arithmetic. Level ℓ gathers, for every lane, the solutions of the b
lanes that differ from it only in digit ℓ (in digit order) and runs a
node greedy on that b·k union IN EVERY LANE, each then keeping
argmax{f(S), f(S_prev)} against its own S_prev — as the reference's
collectives over the named tree axes do.

Two placements of the lanes run the same stage code:
  * ``mesh=None``: every lane in ONE stacked state (lanes, …) on one
    device; the gather is a reshape over the lane digits
    (`gather_groups`) and one batched greedy serves all lanes of a stage;
  * ``mesh=`` a `launch/mesh.py::TreeMesh`: one lane per rank of a
    `torch.distributed` process group, lane id = rank, each rank holding
    its own lane as a stacked (1, …) state; the gather is
    ``dist.all_gather`` over the rank's level-ℓ subgroup (the row
    `gather_groups` builds for that lane), and the answer is machine 0's
    solution broadcast to every rank (`_broadcast_from_root`).

Constraints: a spec with ``bind(ids)`` (core/constraints.py KnapsackSpec)
is bound to each lane's pool at the leaves and to each lane's union at
every level, as in the reference.

Stochastic greedy: the per-lane draws of stage s (0 = the leaves, ℓ + 1 =
level ℓ) come from ONE replaceable sampler,
``sampler(stage, lanes, k, n, sample) → (lanes, k, sample)`` indices; a
rank takes row ``rank``, so a distributed tree draws exactly what the
stacked tree draws from the same sampler. The default, `LaneSampler`,
seeds a CPU torch.Generator from (seed, stage, lane). torch cannot
reproduce JAX's PRNG stream, so the port's random stream differs from
the reference's; tests hand the drivers a sampler that returns the
reference's own draws.

Sharded leaves (``shard`` > 1, the reference's :337-546): every machine
has `shard` lanes that split its leaf pool, lanes = machines·shard,
lane = machine·shard + shard digit (`shard_lanes`' contiguous blocks are
then each machine's pool in order). The leaves run the sharded tier
(kernels/shard_gains.py) over each machine's lanes — stacked, ONE gains
launch a (step, tile) for every lane; over a mesh, this rank's lane over
its `TreeMesh.shard_group`. Each lane's block is padded at its end to
whole candidate tiles (`shard_gains.pad_lanes`). As in the reference
(`_shard_leaf_body`, :444-447), no constraint is bound at sharded
leaves, and ``sample_leaf`` with ``shard`` > 1 raises. The levels carry
the shard lanes as replicated machine state: stacked, a level runs once
per machine (the machine's first lane) and is repeated over its lanes;
over a mesh every rank runs its own, its gathers over the ranks that
share its shard digit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.greedy import (Solution, _sample_candidates,
                                     greedy_batch, replay_value,
                                     select_better)
from repro_torch.kernels import shard_gains
from repro_torch.launch.mesh import TreeMesh

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


def machine_flat_id(mesh: TreeMesh) -> int:
    """Mixed-radix machine id of this rank's lane (level-0 digit lowest):
    the rank itself, or rank // shard with shard lanes."""
    mid, mult = 0, 1
    for d, r in zip(mesh.coords, mesh.radices):
        mid += d * mult
        mult *= r
    return mid


def _broadcast_from_root(sol: Solution, mesh: TreeMesh) -> Solution:
    """Machine 0's solution on every rank (the paper returns S_0)."""
    return sol.map(lambda x: mesh.broadcast(x, src=0))


def root_solution(lane_sols: Solution,
                  mesh: Optional[TreeMesh] = None) -> Solution:
    """The answer after the last level: machine 0's solution — row 0 of
    the stacked state, or over a mesh rank 0's lane, broadcast to every
    rank."""
    if mesh is not None:
        lane_sols = _broadcast_from_root(lane_sols, mesh)
    return lane_sols.map(lambda x: x[0])


def gather_groups(x: torch.Tensor, radices: Tuple[int, ...],
                  lvl: int) -> torch.Tensor:
    """(lanes, k, …) per-lane tensors → contiguous (lanes, b·k, …): every
    lane gets the concatenation, in digit order, of the b lanes that
    share all its digits but digit `lvl` (the reference's all_gather
    over tree_axes[lvl], tiled)."""
    lanes = x.shape[0]
    inner = math.prod(radices[:lvl])
    b = radices[lvl]
    outer = lanes // (inner * b)
    rest = tuple(x.shape[1:])
    grouped = x.reshape((outer, b, inner) + rest).movedim(1, 2)
    union = grouped.reshape((outer, inner, b * rest[0]) + rest[1:])
    return union.unsqueeze(1).expand((outer, b) + union.shape[1:]).reshape(
        (lanes,) + union.shape[2:])


def _level_union(x: torch.Tensor, radices: Tuple[int, ...], lvl: int,
                 mesh: Optional[TreeMesh]) -> torch.Tensor:
    """Level `lvl`'s union of (lanes, k, …) lane state: a reshape over
    the stacked lanes, or an all_gather of this rank's (1, k, …) lane."""
    if mesh is None:
        return gather_groups(x, radices, lvl)
    return mesh.all_gather(lvl, x[0]).unsqueeze(0)


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


def _draws(sampler: Sampler, stage: int, lanes: int, k: int, n: int,
           sample: int, mesh: Optional[TreeMesh]):
    """A stage's draws: every lane's, or over a mesh this rank's
    machine's row."""
    if not 0 < sample < n:
        return None
    d = sampler(stage, lanes, k, n, sample)
    if mesh is None:
        return d
    mid = machine_flat_id(mesh)
    return d[mid:mid + 1]


def accumulate_one_level(objective, s_prev: Solution, k: int,
                         radices: Tuple[int, ...], lvl: int,
                         aug: Optional[torch.Tensor] = None,
                         cand_idx: Optional[torch.Tensor] = None,
                         sample: int = 0, node_engine: str = "auto",
                         constraint=None, mesh: Optional[TreeMesh] = None
                         ) -> Tuple[Solution, torch.Tensor, torch.Tensor]:
    """ONE accumulation round over lane state (stacked lanes, or this
    rank's (1, …) lane over `mesh`): gather the group unions of level
    `lvl`, run the node greedy in every lane, keep argmax{f(S),
    f(S_prev)} against each lane's own S_prev. ``aug`` (A, …): extra
    evaluation elements appended to every lane's ground set; ``cand_idx``
    (lanes, k, sample): the node greedies' draws when ``sample`` is on.
    Returns (solutions, ground, ground_valid)."""
    u_ids = _level_union(s_prev.ids, radices, lvl, mesh)
    u_pay = _level_union(s_prev.payloads, radices, lvl, mesh)
    u_val = _level_union(s_prev.valid, radices, lvl, mesh)
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


def accumulate_levels(objective, s_prev: Solution, k: int,
                      radices: Tuple[int, ...],
                      aug_levels: Optional[Sequence[torch.Tensor]] = None,
                      sample_level: int = 0, node_engine: str = "auto",
                      carry_prev: Optional[Solution] = None,
                      sampler: Optional[Sampler] = None, constraint=None,
                      mesh: Optional[TreeMesh] = None) -> Solution:
    """Algorithm 3.1's accumulation rounds from ANY lane solution `s_prev`
    (a leaf greedy, a sieve summary): a loop over `accumulate_one_level`
    up the tree. ``aug_levels``: per-level extra evaluation rows (L, A, …)
    or None; ``carry_prev`` (k, …): an extra competitor (a continuous
    stream's last merged solution) for machine 0's lane, the one the
    answer is read from: replayed on that lane's root ground and
    select_better'd against it (row 0 of the stacked lanes; over a mesh,
    every rank's own lane, as in the reference); ``sampler``: the node
    draws (default LaneSampler(0)). Returns the lane state (stacked, or
    this rank's (1, …) lane over `mesh`)."""
    sampler = sampler or LaneSampler(0)
    lanes = math.prod(radices)
    ground, ground_valid = s_prev.payloads, s_prev.valid
    for lvl in range(len(radices)):
        n = radices[lvl] * s_prev.ids.shape[1]
        s_prev, ground, ground_valid = accumulate_one_level(
            objective, s_prev, k, radices, lvl,
            aug=None if aug_levels is None else aug_levels[lvl],
            cand_idx=_draws(sampler, 1 + lvl, lanes, k, n, sample_level,
                            mesh),
            sample=sample_level, node_engine=node_engine,
            constraint=constraint, mesh=mesh)
    if carry_prev is not None:
        carry = carry_prev.map(lambda x: x.to(ground.device).unsqueeze(0))
        score = replay_value(objective, carry.payloads, carry.valid,
                             ground[:1], ground_valid[:1])
        head = select_better(s_prev.map(lambda x: x[:1]),
                             dataclasses.replace(carry, value=score))
        rest = s_prev.map(lambda x: x[1:])
        s_prev = Solution(*(torch.cat([getattr(head, f.name),
                                       getattr(rest, f.name)])
                            for f in dataclasses.fields(Solution)))
    return s_prev


@dataclasses.dataclass
class LevelDispatcher:
    """Runs one GreedyML stage at a time over lane state.

    ``radices``: per-level branching (innermost level first); machines =
    prod(radices). ``shard``: lanes splitting each machine's leaf pool
    (the sharded tier), lanes = machines·shard, lane = machine·shard +
    shard digit; ``tile_c``: the sharded tier's candidate tile (0: the
    planner's, `shard_gains.resolve_tile_c`). ``engine`` drives the solo
    leaf greedies, ``node_engine`` (default: inherit) the accumulation
    nodes. ``sample_leaf`` / ``sample_level``: stochastic greedy at the
    leaves / nodes, with draws from ``sampler`` (default
    `LaneSampler(seed or 0)`, one row a machine). ``constraint``: a spec
    with ``bind(ids)``, e.g. KnapsackSpec (not bound at sharded leaves,
    as in the reference). ``mesh``: None runs every lane stacked on the
    objective's device, and stages take and return stacked (lanes, …)
    Solutions; a `TreeMesh` (one rank a lane, its radices and shard the
    tree's) runs this rank's lane, and stages take and return it as a
    stacked (1, …) Solution.
    """

    objective: Any
    k: int
    radices: Tuple[int, ...]
    mesh: Optional[TreeMesh] = None
    engine: str = "auto"
    node_engine: Optional[str] = None
    sample_leaf: int = 0
    sample_level: int = 0
    seed: Optional[int] = None
    shard: int = 1
    tile_c: int = 0
    constraint: Any = None
    sampler: Optional[Sampler] = None

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, TreeMesh):
            raise TypeError("mesh: a launch/mesh.py TreeMesh over the "
                            f"process group, or None; got {self.mesh!r}")
        self.radices = tuple(int(r) for r in self.radices)
        self.shard = max(1, int(self.shard))
        self.machines = math.prod(self.radices)
        self.lanes = self.machines * self.shard
        if self.shard > 1 and self.sample_leaf:
            raise ValueError("sharded leaves do not support stochastic "
                             "leaf sampling (its per-step draws have no "
                             "cross-lane protocol)")
        if self.mesh is not None and (self.mesh.radices, self.mesh.shard) != (
                self.radices, self.shard):
            raise ValueError(f"the mesh's tree {self.mesh.radices} with shard "
                             f"{self.mesh.shard} is not {self.radices} with "
                             f"shard {self.shard}")
        self.node_engine = self.node_engine or self.engine
        if self.sampler is None:
            self.sampler = LaneSampler(0 if self.seed is None else self.seed)

    @property
    def num_levels(self) -> int:
        return len(self.radices)

    def _draws(self, stage: int, n: int, sample: int):
        return _draws(self.sampler, stage, self.machines, self.k, n, sample,
                      self.mesh)

    def _own_lane(self, x):
        if self.mesh is not None and x.shape[0] != 1:
            raise ValueError("over a mesh a stage takes this rank's lane "
                             f"as a stacked (1, …) state, got {x.shape[0]}")

    def leaves(self, ids, payloads, valid) -> Solution:
        """Leaf greedy per lane over stacked (lanes, n_l, …) pools (over a
        mesh, (1, n_l, …): this rank's)."""
        obj = self.objective
        ids = torch.as_tensor(ids, device=obj.device).to(torch.int64)
        self._own_lane(ids)
        if self.shard > 1:
            return self._sharded_leaves(ids, payloads, valid)
        return greedy_batch(
            obj, ids, payloads, valid, self.k, sample=self.sample_leaf,
            cand_idx=self._draws(0, ids.shape[1], self.sample_leaf),
            engine=self.engine,
            constraint=(self.constraint.bind(ids)
                        if self.constraint is not None else None))

    def _sharded_leaves(self, ids, payloads, valid) -> Solution:
        """The sharded tier over each machine's `shard` lanes (no
        constraint bound, as the reference's `_shard_leaf_body`)."""
        obj = self.objective
        payloads = torch.as_tensor(payloads, device=obj.device)
        valid = torch.as_tensor(valid, device=obj.device).to(torch.bool)
        tile, n_s = shard_gains.lane_tile(obj.rule, ids.shape[1],
                                          payloads.shape[-1], self.shard,
                                          self.tile_c)
        ids, payloads, valid = shard_gains.pad_lanes(ids, payloads, valid,
                                                     n_s)
        return shard_gains.shard_greedy(obj, ids, payloads, valid, self.k,
                                        lanes=self.shard, tile_c=tile,
                                        mesh=self.mesh)

    def level(self, lane_sols: Solution, lvl: int,
              aug_row: Optional[torch.Tensor] = None) -> Solution:
        """One accumulation round at level `lvl` over the lane state.
        Stacked shard lanes hold their machine's state: the round runs
        once per machine and is repeated over its lanes."""
        self._own_lane(lane_sols.ids)
        stacked_shards = self.shard > 1 and self.mesh is None
        if stacked_shards:
            lane_sols = lane_sols.map(lambda x: x[::self.shard])
        n = self.radices[lvl] * lane_sols.ids.shape[1]
        out, _, _ = accumulate_one_level(
            self.objective, lane_sols, self.k, self.radices, lvl,
            aug=aug_row,
            cand_idx=self._draws(1 + lvl, n, self.sample_level),
            sample=self.sample_level, node_engine=self.node_engine,
            constraint=self.constraint, mesh=self.mesh)
        if stacked_shards:
            out = out.map(lambda x: x.repeat_interleave(self.shard, dim=0))
        return out


def check_tree_axes(mesh: TreeMesh, tree_axes: Optional[Sequence[str]]):
    """The reference's ``tree_axes`` argument: over a TreeMesh the levels
    are the mesh's, innermost first; anything else is refused."""
    if tree_axes is not None and tuple(tree_axes) != mesh.level_names:
        raise ValueError(f"tree_axes {tuple(tree_axes)} must be the mesh's "
                         f"levels, innermost first: {mesh.level_names}")


def _run_tree(disp: LevelDispatcher, ids, payloads, valid, augment,
              on_level) -> Solution:
    """This rank's block through the leaves and every level, then machine
    0's solution on every rank."""
    one = lambda x: torch.as_tensor(x).unsqueeze(0)
    sols = disp.leaves(one(ids), one(payloads), one(valid))
    if on_level is not None:
        on_level(0)
    for lvl in range(disp.num_levels):
        aug = None if augment is None else torch.as_tensor(augment[lvl])
        sols = disp.level(sols, lvl, aug)
        if on_level is not None:
            on_level(1 + lvl)
    return root_solution(sols, disp.mesh)


def greedyml_distributed(objective, ids, payloads, valid, k: int,
                         mesh: TreeMesh,
                         tree_axes: Optional[Sequence[str]] = None,
                         augment=None, sample_leaf: int = 0,
                         sample_level: int = 0, engine: str = "auto",
                         node_engine: Optional[str] = None,
                         seed: Optional[int] = None, constraint=None,
                         sampler: Optional[Sampler] = None,
                         on_level: Optional[Callable[[int], None]] = None
                         ) -> Solution:
    """Distributed GreedyML over the ranks of `mesh`, one machine a rank.

    ids/payloads/valid: THIS rank's contiguous block (n/m, …) — lane i
    holds block i of the global arrays, as the reference's PartitionSpec
    and `shard_lanes` cut them (`launch/mesh.py::local_block`).
    ``augment``: optional (L, A, …) per-level extra evaluation rows, the
    same on every rank. ``seed``: the default sampler's seed (None → 0);
    ``sampler``: the draws' source, overriding it. ``constraint``: a spec
    with ``bind(ids)`` bound at the leaves and every node. ``on_level``:
    called after each stage is issued (0 = the leaves). Returns machine
    0's solution on every rank."""
    check_tree_axes(mesh, tree_axes)
    disp = LevelDispatcher(objective, k, mesh.radices, mesh=mesh,
                           engine=engine, node_engine=node_engine,
                           sample_leaf=sample_leaf,
                           sample_level=sample_level, seed=seed,
                           constraint=constraint, sampler=sampler)
    return _run_tree(disp, ids, payloads, valid, augment, on_level)


def randgreedi_distributed(objective, ids, payloads, valid, k: int,
                           mesh: TreeMesh,
                           machine_axes: Optional[Sequence[str]] = None,
                           augment=None, engine: str = "auto",
                           node_engine: Optional[str] = None,
                           sample_leaf: int = 0, seed: Optional[int] = None,
                           constraint=None,
                           sampler: Optional[Sampler] = None,
                           on_level: Optional[Callable[[int], None]] = None
                           ) -> Solution:
    """RandGreedi = GreedyML with ONE accumulation level over every rank
    (gather everything to every rank, one global node greedy, no node
    sampling); ``augment``'s first row joins the node's ground.
    Otherwise as `greedyml_distributed`."""
    check_tree_axes(mesh, machine_axes)
    flat = mesh.flat()
    disp = LevelDispatcher(objective, k, flat.radices, mesh=flat,
                           engine=engine, node_engine=node_engine,
                           sample_leaf=sample_leaf, seed=seed,
                           constraint=constraint, sampler=sampler)
    return _run_tree(disp, ids, payloads, valid,
                     None if augment is None else augment[:1], on_level)
