"""Streaming selection drivers (answers `src/repro/streaming/driver.py`).

Entry points over an arrival stream (any iterable of ``(ids, payloads,
valid)`` batches — data/synthetic.py's `Stream` is the deterministic
source), on the objective's device:

  * ``stream_select`` — one sieve over the whole stream; one
    stream-filter launch per batch.
  * ``ContinuousSelector`` / ``stream_select_continuous`` — the
    continuous mode on one device: `lanes` sieves, each over its share of
    every batch (one launch per batch for all lanes), merged every
    `merge_every` batches through the GreedyML accumulation tree
    (sieve-as-leaf-solver: each node greedy runs on the union of its
    children's summaries plus the fixed evaluation set, argmax{f(S),
    f(S_prev)}), then select_better'd against the last merged solution,
    so the answer only improves between merges.

The merge runs core/greedyml.py::accumulate_one_level level by level
over the stacked lanes — the reference's `accumulate_levels` under
nested vmap — with the evaluation set as each level's augmentation, then
replays the carried solution on the root's ground, as
`accumulate_levels` does with `carry_prev`; lane 0 holds the root.

Not ported: checkpoint/resume (``ckpt_dir``, ``resume``) and the
supervised merge (``supervisor``) need checkpoint/manager.py and
runtime/supervisor.py (ROADMAP item 7) and raise NotImplementedError;
``stream_select_distributed`` needs a device mesh (ROADMAP item 3).
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import torch

from repro_torch.core.greedy import Solution, replay_value, select_better
from repro_torch.core.greedyml import LaneSampler, accumulate_one_level
from repro_torch.streaming.sieve import SieveStreamer

ITEM_7 = ("checkpoint/resume and the supervised merge wait for "
          "checkpoint/manager.py and runtime/supervisor.py: ROADMAP item 7")


def stream_select(objective, stream: Iterable, k: int, *, eps: float = 0.1,
                  ground=None, ground_valid=None,
                  ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                  resume: bool = False) -> Solution:
    """Run the sieve over the whole stream; returns the best level's
    solution. ``ckpt_dir``/``resume`` are not ported (ROADMAP item 7)."""
    if ckpt_dir or ckpt_every or resume:
        raise NotImplementedError(ITEM_7)
    streamer = SieveStreamer(objective, k, eps, ground=ground,
                             ground_valid=ground_valid)
    state = None
    for ids, pay, valid in stream:
        if state is None:
            state = streamer.init(pay)
        state = streamer.process_batch(state, ids, pay, valid)
    if state is None:
        raise ValueError("empty stream")
    return streamer.solution(state)


class ContinuousSelector:
    """Push-driven core of the continuous mode: `lanes` stacked sieves +
    periodic GreedyML tree merges. push(ids, payloads, valid) folds one
    batch, split equally over the lanes (lane i takes the i-th block),
    into all lanes in one stream-filter launch and merges every
    `merge_every` pushes; result() returns the current merged Solution,
    merging any unmerged tail first. ``lanes`` must be branching^levels;
    ``sample_level``/``seed``: stochastic greedy at the merge nodes, with
    draws from core/greedyml.LaneSampler (torch cannot reproduce the
    reference's PRNG stream)."""

    def __init__(self, objective, k: int, *, lanes: int = 4,
                 branching: int = 0, merge_every: int = 4,
                 eps: float = 0.1, ground=None, ground_valid=None,
                 node_engine: str = "auto", sample_level: int = 0,
                 seed: Optional[int] = None, supervisor=None):
        if supervisor is not None:
            raise NotImplementedError(ITEM_7)
        self.objective, self.k = objective, k
        self.lanes, self.merge_every = lanes, merge_every
        self.node_engine, self.sample_level = node_engine, sample_level
        self.sampler = LaneSampler(0 if seed is None else seed)
        self.streamer = SieveStreamer(objective, k, eps, ground=ground,
                                      ground_valid=ground_valid)
        b = branching or lanes
        levels = max(1, round(math.log(lanes, b))) if lanes > 1 else 0
        if b ** levels != lanes:
            raise ValueError(f"lanes ({lanes}) must be branching^levels "
                             f"(b={b})")
        self.branching, self.levels = b, levels
        self.radices = (b,) * levels
        self.states: Optional[object] = None
        self.merged: Optional[Solution] = None
        self.merges, self.batches = [], 0
        self.tier = None
        self._dirty = False

    def _merge_round(self, states, merged: Optional[Solution]) -> Solution:
        obj, k = self.objective, self.k
        sols = self.streamer.solution(states)             # (lanes, …)
        ground, gvalid = sols.payloads, sols.valid
        for lvl in range(self.levels):
            n = self.radices[lvl] * k
            draws = (self.sampler(1 + lvl, self.lanes, k, n,
                                  self.sample_level)
                     if 0 < self.sample_level < n else None)
            sols, ground, gvalid = accumulate_one_level(
                obj, sols, k, self.radices, lvl, aug=self.streamer.ground,
                cand_idx=draws, sample=self.sample_level,
                node_engine=self.node_engine)
        root = sols.map(lambda x: x[:1])
        if merged is not None:
            carry = merged.map(lambda x: x.unsqueeze(0))
            score = replay_value(obj, carry.payloads, carry.valid,
                                 ground[:1], gvalid[:1])
            root = select_better(root, Solution(carry.ids, carry.payloads,
                                                carry.valid, score,
                                                carry.evals))
        return root.map(lambda x: x[0])

    def push(self, ids, payloads, valid) -> "ContinuousSelector":
        """Fold one arrival batch (split equally over the lanes) into the
        lane sieves; merges fire every `merge_every` pushes."""
        nb = int(ids.shape[0])
        if nb % self.lanes:
            raise ValueError(f"batch {nb} must split over {self.lanes} "
                             "lanes")
        shp = (self.lanes, nb // self.lanes)
        pay = torch.as_tensor(payloads)
        if self.states is None:
            self.states = self.streamer.init(pay, lanes=self.lanes)
            self.tier = self.streamer.plan(shp[1])["tier"]
        self.states = self.streamer.process_batch(
            self.states, torch.as_tensor(ids).reshape(shp),
            pay.reshape(shp + pay.shape[1:]),
            torch.as_tensor(valid).reshape(shp))
        self.batches += 1
        self._dirty = True
        if self.batches % self.merge_every == 0:
            self.merge()
        return self

    def merge(self) -> Solution:
        """One accumulation-tree merge round over the lane states."""
        self.merged = self._merge_round(self.states, self.merged)
        self.merges.append(float(self.merged.value))
        self._dirty = False
        return self.merged

    def result(self) -> Solution:
        """The stream's current answer: the last merged Solution, after
        merging any pushes since the last merge round."""
        if self.states is None:
            raise ValueError("empty stream")
        if self.merged is None or self._dirty:
            self.merge()
        return self.merged

    def info(self) -> dict:
        return {"merges": self.merges, "batches": self.batches,
                "tree": (self.lanes, self.branching, self.levels),
                "tier": self.tier}


def stream_select_continuous(objective, stream: Iterable, k: int, *,
                             lanes: int = 4, branching: int = 0,
                             merge_every: int = 4, eps: float = 0.1,
                             ground=None, ground_valid=None,
                             node_engine: str = "auto",
                             sample_level: int = 0,
                             seed: Optional[int] = None, supervisor=None
                             ) -> Tuple[Solution, dict]:
    """Continuous mode with `lanes` stacked lanes (the single-device
    simulation of the mesh): a loop over `ContinuousSelector`. Returns
    the final merged Solution and an info dict with the merged-value
    trajectory (``merges``), the batch count and the tree, and the
    stream filter's tier ('kernel' or 'global', plans.stream_tier).
    ``supervisor`` is not ported (ROADMAP item
    7)."""
    sel = ContinuousSelector(objective, k, lanes=lanes,
                             branching=branching, merge_every=merge_every,
                             eps=eps, ground=ground,
                             ground_valid=ground_valid,
                             node_engine=node_engine,
                             sample_level=sample_level, seed=seed,
                             supervisor=supervisor)
    for ids, pay, valid in stream:
        sel.push(ids, pay, valid)
    return sel.result(), sel.info()


def stream_select_distributed(*args, **kwargs):
    """The continuous mode over a real device mesh: not ported (ROADMAP
    item 3, distributed GreedyML over torch.distributed)."""
    raise NotImplementedError(
        "stream_select_distributed needs a device mesh: ROADMAP item 3")
