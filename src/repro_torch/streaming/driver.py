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
  * ``stream_select_distributed`` — the same continuous mode over the
    ranks of a process group (``ContinuousSelector(mesh=`` a
    launch/mesh.py::TreeMesh ``)``): each rank sieves its contiguous
    share of every batch, and the merges gather over the ranks' level
    subgroups.

Every merge goes through core/greedyml.py::accumulate_levels (the
stacked lanes, or this rank's lane over the mesh) with the evaluation
set as each level's augmentation and the last merged solution as
``carry_prev``; the answer is machine 0's solution.

Fault tolerance: `stream_select(ckpt_dir=…, ckpt_every=…, resume=…)`
saves the sieve state through checkpoint/manager.py (a host copy: the
state is consumed in place by every batch) and resumes bit-exactly by
skipping the consumed prefix of the same deterministic stream;
``supervisor=`` (a runtime/supervisor.py::SelectionSupervisor) runs
every merge of the stacked continuous mode under
`SelectionSupervisor.run_merge`.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import manager
from repro_torch.core.greedy import Solution
from repro_torch.core.greedyml import (LaneSampler, accumulate_levels,
                                       check_tree_axes, root_solution)
from repro_torch.launch.mesh import TreeMesh
from repro_torch.streaming.sieve import SieveStreamer

def stream_select(objective, stream: Iterable, k: int, *, eps: float = 0.1,
                  ground=None, ground_valid=None,
                  ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                  resume: bool = False) -> Solution:
    """Run the sieve over the whole stream; returns the best level's
    solution. With ``ckpt_dir`` the sieve state is saved every
    ``ckpt_every`` batches and at the end (``extra={"batches": done}``);
    ``resume=True`` restores the latest checkpoint into an empty sieve
    built without a batch (so a one-shot iterator loses nothing) and
    skips the already-consumed prefix of the same stream."""
    streamer = SieveStreamer(objective, k, eps, ground=ground,
                             ground_valid=ground_valid)
    state, done = None, 0
    if resume and ckpt_dir and manager.latest_step(ckpt_dir) is not None:
        state, manifest = manager.restore(ckpt_dir, streamer.init())
        done = int(manifest["extra"]["batches"])
    for i, (ids, pay, valid) in enumerate(stream):
        if i < done:
            continue
        if state is None:
            state = streamer.init(pay)
        state = streamer.process_batch(state, ids, pay, valid)
        done = i + 1
        if ckpt_dir and ckpt_every and done % ckpt_every == 0:
            manager.save(ckpt_dir, done, state, extra={"batches": done})
    if state is None:
        raise ValueError("empty stream")
    if ckpt_dir:
        manager.save(ckpt_dir, done, state, extra={"batches": done})
    return streamer.solution(state)


class ContinuousSelector:
    """Push-driven core of the continuous mode: lane sieves + periodic
    GreedyML tree merges. push(ids, payloads, valid) folds one batch,
    split equally over the lanes (lane i takes the i-th block), into the
    lane sieves in one stream-filter launch and merges every
    `merge_every` pushes; result() returns the current merged Solution,
    merging any unmerged tail first. ``mesh``: None keeps `lanes`
    stacked sieves on one device (``lanes`` must be branching^levels);
    a launch/mesh.py::TreeMesh gives this rank its own lane (lane =
    rank, the mesh's tree; `lanes` and `branching` are ignored) and
    merges over the ranks. ``sample_level``/``seed``: stochastic greedy
    at the merge nodes, with draws from core/greedyml.LaneSampler (torch
    cannot reproduce the reference's PRNG stream). ``supervisor``: a
    runtime/supervisor.py::SelectionSupervisor running every merge of
    the stacked lanes (not over a mesh); info() then carries its
    events."""

    def __init__(self, objective, k: int, *, lanes: int = 4,
                 branching: int = 0, merge_every: int = 4,
                 eps: float = 0.1, ground=None, ground_valid=None,
                 node_engine: str = "auto", sample_level: int = 0,
                 seed: Optional[int] = None, supervisor=None,
                 mesh: Optional[TreeMesh] = None):
        if supervisor is not None and mesh is not None:
            raise ValueError("the supervised merge runs the stacked lanes; "
                             "over a mesh every rank holds one")
        if mesh is not None and not isinstance(mesh, TreeMesh):
            raise TypeError("mesh: a launch/mesh.py TreeMesh over the "
                            f"process group, or None; got {mesh!r}")
        if mesh is None:
            b = branching or lanes
            levels = max(1, round(math.log(lanes, b))) if lanes > 1 else 0
            if b ** levels != lanes:
                raise ValueError(f"lanes ({lanes}) must be "
                                 f"branching^levels (b={b})")
            self.radices = (b,) * levels
        else:
            lanes, self.radices = mesh.lanes, mesh.radices
            b, levels = self.radices[0], len(self.radices)
        self.objective, self.k, self.mesh = objective, k, mesh
        self.lanes, self.merge_every = lanes, merge_every
        self.branching, self.levels = b, levels
        self.node_engine, self.sample_level = node_engine, sample_level
        self.sampler = LaneSampler(0 if seed is None else seed)
        self.streamer = SieveStreamer(objective, k, eps, ground=ground,
                                      ground_valid=ground_valid)
        self.supervisor = supervisor
        self.states: Optional[object] = None
        self._base = None            # one cold sieve: a lost lane's reset
        self.merged: Optional[Solution] = None
        self.merges, self.batches = [], 0
        self.tier = None
        self._dirty = False

    def _merge_round(self, states, merged: Optional[Solution]) -> Solution:
        """The lanes' sieve summaries up the accumulation tree (the
        evaluation set each level's augmentation), the last merged
        solution carried; machine 0's answer (on every rank over a
        mesh)."""
        st = self.streamer
        sols = st.solution(states)                     # (lanes | 1, …)
        aug = None if st.ground is None else [st.ground] * self.levels
        out = accumulate_levels(self.objective, sols, self.k, self.radices,
                                aug_levels=aug,
                                sample_level=self.sample_level,
                                node_engine=self.node_engine,
                                carry_prev=merged, sampler=self.sampler,
                                mesh=self.mesh)
        return root_solution(out, self.mesh)

    def push(self, ids, payloads, valid) -> "ContinuousSelector":
        """Fold one arrival batch (split equally over the lanes) into the
        lane sieves; merges fire every `merge_every` pushes."""
        nb = int(ids.shape[0])
        if nb % self.lanes:
            raise ValueError(f"batch {nb} must split over {self.lanes} "
                             "lanes")
        shp = (self.lanes, nb // self.lanes)
        mine = (slice(None) if self.mesh is None
                else slice(self.mesh.lane, self.mesh.lane + 1))
        pay = torch.as_tensor(payloads)
        if self.states is None:
            self.states = self.streamer.init(
                pay, lanes=self.lanes if self.mesh is None else 1)
            if self.supervisor is not None:
                self._base = self.streamer.init(pay)
            self.tier = self.streamer.plan(shp[1])["tier"]
        self.states = self.streamer.process_batch(
            self.states, torch.as_tensor(ids).reshape(shp)[mine],
            pay.reshape(shp + pay.shape[1:])[mine],
            torch.as_tensor(valid).reshape(shp)[mine])
        self.batches += 1
        self._dirty = True
        if self.batches % self.merge_every == 0:
            self.merge()
        return self

    def merge(self) -> Solution:
        """One accumulation-tree merge round over the lane states
        (supervised when a supervisor is attached)."""
        if self.supervisor is not None:
            self.merged, self.states = self.supervisor.run_merge(
                self._merge_round, self.states, self.merged,
                len(self.merges), self._base, self.lanes)
        else:
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
        d = {"merges": self.merges, "batches": self.batches,
             "tree": (self.lanes, self.branching, self.levels),
             "tier": self.tier}
        if self.supervisor is not None:
            d["events"] = list(self.supervisor.events)
        return d


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
    ``supervisor``: a runtime/supervisor.py::SelectionSupervisor; every
    merge then runs under `run_merge` (a transient failure replays the
    merge, a lost lane's sieve is reset cold, lane states and the merged
    solution are checkpointed after each merge), and the info dict
    carries its ``events``."""
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


def stream_select_distributed(objective, stream: Iterable, k: int,
                              mesh: TreeMesh,
                              tree_axes: Optional[Sequence[str]] = None, *,
                              merge_every: int = 4, eps: float = 0.1,
                              ground=None, ground_valid=None,
                              node_engine: str = "auto",
                              sample_level: int = 0,
                              seed: Optional[int] = None
                              ) -> Tuple[Solution, dict]:
    """The continuous mode over the ranks of `mesh`, one lane a rank: a
    loop over `ContinuousSelector(mesh=mesh)`. Every rank iterates the
    whole stream and sieves its contiguous share of each batch (batch %
    lanes == 0); every `merge_every` batches (and once more for a tail)
    the lanes' summaries merge over the ranks. Merge for merge it equals
    `stream_select_continuous` with the same lanes and branching.
    ``tree_axes``, if given, must be the mesh's levels innermost first.
    Returns (merged Solution, the same on every rank, {"merges",
    "batches", "lanes"})."""
    if not isinstance(mesh, TreeMesh):
        raise TypeError("stream_select_distributed runs over a "
                        "launch/mesh.py TreeMesh (the process group's "
                        f"ranks); got {mesh!r}")
    check_tree_axes(mesh, tree_axes)
    sel = ContinuousSelector(objective, k, merge_every=merge_every,
                             eps=eps, ground=ground,
                             ground_valid=ground_valid,
                             node_engine=node_engine,
                             sample_level=sample_level, seed=seed, mesh=mesh)
    for ids, pay, valid in stream:
        sel.push(ids, pay, valid)
    return sel.result(), {"merges": sel.merges, "batches": sel.batches,
                          "lanes": sel.lanes}
