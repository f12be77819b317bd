"""Supervised, round-resumable distributed GreedyML selection (answers
`src/repro/runtime/supervisor.py`).

The tree is driven level by level from the host through
`core/greedyml.py::LevelDispatcher` (leaves, then one dispatch a level),
and the per-lane Solution state is checkpointed through
checkpoint/manager.py after every merged level, so recovery is a
three-tier state machine:

  1. **Level replay** — a transient ``WorkerFailure`` restores the last
     merged level's checkpoint and re-dispatches the failed level (a
     failure before the first checkpoint cold-restarts from the leaves).
     A dispatch is a pure function of the checkpointed state — the
     stochastic draws come from `LaneSampler`, a fresh generator per
     (seed, stage, lane) — so the recovered run is BIT-IDENTICAL to a
     failure-free one.
  2. **Retry with backoff** — bounded by ``max_restarts`` per recovery
     episode (each checkpoint resets the budget), exponential backoff
     between attempts.
  3. **Degraded-tree recovery** — a lane that keeps failing is declared
     lost: `runtime.elastic.plan_degraded_tree` picks the largest full
     b-ary tree over the survivors, `checkpoint.reshard.reshard_solutions`
     pools their last solutions (before any merged level, their raw
     leaf pools) onto the new leaves, and the recurrence re-enters at
     level 0 of the smaller tree with exact leaves (``sample_leaf`` 0).
     Sharded leaves refuse: their lanes hold slices of one pool, not
     solutions.

Only ``WorkerFailure`` is caught. A kernel's build or launch error, or a
CUDA error, propagates: it is never retried as a lane failure and never
falls through to a plain version. A dispatch's ``wall_s`` is read after
`torch.cuda.synchronize` of the objective's device, so the straggler
monitor sees the device's time, not the launch's.

Over a `launch/mesh.py::TreeMesh` (one lane a rank, the reference's
mesh mode) every rank runs this loop in lockstep: the injector is
deterministic, so all ranks fail, replay and degrade together, and a
dispatch's wall is the slowest rank's (`world_max`), so straggler
actions agree. A checkpoint gathers every lane (k rows a lane) over the
world; world rank 0 writes, every rank waits at a barrier, and a replay
restores the same directory on every rank (one host). The degraded tree
is a subset mesh over the survivors' ranks (`make_tree_mesh(…,
ranks=)`); the other ranks hold no lane but join the checkpoints'
gathers and the root's broadcast, so `select` returns the same Solution
on every rank.

Every failure/restore/checkpoint/reshard/straggler event lands in
``events`` with the reference's kinds and keys. `run_merge` supervises
the continuous streaming driver's periodic merges: a transient failure
replays from the in-memory lane states (the merge gets a copy, so a
failed attempt cannot change them), a lost lane is reset to a copy of
``lane_init`` (a replacement worker joining cold).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from types import SimpleNamespace
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Set, Tuple)

import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager
from repro_torch.checkpoint.reshard import reshard_solutions
from repro_torch.core.greedy import Solution
from repro_torch.core.greedyml import (LevelDispatcher, check_tree_axes,
                                       empty_lane_solutions, root_solution,
                                       shard_lanes)
from repro_torch.kernels import rules as R
from repro_torch.launch.mesh import TreeMesh, make_tree_mesh
from repro_torch.runtime.elastic import plan_degraded_tree
from repro_torch.runtime.fault import WorkerFailure
from repro_torch.runtime.straggler import StragglerMonitor


class LaneFailure(WorkerFailure):
    """A WorkerFailure attributed to a lane. ``lane`` is the worker id in
    the ORIGINAL lane numbering — stable across degraded-tree re-plans,
    so the supervisor can tell "the same lane again" from fresh
    failures elsewhere."""

    def __init__(self, msg: str, lane: Optional[int] = None,
                 level: Optional[int] = None):
        super().__init__(msg)
        self.lane = lane
        self.level = level


@dataclasses.dataclass
class LaneFailureInjector:
    """Deterministic failure injection for the supervised runtime.

    ``fail_at``: (level, lane) pairs that raise ONCE when that level's
    dispatch runs — the level-replay path. ``dead``: lane → level; from
    that level on the lane fails EVERY attempt until the supervisor
    drops it — the degraded-tree path. Lanes are original worker ids; a
    lane not in the caller's ``alive`` set never fires."""

    fail_at: Tuple[Tuple[int, int], ...] = ()
    dead: Mapping[int, int] = dataclasses.field(default_factory=dict)
    _fired: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)

    def check(self, level: int, alive: Optional[Sequence[int]] = None
              ) -> None:
        live = None if alive is None else set(alive)
        for lane, frm in self.dead.items():
            if level >= frm and (live is None or lane in live):
                raise LaneFailure(f"lane {lane} is down (level {level})",
                                  lane=lane, level=level)
        for lv, lane in self.fail_at:
            key = (lv, lane)
            if (lv == level and key not in self._fired
                    and (live is None or lane in live)):
                self._fired.add(key)
                raise LaneFailure(
                    f"injected transient failure: lane {lane} at level "
                    f"{level}", lane=lane, level=level)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _copy(tree):
    """A copy of a Solution / SieveState whose tensors nothing aliases."""
    return tree.map(lambda x: x.clone())


@dataclasses.dataclass
class SelectionSupervisor:
    """Host-side supervision of level-by-level distributed selection.

    ``ckpt_every_levels``: checkpoint cadence in merged levels (the leaf
    stage and the root are always checkpointed, and a straggler action
    forces one). ``max_restarts``: retry budget per recovery episode.
    ``sleep_fn``/``clock`` are injectable for deterministic tests."""

    ckpt_dir: str
    keep: int = 3
    max_restarts: int = 3
    backoff_s: float = 0.0
    backoff_cap_s: float = 2.0
    ckpt_every_levels: int = 1
    injector: Optional[LaneFailureInjector] = None
    monitor: Optional[StragglerMonitor] = None
    sleep_fn: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.perf_counter
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    _dispatches: int = 0
    _stream_dead: Set[int] = dataclasses.field(default_factory=set)

    # ------------------------------------------------------------------ log
    def _log(self, kind: str, **kw) -> Dict[str, Any]:
        ev = {"kind": kind, "time": time.time(), **kw}
        self.events.append(ev)
        return ev

    def _backoff(self, attempt: int) -> float:
        if self.backoff_s <= 0:
            return 0.0
        delay = min(self.backoff_s * (2 ** (attempt - 1)),
                    self.backoff_cap_s)
        self.sleep_fn(delay)
        return delay

    # ------------------------------------------------------- selection runs
    def select(self, objective, ids, payloads, valid, k: int, *,
               lanes: int, branching: int = 0,
               mesh: Optional[TreeMesh] = None,
               tree_axes: Optional[Sequence[str]] = None,
               engine: str = "auto", node_engine: Optional[str] = None,
               sample_leaf: int = 0, sample_level: int = 0,
               seed: Optional[int] = None, augment=None,
               resume: bool = False,
               shard: int = 0) -> Tuple[Solution, Dict[str, Any]]:
        """Run supervised distributed GreedyML over ``lanes`` machines.

        ids/payloads/valid: the global (n, …) arrays (on every rank over a
        mesh), lane i taking contiguous block i. ``mesh``: a TreeMesh
        runs one lane a rank (``tree_axes``, if given, must be its
        levels); None runs every lane stacked on the objective's device.
        ``branching=0`` with no mesh and no ``shard`` hands the tree shape
        to the planner (`plans.plan_tree`); ``shard`` > 1 forces sharded
        leaves. ``resume=True`` restores the newest checkpoint (any tree
        epoch) and continues from the next level. Returns ``(solution,
        info)``: the recovery log, the initial and final tree shapes
        and the surviving workers."""
        tile_c = 0
        if mesh is not None:
            if not isinstance(mesh, TreeMesh):
                raise TypeError("mesh: a launch/mesh.py TreeMesh over the "
                                f"process group, or None; got {mesh!r}")
            check_tree_axes(mesh, tree_axes)
            radices, shard = mesh.radices, mesh.shard
            if mesh.lanes != lanes:
                raise ValueError(f"mesh holds {mesh.lanes} lanes, asked "
                                 f"for {lanes}")
            b = radices[0] if radices else 1
        elif branching or shard:
            shard = shard or 1
            if lanes % shard:
                raise ValueError(f"lanes ({lanes}) must divide by "
                                 f"shard ({shard})")
            m = lanes // shard
            b = branching or m
            levels = max(1, round(math.log(m, b))) if m > 1 else 0
            if b ** levels != m:
                raise ValueError(f"machines ({m}) must be "
                                 f"branching^levels (b={b})")
            radices = (b,) * levels
        else:
            # no tree given: the memory model picks branching, levels and
            # per-leaf sharding (the paper's tree-selection step)
            from repro_torch.kernels.plans import plan_tree
            rule = objective.rule
            d = None if rule.is_bitmap else payloads.shape[1]
            w = payloads.shape[1] if rule.is_bitmap else None
            tp = plan_tree(rule, ids.shape[0], d, k, lanes, words=w,
                           device=objective.device.type)
            if tp is None:
                raise ValueError(
                    f"no accumulation tree over {lanes} lanes fits the "
                    "per-device budget for this instance "
                    "(plans.plan_tree found no feasible shape)")
            radices, shard, b = tp.radices, tp.shard, tp.branching
            tile_c = tp.leaf_plan.tile_c
            self._log("plan", radices=list(radices), shard=shard,
                      peak_bytes=tp.peak_bytes,
                      leaf_engine=tp.leaf_plan.engine,
                      node_engine_plan=tp.node_plan.engine)

        run = _Run(self, objective, k, mesh, engine, node_engine,
                   sample_leaf, sample_level, seed, payloads)
        disp = run.dispatcher(radices, mesh, shard, tile_c, sample_leaf)
        il, pl, vl = run.pools(ids, payloads, valid, lanes)
        workers = list(range(lanes))
        tree0 = (lanes, b, disp.num_levels)
        epoch = 0
        state: Optional[Solution] = None
        next_stage = 0           # 0 = leaves; s ≥ 1 = accumulation level s
        restarts = 0
        aug = augment

        if resume:
            resumed = self._try_resume(run)
            if resumed is not None:
                disp, state, next_stage, workers, epoch, b = resumed

        while True:
            L = disp.num_levels
            try:
                while next_stage <= L:
                    if self.injector is not None:
                        self.injector.check(next_stage, alive=workers)
                    t0 = self.clock()
                    new_state = run.stage(disp, next_stage, state, il, pl,
                                          vl, aug)
                    _sync(objective.device)
                    wall = self.clock() - t0
                    if run.mesh is not None:
                        wall = run.mesh.world_max(wall)
                    self._dispatches += 1
                    self._log("dispatch", level=next_stage, epoch=epoch,
                              wall_s=wall)
                    preempt = False
                    if self.monitor is not None:
                        act = self.monitor.observe(self._dispatches, wall)
                        if act:
                            self._log("straggler", level=next_stage,
                                      wall_s=wall, action=act)
                            preempt = True
                    state = new_state
                    if (next_stage == 0 or next_stage == L or preempt
                            or next_stage % self.ckpt_every_levels == 0):
                        run.save(self._epoch_dir(epoch), next_stage, disp,
                                 state,
                                 extra={"stage": next_stage, "epoch": epoch,
                                        "workers": workers,
                                        "radices": list(disp.radices),
                                        "branching": b, "k": k,
                                        "shard": disp.shard,
                                        "tile_c": disp.tile_c,
                                        "preemptive": preempt})
                        self._log("checkpoint", level=next_stage,
                                  epoch=epoch, preemptive=preempt)
                        restarts = 0
                    next_stage += 1
                sol = run.root(disp, state)
                info = {"tree": tree0,
                        "final_tree": (disp.lanes, b, disp.num_levels),
                        "degraded": epoch > 0, "epochs": epoch + 1,
                        "shard": disp.shard,
                        "radices": tuple(disp.radices),
                        "workers": list(workers), "events": self.events}
                return sol, info
            except WorkerFailure as e:
                lane = getattr(e, "lane", None)
                restarts += 1
                self._log("failure", level=next_stage, epoch=epoch,
                          lane=lane, error=str(e), attempt=restarts)
                if restarts > self.max_restarts:
                    # sharded leaves have no degraded-tree story: the
                    # shard lanes of one machine hold SLICES of one pool,
                    # not poolable solutions — level replay is all there is
                    if lane is None or len(workers) <= 1 or disp.shard > 1:
                        raise
                    (disp, il, pl, vl, workers, epoch, state,
                     next_stage) = self._degrade(run, disp, state, il, pl,
                                                 vl, workers, lane, b,
                                                 epoch, next_stage)
                    if aug is not None:
                        aug = aug[:disp.num_levels]
                    restarts = 0
                    continue
                delay = self._backoff(restarts)
                state, next_stage = self._rewind(run, disp, epoch)
                self._log("restart", level=next_stage, epoch=epoch,
                          lane=lane, backoff_s=delay)

    # -------------------------------------------------------------- helpers
    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.ckpt_dir, f"tree{epoch}")

    def _rewind(self, run: "_Run", disp: LevelDispatcher, epoch: int
                ) -> Tuple[Optional[Solution], int]:
        """Restore the last merged level's checkpoint (level replay); cold
        restart from the leaf stage when no checkpoint exists yet."""
        d = self._epoch_dir(epoch)
        last = manager.latest_step(d)
        if last is None:
            self._log("cold_restart", level=0, epoch=epoch)
            return None, 0
        state, manifest = run.restore(d, disp, last)
        stage = int(manifest["extra"]["stage"])
        self._log("restore", level=stage, epoch=epoch)
        return state, stage + 1

    def _degrade(self, run: "_Run", disp, state, il, pl, vl, workers,
                 dead_lane, b, epoch, failed_stage):
        """Drop the dead lane, re-plan the tree for the shrunken radix,
        and reshard the surviving per-lane state onto the new leaves."""
        rows = [i for i, w in enumerate(workers) if w != dead_lane]
        survivors = [w for w in workers if w != dead_lane]
        if not rows:
            raise WorkerFailure("all lanes lost")
        new_lanes, new_levels = plan_degraded_tree(len(survivors), b)
        if state is not None:
            # survivors' last merged solutions become the new tree's leaves
            pool = reshard_solutions(run.stacked(disp, state), rows,
                                     new_lanes)
        else:
            # failure before any merged level: reshard the raw leaf pools
            raw = SimpleNamespace(ids=il, payloads=pl, valid=vl)
            pool = reshard_solutions(raw, rows, new_lanes)
        self._log("reshard", level=failed_stage, epoch=epoch,
                  lane=dead_lane, lanes_from=len(workers),
                  lanes_to=new_lanes, levels_to=new_levels,
                  survivors=survivors)
        kept = survivors[:new_lanes]
        new_mesh = run.degraded_mesh(new_levels, b, kept)
        new_disp = run.dispatcher((b,) * new_levels, new_mesh, 1, 0,
                                  sample_leaf=0)   # re-entry pools: exact
        il2, pl2, vl2 = run.place_pools(*pool)
        return (new_disp, il2, pl2, vl2, kept, epoch + 1, None, 0)

    def _try_resume(self, run: "_Run"):
        """The newest tree epoch with a checkpoint, its dispatcher
        rebuilt from the manifest (radices, shard, tile_c) and its state
        restored; None when there is nothing to resume."""
        if not os.path.isdir(self.ckpt_dir):
            return None
        epochs = sorted(int(n[4:]) for n in os.listdir(self.ckpt_dir)
                        if n.startswith("tree") and n[4:].isdigit()
                        and manager.latest_step(
                            os.path.join(self.ckpt_dir, n)) is not None)
        if not epochs:
            return None
        epoch = epochs[-1]
        d = self._epoch_dir(epoch)
        last = manager.latest_step(d)
        # manifest first: radices decide the example tree's lane count
        extra = manager.read_manifest(d, last)["extra"]
        radices = tuple(extra["radices"])
        shard = int(extra.get("shard", 1))
        tile_c = int(extra.get("tile_c", 0))
        workers = list(extra["workers"])
        b = int(extra["branching"])
        mesh = None
        if run.mesh0 is not None:
            mesh = (run.mesh0 if epoch == 0
                    else run.degraded_mesh(len(radices), b, workers))
        disp = run.dispatcher(radices, mesh, shard, tile_c,
                              run.sample_leaf)
        state, manifest = run.restore(d, disp, last)
        stage = int(manifest["extra"]["stage"])
        self._log("resume", level=stage, epoch=epoch)
        return disp, state, stage + 1, workers, epoch, b

    # ------------------------------------------------------ streaming merges
    def run_merge(self, merge_fn: Callable, states, merged, round_idx: int,
                  lane_init, lanes: int):
        """Supervise one periodic tree merge of the continuous streaming
        driver (streaming/driver.py::ContinuousSelector).

        ``merge_fn(states, merged)`` gets a copy of the stacked lane
        states, so whatever an attempt does to them, a replay sees the
        states the failed attempt saw. A transient failure replays the
        merge; after ``max_restarts`` failures of one lane the lane is
        declared lost — a copy of ``lane_init`` (one unstacked sieve)
        is written into its slice (a replacement worker joining cold)
        and the merge proceeds without its summary. Lane states and the
        merged solution are checkpointed after every merge. Returns
        ``(merged, states)``."""
        workers = [l for l in range(lanes) if l not in self._stream_dead]
        attempts = 0
        while True:
            try:
                if self.injector is not None:
                    self.injector.check(round_idx, alive=workers)
                t0 = self.clock()
                out = merge_fn(_copy(states), merged)
                _sync(out.ids.device)
                wall = self.clock() - t0
                self._dispatches += 1
                self._log("merge", level=round_idx, wall_s=wall)
                if self.monitor is not None:
                    act = self.monitor.observe(self._dispatches, wall)
                    if act:
                        self._log("straggler", level=round_idx,
                                  wall_s=wall, action=act)
                if self.ckpt_dir:
                    manager.save(os.path.join(self.ckpt_dir, "stream"),
                                 round_idx + 1,
                                 {"states": states, "merged": out},
                                 extra={"round": round_idx,
                                        "dead": sorted(self._stream_dead)},
                                 keep=self.keep)
                    self._log("checkpoint", level=round_idx, stream=True)
                return out, states
            except WorkerFailure as e:
                lane = getattr(e, "lane", None)
                attempts += 1
                self._log("failure", level=round_idx, lane=lane,
                          error=str(e), attempt=attempts, stream=True)
                if attempts > self.max_restarts:
                    if lane is None:
                        raise
                    # lane LOST mid-merge: a replacement joins with a cold
                    # sieve; the merge proceeds without its summary
                    self._stream_dead.add(lane)
                    workers = [l for l in workers if l != lane]
                    if not workers:
                        raise
                    states = _reset_lane(states, lane, lane_init)
                    self._log("lane_reset", level=round_idx, lane=lane)
                    attempts = 0
                    continue
                delay = self._backoff(attempts)
                self._log("restart", level=round_idx, lane=lane,
                          backoff_s=delay, stream=True)


def _reset_lane(states, lane: int, lane_init):
    """The stacked states with a copy of `lane_init` in `lane`'s slice."""
    def put(x, x0):
        if x is None:
            return None
        x = x.clone()
        x[lane] = x0
        return x
    return dataclasses.replace(states, **{
        f.name: put(getattr(states, f.name), getattr(lane_init, f.name))
        for f in dataclasses.fields(states)})


class _Run:
    """One `select` call's placement of the lanes: stacked on the
    objective's device, or one a rank over a TreeMesh (``mesh0``: the
    caller's; later epochs' subset meshes). Everything that differs
    between the two placements lives here."""

    def __init__(self, sup: SelectionSupervisor, objective, k: int, mesh,
                 engine, node_engine, sample_leaf, sample_level, seed,
                 payloads):
        self.sup, self.obj, self.k, self.mesh0 = sup, objective, k, mesh
        self.mesh = mesh
        self.engine, self.node_engine = engine, node_engine
        self.sample_leaf, self.sample_level = sample_leaf, sample_level
        self.seed = seed
        bitmap = objective.rule.is_bitmap
        tail = tuple(payloads.shape[1:])
        dtype = (R.WORD_DTYPE if bitmap
                 else torch.as_tensor(payloads[:1]).dtype)
        self.pay_example = torch.zeros((1,) + tail, dtype=dtype,
                                       device=objective.device)

    # -- placement --------------------------------------------------------
    def pools(self, ids, payloads, valid, lanes: int):
        """The stacked (lanes, n/lanes, …) leaf pools: on the objective's
        device stacked; left where they are over a mesh (each rank moves
        its own block)."""
        pay = (R.to_words(payloads) if self.obj.rule.is_bitmap
               else torch.as_tensor(payloads))
        ids = torch.as_tensor(ids).to(torch.int64)
        valid = torch.as_tensor(valid).to(torch.bool)
        if self.mesh is None:
            dev = self.obj.device
            ids, pay, valid = ids.to(dev), pay.to(dev), valid.to(dev)
        return shard_lanes(ids, pay, valid, lanes)

    def place_pools(self, ids, pay, valid):
        """reshard_solutions' host pools, placed as `pools` places."""
        dev = self.obj.device if self.mesh is None else torch.device("cpu")
        return (torch.from_numpy(ids).to(dev), torch.from_numpy(pay).to(dev),
                torch.from_numpy(valid).to(dev))

    def dispatcher(self, radices, mesh, shard, tile_c, sample_leaf):
        self.mesh = mesh
        return LevelDispatcher(self.obj, self.k, tuple(radices), mesh=mesh,
                               engine=self.engine,
                               node_engine=self.node_engine,
                               sample_leaf=sample_leaf,
                               sample_level=self.sample_level,
                               seed=self.seed, shard=shard, tile_c=tile_c)

    def degraded_mesh(self, levels: int, b: int, workers: Sequence[int]):
        """The subset mesh of a degraded tree over the kept workers'
        ranks (every rank builds it, in one order); None stacked."""
        if self.mesh0 is None:
            return None
        m0 = self.mesh0
        return make_tree_mesh((b,) * levels, axis_prefix="deg",
                              device=None if m0.backend == "nccl"
                              else m0.device,
                              ranks=[m0.ranks[w] for w in workers])

    def _placeholder(self) -> Solution:
        return empty_lane_solutions(1, self.k, self.pay_example)

    # -- stages -----------------------------------------------------------
    def stage(self, disp: LevelDispatcher, stage: int, state, il, pl, vl,
              aug):
        """One dispatch: the leaves (stage 0) or level stage − 1, over
        every stacked lane or this rank's (a rank outside a subset mesh
        holds a placeholder)."""
        mesh = disp.mesh
        if mesh is not None and not mesh.member:
            return self._placeholder()
        if stage == 0:
            if mesh is not None:
                one = slice(mesh.lane, mesh.lane + 1)
                il, pl, vl = il[one], pl[one], vl[one]
            return disp.leaves(il, pl, vl)
        lvl = stage - 1
        return disp.level(state, lvl, aug[lvl] if aug is not None else None)

    def stacked(self, disp: LevelDispatcher, state: Solution) -> Solution:
        """Every lane's state stacked (lanes, …): the state itself, or
        gathered over the world from the ranks."""
        if disp.mesh is None:
            return state
        return state.map(disp.mesh.gather_lanes)

    def root(self, disp: LevelDispatcher, state: Solution) -> Solution:
        return root_solution(state, disp.mesh)

    # -- checkpoints ------------------------------------------------------
    def save(self, d: str, stage: int, disp, state, extra) -> None:
        full = self.stacked(disp, state)
        if disp.mesh is None or dist.get_rank() == 0:
            manager.save(d, stage, full, extra=extra, keep=self.sup.keep)
        if disp.mesh is not None:
            dist.barrier()

    def restore(self, d: str, disp, step: int):
        """The checkpointed stacked state (on the objective's device), or
        over a mesh this rank's lane of it."""
        example = empty_lane_solutions(disp.lanes, self.k, self.pay_example)
        state, manifest = manager.restore(d, example, step=step)
        mesh = disp.mesh
        if mesh is not None:
            state = (state.map(lambda x: x[mesh.lane:mesh.lane + 1])
                     if mesh.member else self._placeholder())
        return state, manifest
