"""Fault tolerance of the port against the reference, on the CPU:
failure injection, the step supervisor, straggler detection, and the
supervised level-by-level selection runtime (`runtime/supervisor.py`) —
level replay, cold restart, degraded-tree recovery, resume, the planned
tree, sharded leaves refusing to degrade, the supervised streaming
merges — each on the same numpy inputs as the reference's test
(tests/test_fault_tolerance.py, tests/test_shard_scale.py:188-250), with
the reference on its `ref` backend.

The data are kcover bitmaps and small-integer facility features, so
every selection and value must be EQUAL (tolerance 0), and the recovery
logs must hold the same event kinds at the same levels. Beyond the
reference's tests: the merge gets a copy of the lane states (a merge that
scribbles on its inputs before failing replays from what the failed
attempt saw), a lost lane is reset to a copy of lane_init, a stochastic
tree replays bit for bit (the D1 guard: `LaneSampler`'s draws are a pure
function of (seed, stage, lane)), the same supervised runs over 4
spawned gloo ranks — replay, resume, and a degrade onto a 2-rank subset
mesh — equal the stacked runs, and `faultrun --smoke` passes.

The spawned ranks import this module: it imports no JAX at its top.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.greedy import greedy as t_greedy
from repro_torch.core.greedyml import (LevelDispatcher, root_solution,
                                       shard_lanes)
from repro_torch.data import synthetic as TSyn
from repro_torch.launch import faultrun
from repro_torch.launch.mesh import make_machine_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.runtime.fault import FailureInjector, Supervisor, \
    WorkerFailure
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.supervisor import (LaneFailure,
                                            LaneFailureInjector,
                                            SelectionSupervisor)
from repro_torch.streaming import (ContinuousSelector,
                                   stream_select_continuous)

K = 8
BUDGETS = ("REPRO_FUSED_CACHE_MB", "REPRO_TORCH_FUSED_CACHE_MB")
SPAWN_DEADLINE = 240.0


def _cover(n=256, universe=512, seed=2):
    sets = TSyn.gen_kcover(n, universe, seed=seed)
    return np.arange(n), TSyn.pack_bitmaps(sets, universe), np.ones(n, bool)


def _facility_int(n=512, d=16, seed=1):
    x = np.random.default_rng(seed + 50).integers(-3, 4, (n, d))
    return np.arange(n), x.astype(np.float32), np.ones(n, bool)


def _kinds(events):
    return [(e["kind"], e.get("level")) for e in events]


def _j_injector(spec):
    from repro.runtime.supervisor import LaneFailureInjector as J
    return None if spec is None else J(**spec)


def _t_injector(spec):
    return None if spec is None else LaneFailureInjector(**spec)


def _reference(tmp_path, sub, data, spec=None, max_restarts=3, lanes=8,
               name="kcover", universe=512, **kw):
    import jax.numpy as jnp
    from repro.core.functions import make_objective
    from repro.runtime.supervisor import SelectionSupervisor as J
    ids, pay, valid = data
    obj = (make_objective(name, universe=universe, backend="ref")
           if name == "kcover" else make_objective(name, backend="ref"))
    sup = J(ckpt_dir=str(tmp_path / ("j" + sub)),
            injector=_j_injector(spec), max_restarts=max_restarts)
    return sup.select(obj, jnp.asarray(ids, jnp.int32), jnp.asarray(pay),
                      jnp.asarray(valid), K, lanes=lanes, **kw)


def _port(tmp_path, sub, data, spec=None, max_restarts=3, lanes=8,
          name="kcover", universe=512, **kw):
    ids, pay, valid = data
    obj = (t_make(name, universe=universe, device="cpu")
           if name == "kcover" else t_make(name, device="cpu"))
    sup = SelectionSupervisor(ckpt_dir=str(tmp_path / ("t" + sub)),
                              injector=_t_injector(spec),
                              max_restarts=max_restarts)
    sol, info = sup.select(obj, ids, pay, valid, K, lanes=lanes, **kw)
    return sol, info


def _equal(jsol, tsol):
    np.testing.assert_array_equal(tsol.ids.numpy(), np.asarray(jsol.ids))
    np.testing.assert_array_equal(tsol.valid.numpy(),
                                  np.asarray(jsol.valid))
    assert float(tsol.value) == float(jsol.value)


# ---------------------------------------------------------------------------
# injectors
# ---------------------------------------------------------------------------


def test_failure_injector_fires_once_per_step():
    inj = FailureInjector((3, 5))
    inj.check(2)
    with pytest.raises(WorkerFailure):
        inj.check(3)
    inj.check(3)
    with pytest.raises(WorkerFailure):
        inj.check(5)


def test_lane_failure_injector_transient_vs_dead():
    inj = LaneFailureInjector(fail_at=((1, 2),), dead={0: 3})
    inj.check(0, alive=[0, 1, 2, 3])
    with pytest.raises(LaneFailure) as ei:
        inj.check(1, alive=[0, 1, 2, 3])
    assert ei.value.lane == 2 and ei.value.level == 1
    assert isinstance(ei.value, WorkerFailure)
    inj.check(1, alive=[0, 1, 2, 3])
    for _ in range(3):
        with pytest.raises(LaneFailure) as ei:
            inj.check(3, alive=[0, 1, 2, 3])
        assert ei.value.lane == 0
    inj.check(3, alive=[1, 2, 3])


# ---------------------------------------------------------------------------
# the step supervisor (runtime/fault.py), logs equal to the reference's
# ---------------------------------------------------------------------------


def _count_step(state, step):
    return {"x": state["x"] + 1}, {"loss": 1.0}


def _j_run(tmp_path, sub, steps, **kw):
    import jax.numpy as jnp
    from repro.runtime.fault import FailureInjector as JFI
    from repro.runtime.fault import Supervisor as JSup
    inj = kw.pop("fail", None)
    sup = JSup(ckpt_dir=str(tmp_path / sub),
               injector=None if inj is None else JFI(inj), **kw)
    out, final = sup.run({"x": jnp.zeros(())},
                         lambda s, i: ({"x": s["x"] + 1}, {"loss": 1.0}),
                         steps)
    return float(out["x"]), final, sup.events


def _t_run(tmp_path, sub, steps, **kw):
    inj = kw.pop("fail", None)
    sup = Supervisor(ckpt_dir=str(tmp_path / sub),
                     injector=None if inj is None else FailureInjector(inj),
                     **kw)
    out, final = sup.run({"x": torch.zeros(())}, _count_step, steps)
    return float(out["x"]), final, sup.events


def _log(events):
    return [(e["kind"], e["step"]) for e in events]


@pytest.mark.parametrize("steps,kw", [
    (17, dict(ckpt_every=5, keep=100)),
    (20, dict(ckpt_every=4, fail=(6, 13))),
    (20, dict(ckpt_every=5, fail=(6, 12, 18), max_restarts=2)),
])
def test_step_supervisor_matches_reference(tmp_path, steps, kw):
    x, final, ev = _t_run(tmp_path, "t", steps, **dict(kw))
    jx, jfinal, jev = _j_run(tmp_path, "j", steps, **dict(kw))
    assert (x, final) == (jx, jfinal) == (float(steps), steps)
    assert _log(ev) == _log(jev)
    if "keep" in kw:
        assert manager.list_steps(str(tmp_path / "t")) == [5, 10, 15, 17]


def test_supervisor_max_restarts_exceeded_raises(tmp_path):
    class AlwaysDown:
        def check(self, step):
            if step == 7:
                raise WorkerFailure("node 7 is gone")

    sup = Supervisor(ckpt_dir=str(tmp_path / "ck"), ckpt_every=5,
                     injector=AlwaysDown(), max_restarts=2)
    with pytest.raises(WorkerFailure):
        sup.run({"x": torch.zeros(())}, _count_step, 20)
    assert sum(e["kind"] == "failure" for e in sup.events) == 3


def test_supervisor_propagates_anything_but_a_worker_failure(tmp_path):
    """A kernel's build or launch error is never retried."""
    def broken(state, step):
        raise RuntimeError("kernel launch failed")

    sup = Supervisor(ckpt_dir=str(tmp_path / "ck"), ckpt_every=5)
    with pytest.raises(RuntimeError, match="launch"):
        sup.run({"x": torch.zeros(())}, broken, 3)
    assert sup.events == []


def test_straggler_threshold_and_patience():
    from repro.runtime.straggler import StragglerMonitor as J
    trace = ([1.0 + 0.3 * (s % 2) for s in range(20)] + [5.0, 5.0]
             + [1.0] * 8 + [6.0] * 3)
    mon, jmon = StragglerMonitor(window=10, threshold=2.0, patience=3), \
        J(window=10, threshold=2.0, patience=3)
    got = [mon.observe(s, t) for s, t in enumerate(trace)]
    assert got == [jmon.observe(s, t) for s, t in enumerate(trace)]
    assert got[-1] == "exclude_on_next_reshard" and got.count(None) == 32
    assert mon.actions == jmon.actions


# ---------------------------------------------------------------------------
# the supervised selection runtime, against the reference
# ---------------------------------------------------------------------------

SELECT_CASES = {
    "clean": dict(n=256),
    "replay": dict(n=256, spec=dict(fail_at=((2, 5),))),
    "leaf_cold_restart": dict(n=256, spec=dict(fail_at=((0, 3),))),
    "degraded": dict(n=512, spec=dict(dead={7: 1}), max_restarts=1),
    "dead_at_leaves": dict(n=256, spec=dict(dead={0: 0}), max_restarts=1),
    "schema": dict(n=512, spec=dict(fail_at=((1, 2),), dead={7: 2}),
                   max_restarts=1),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_supervised_selection_matches_reference(tmp_path, case):
    c = dict(SELECT_CASES[case])
    data = _cover(n=c.pop("n"))
    jsol, jinfo = _reference(tmp_path, case, data, branching=2, **c)
    tsol, tinfo = _port(tmp_path, case, data, branching=2, **c)
    _equal(jsol, tsol)
    assert _kinds(tinfo["events"]) == _kinds(jinfo["events"])
    for key in ("tree", "final_tree", "degraded", "epochs", "workers",
                "shard", "radices"):
        assert tinfo[key] == jinfo[key], key
    kinds = [e["kind"] for e in tinfo["events"]]
    if case == "replay":
        clean, _ = _port(tmp_path, "c", data, branching=2)
        assert torch.equal(tsol.ids, clean.ids)
        assert float(tsol.value) == float(clean.value)
        assert "failure" in kinds and "restore" in kinds
        assert "reshard" not in kinds
    if case == "leaf_cold_restart":
        assert "cold_restart" in kinds
    if case == "degraded":
        clean, _ = _port(tmp_path, "c", data, branching=2)
        assert tinfo["final_tree"] == (4, 2, 2) and 7 not in tinfo["workers"]
        assert float(tsol.value) / float(clean.value) >= 0.95
        (reshard,) = [e for e in tinfo["events"] if e["kind"] == "reshard"]
        assert reshard["survivors"] == [w for w in range(8) if w != 7]
        assert (reshard["lanes_from"], reshard["lanes_to"]) == (8, 4)
    if case == "dead_at_leaves":
        assert tinfo["degraded"] and int(tsol.valid.sum()) == K
    if case == "schema":
        for ev, jev in zip(tinfo["events"], jinfo["events"]):
            assert set(ev) == set(jev), ev["kind"]
        json.dumps(tinfo["events"])


def test_supervised_matches_unsupervised_dispatch(tmp_path):
    ids, pay, valid = _cover()
    obj = t_make("kcover", universe=512, device="cpu")
    disp = LevelDispatcher(obj, K, (2, 2, 2))
    state = disp.leaves(*shard_lanes(torch.as_tensor(ids),
                                     torch.as_tensor(pay.view(np.int32)),
                                     torch.as_tensor(valid), 8))
    for lvl in range(disp.num_levels):
        state = disp.level(state, lvl)
    ref = root_solution(state)
    sol, info = _port(tmp_path, "s", (ids, pay, valid), branching=2)
    assert torch.equal(sol.ids, ref.ids) and torch.equal(sol.valid,
                                                         ref.valid)
    assert float(sol.value) == float(ref.value)
    assert not info["degraded"] and info["tree"] == (8, 2, 3)


class _Anon:
    def check(self, level, alive=None):
        if level == 2:
            raise WorkerFailure("whole-fabric outage")


def test_supervised_resume_from_checkpoint(tmp_path):
    import jax.numpy as jnp
    from repro.core.functions import make_objective
    from repro.runtime.supervisor import SelectionSupervisor as J
    ids, pay, valid = _cover()
    clean, _ = _port(tmp_path, "c", (ids, pay, valid), branching=2)
    obj = t_make("kcover", universe=512, device="cpu")
    d = str(tmp_path / "resume")
    sup = SelectionSupervisor(ckpt_dir=d, injector=_Anon(), max_restarts=1)
    with pytest.raises(WorkerFailure):
        sup.select(obj, ids, pay, valid, K, lanes=8, branching=2)
    sup2 = SelectionSupervisor(ckpt_dir=d)
    sol, info = sup2.select(obj, ids, pay, valid, K, lanes=8, branching=2,
                            resume=True)
    assert torch.equal(sol.ids, clean.ids)
    # the reference resumes the same way from its own checkpoints
    jobj = make_objective("kcover", universe=512, backend="ref")
    jd = str(tmp_path / "jresume")
    jargs = (jobj, jnp.asarray(ids, jnp.int32), jnp.asarray(pay),
             jnp.asarray(valid), K)
    with pytest.raises(WorkerFailure):
        J(ckpt_dir=jd, injector=_Anon(), max_restarts=1).select(
            *jargs, lanes=8, branching=2)
    jsol, jinfo = J(ckpt_dir=jd).select(*jargs, lanes=8, branching=2,
                                        resume=True)
    _equal(jsol, sol)
    assert _kinds(info["events"]) == _kinds(jinfo["events"])
    assert info["events"][0]["kind"] == "resume"


def test_resume_crosses_packages(tmp_path):
    """The reference's level checkpoints resume in the port: the same
    layout, keys and manifest."""
    import jax.numpy as jnp
    from repro.core.functions import make_objective
    from repro.runtime.supervisor import SelectionSupervisor as J
    ids, pay, valid = _cover()
    clean, _ = _port(tmp_path, "c", (ids, pay, valid), branching=2)
    d = str(tmp_path / "x")
    jobj = make_objective("kcover", universe=512, backend="ref")
    with pytest.raises(WorkerFailure):
        J(ckpt_dir=d, injector=_Anon(), max_restarts=1).select(
            jobj, jnp.asarray(ids, jnp.int32), jnp.asarray(pay),
            jnp.asarray(valid), K, lanes=8, branching=2)
    obj = t_make("kcover", universe=512, device="cpu")
    sol, info = SelectionSupervisor(ckpt_dir=d).select(
        obj, ids, pay, valid, K, lanes=8, branching=2, resume=True)
    assert info["events"][0] == {**info["events"][0], "kind": "resume",
                                 "level": 1, "epoch": 0}
    assert torch.equal(sol.ids, clean.ids)


def test_straggler_triggers_preemptive_checkpoint(tmp_path):
    import jax.numpy as jnp
    from repro.core.functions import make_objective
    from repro.runtime.straggler import StragglerMonitor as JMon
    from repro.runtime.supervisor import SelectionSupervisor as J
    ids, pay, valid = _cover()

    def clock():
        return iter([0.0, 1.0] * 4 + [0.0, 60.0] * 40).__next__

    sup = SelectionSupervisor(ckpt_dir=str(tmp_path / "t"),
                              ckpt_every_levels=100,
                              monitor=StragglerMonitor(window=6,
                                                       threshold=2.0,
                                                       patience=1),
                              clock=clock())
    sol, info = sup.select(t_make("kcover", universe=512, device="cpu"),
                           ids, pay, valid, K, lanes=16, branching=2)
    jsup = J(ckpt_dir=str(tmp_path / "j"), ckpt_every_levels=100,
             monitor=JMon(window=6, threshold=2.0, patience=1),
             clock=clock())
    jsol, jinfo = jsup.select(
        make_objective("kcover", universe=512, backend="ref"),
        jnp.asarray(ids, jnp.int32), jnp.asarray(pay), jnp.asarray(valid),
        K, lanes=16, branching=2)
    _equal(jsol, sol)
    assert _kinds(info["events"]) == _kinds(jinfo["events"])
    assert "straggler" in [e["kind"] for e in info["events"]]
    assert [e for e in info["events"]
            if e["kind"] == "checkpoint" and e.get("preemptive")]


def test_simulator_dropped_leaves_quality_band():
    from repro.core.simulate import run_tree_dense as j_run
    from repro.core.tree import AccumulationTree as JTree
    from repro_torch.core.simulate import run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    _, bm, _ = _cover(n=512)
    clean = run_tree_dense("kcover", bm, K, AccumulationTree(8, 2), seed=0,
                           universe=512, device="cpu")
    for leaf in (0, 3, 7):
        lossy = run_tree_dense("kcover", bm, K, AccumulationTree(8, 2),
                               seed=0, universe=512, drop_leaves=(leaf,),
                               device="cpu")
        want = j_run("kcover", bm, K, JTree(8, 2), seed=0, universe=512,
                     drop_leaves=(leaf,))
        assert lossy.value == want.value
        assert lossy.value >= 0.85 * clean.value, (leaf, lossy.value)


def test_stochastic_tree_replays_bit_for_bit(tmp_path):
    """The D1 guard: with sample_leaf / sample_level on and a seed, a
    transient failure replays to the clean run's bits — the draws of a
    stage are a pure function of (seed, stage, lane)."""
    data = _cover(n=512)
    kw = dict(branching=2, sample_leaf=24, sample_level=6, seed=11)
    clean, _ = _port(tmp_path, "c", data, **kw)
    for spec in (dict(fail_at=((0, 2),)), dict(fail_at=((2, 5),)),
                 dict(fail_at=((1, 0), (3, 7)))):
        sol, info = _port(tmp_path, str(spec), data, spec=spec, **kw)
        for f in ("ids", "payloads", "valid", "value", "evals"):
            assert torch.equal(getattr(sol, f), getattr(clean, f)), f
    other, _ = _port(tmp_path, "o", data, **dict(kw, seed=12))
    assert not torch.equal(other.ids, clean.ids)


# ---------------------------------------------------------------------------
# the planned tree (tests/test_shard_scale.py:188-250)
# ---------------------------------------------------------------------------


def _budget(monkeypatch, mb):
    for env in BUDGETS:
        monkeypatch.setenv(env, str(mb))


def test_supervisor_planned_default_sharded(monkeypatch, tmp_path):
    _budget(monkeypatch, 0.02)
    data = _facility_int(seed=1)
    sol, info = _port(tmp_path, "p", data, lanes=4, name="facility")
    jsol, jinfo = _reference(tmp_path, "p", data, lanes=4, name="facility")
    assert info["shard"] == jinfo["shard"] == 4
    assert info["radices"] == jinfo["radices"] == ()
    plan = [e for e in info["events"] if e["kind"] == "plan"]
    assert plan and plan[0]["leaf_engine"] == "sharded"
    solo = t_greedy(t_make("facility", device="cpu"), *data, K,
                    engine="step")
    assert torch.equal(sol.ids, solo.ids)
    _equal(jsol, sol)


def test_supervisor_planned_tree_replays_bit_identically(monkeypatch,
                                                         tmp_path):
    _budget(monkeypatch, 0.0095)
    data = _facility_int(seed=2)
    clean, cinfo = _port(tmp_path, "a", data, lanes=4, name="facility")
    assert cinfo["shard"] == 1 and cinfo["radices"]
    spec = dict(fail_at=((1, 2),))
    rep, rinfo = _port(tmp_path, "b", data, spec=spec, lanes=4,
                       name="facility")
    jrep, jinfo = _reference(tmp_path, "b", data, spec=spec, lanes=4,
                             name="facility")
    assert any(e["kind"] == "failure" for e in rinfo["events"])
    assert torch.equal(rep.ids, clean.ids)
    assert torch.equal(rep.valid, clean.valid)
    _equal(jrep, rep)
    assert _kinds(rinfo["events"]) == _kinds(jinfo["events"])


def test_supervisor_resume_restores_planned_dispatcher(monkeypatch,
                                                       tmp_path):
    _budget(monkeypatch, 0.02)
    ids, pay, val = _facility_int(seed=5)
    obj = t_make("facility", device="cpu")
    clean, _ = SelectionSupervisor(ckpt_dir=str(tmp_path)).select(
        obj, ids, pay, val, K, lanes=4)
    sup2 = SelectionSupervisor(ckpt_dir=str(tmp_path))
    res, info = sup2.select(obj, ids, pay, val, K, lanes=4, resume=True)
    assert any(e["kind"] == "resume" for e in sup2.events)
    assert info["shard"] == 4
    assert torch.equal(res.ids, clean.ids)
    extra = manager.read_manifest(str(tmp_path / "tree0"),
                                  manager.latest_step(
                                      str(tmp_path / "tree0")))["extra"]
    assert (extra["shard"], extra["radices"]) == (4, [])
    assert extra["tile_c"] > 0


def test_sharded_leaves_refuse_degraded_tree(monkeypatch, tmp_path):
    _budget(monkeypatch, 0.02)
    ids, pay, val = _facility_int(seed=4)
    sup = SelectionSupervisor(ckpt_dir=str(tmp_path), max_restarts=1,
                              injector=LaneFailureInjector(dead={1: 0}))
    with pytest.raises(WorkerFailure):
        sup.select(t_make("facility", device="cpu"), ids, pay, val, K,
                   lanes=4)
    assert "reshard" not in [e["kind"] for e in sup.events]


# ---------------------------------------------------------------------------
# supervised streaming merges
# ---------------------------------------------------------------------------


def _stream_setup():
    st = TSyn.gen_stream("kcover", 256, universe=384, batch=64, seed=3)
    return st, t_make("kcover", universe=384, device="cpu")


def _j_stream(tmp_path, spec=None, max_restarts=3):
    from repro.core.functions import make_objective
    from repro.data.synthetic import gen_stream
    from repro.runtime.supervisor import SelectionSupervisor as J
    from repro.streaming.driver import stream_select_continuous as jc
    st = gen_stream("kcover", 256, universe=384, batch=64, seed=3)
    obj = make_objective("kcover", universe=384, backend="ref")
    sup = None if spec is None else J(ckpt_dir=str(tmp_path / "j"),
                                      injector=_j_injector(spec),
                                      max_restarts=max_restarts)
    return jc(obj, st, K, lanes=4, merge_every=2, backend="ref",
              supervisor=sup)


@pytest.mark.parametrize("spec,max_restarts", [
    (dict(fail_at=((1, 2),)), 3), (dict(dead={1: 1}), 1)])
def test_streaming_supervised_merges_match_reference(tmp_path, spec,
                                                     max_restarts):
    st, obj = _stream_setup()
    ref, ref_info = stream_select_continuous(obj, st, K, lanes=4,
                                             merge_every=2)
    sup = SelectionSupervisor(ckpt_dir=str(tmp_path / "ck"),
                              injector=_t_injector(spec),
                              max_restarts=max_restarts)
    sol, info = stream_select_continuous(obj, st, K, lanes=4, merge_every=2,
                                         supervisor=sup)
    jsol, jinfo = _j_stream(tmp_path, spec, max_restarts)
    _equal(jsol, sol)
    assert info["merges"] == jinfo["merges"]
    assert _kinds(info["events"]) == _kinds(jinfo["events"])
    kinds = [e["kind"] for e in info["events"]]
    if "fail_at" in spec:
        assert torch.equal(sol.ids, ref.ids)
        assert info["merges"] == ref_info["merges"]
        assert "failure" in kinds and "restart" in kinds
        assert manager.latest_step(str(tmp_path / "ck" / "stream")) \
            == len(info["merges"])
    else:
        assert "lane_reset" in kinds
        assert float(sol.value) >= 0.8 * float(ref.value)


def test_run_merge_hands_the_merge_a_copy(tmp_path):
    """A merge that writes into its inputs and then fails: the replay
    sees the states the failed attempt saw, and the returned states are
    the caller's, untouched."""
    st, obj = _stream_setup()
    sel = ContinuousSelector(obj, K, lanes=4, merge_every=100)
    for ids, pay, valid in st:
        sel.push(ids, pay, valid)
    states = sel.states
    before = states.map(lambda x: x.clone())
    want = sel._merge_round(before.map(lambda x: x.clone()), None)
    seen = []

    def scribbling_merge(s, merged):
        seen.append(s.ids.clone())
        if len(seen) == 1:
            s.ids.fill_(-7)
            s.rows.zero_()
            raise LaneFailure("died mid-merge", lane=2, level=0)
        return sel._merge_round(s, merged)

    sup = SelectionSupervisor(ckpt_dir="")
    out, kept = sup.run_merge(scribbling_merge, states, None, 0, None, 4)
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    assert torch.equal(seen[1], before.ids)
    assert torch.equal(out.ids, want.ids)
    assert float(out.value) == float(want.value)
    assert kept is states and torch.equal(states.rows, before.rows)
    assert [e["kind"] for e in sup.events] == ["failure", "restart",
                                               "merge"]


def test_lane_reset_writes_a_copy_of_lane_init(tmp_path):
    st, obj = _stream_setup()
    sel = ContinuousSelector(obj, K, lanes=4, merge_every=100)
    for ids, pay, valid in st:
        sel.push(ids, pay, valid)
    base = sel.streamer.init()
    sup = SelectionSupervisor(ckpt_dir="", max_restarts=0,
                              injector=LaneFailureInjector(dead={1: 0}))
    _, states = sup.run_merge(sel._merge_round, sel.states, None, 0, base,
                              4)
    assert torch.equal(states.ids[1], base.ids)
    assert torch.equal(states.rows[1], base.rows)
    assert not torch.equal(states.ids[0], base.ids)
    base.ids.fill_(5)
    assert int(states.ids[1].max()) == -1
    assert "lane_reset" in [e["kind"] for e in sup.events]


def test_supervised_merge_refuses_a_mesh():
    _, obj = _stream_setup()

    class FakeMesh:
        pass

    with pytest.raises(ValueError, match="stacked"):
        ContinuousSelector(obj, K, supervisor=SelectionSupervisor(""),
                           mesh=FakeMesh())


# ---------------------------------------------------------------------------
# mesh mode: 4 gloo ranks, one spawn
# ---------------------------------------------------------------------------

MESH_RUNS = {
    "clean": dict(),
    "replay": dict(spec=dict(fail_at=((1, 3),))),
    "degraded": dict(spec=dict(dead={3: 1}), max_restarts=1),
    "dead_at_leaves": dict(spec=dict(dead={0: 0}), max_restarts=1),
}


def _summary(sol, info):
    return {"ids": sol.ids.cpu().numpy(), "valid": sol.valid.cpu().numpy(),
            "value": float(sol.value), "kinds": _kinds(info["events"]),
            "final_tree": info["final_tree"], "workers": info["workers"]}


def _mesh_rank(rank, data, root):
    ids, pay, valid = data
    mesh = make_machine_mesh(4, 2, device="cpu")
    obj = t_make("kcover", universe=512, device="cpu")
    out = {}
    for name, run in MESH_RUNS.items():
        sup = SelectionSupervisor(ckpt_dir=os.path.join(root, name),
                                  injector=_t_injector(run.get("spec")),
                                  max_restarts=run.get("max_restarts", 3))
        out[name] = _summary(*sup.select(obj, ids, pay, valid, K, lanes=4,
                                         mesh=mesh))
    d = os.path.join(root, "resume")
    with pytest.raises(WorkerFailure):
        SelectionSupervisor(ckpt_dir=d, injector=_Anon(),
                            max_restarts=1).select(obj, ids, pay, valid, K,
                                                   lanes=4, mesh=mesh)
    out["resume"] = _summary(*SelectionSupervisor(ckpt_dir=d).select(
        obj, ids, pay, valid, K, lanes=4, mesh=mesh, resume=True))
    return out


def test_mesh_mode_replay_resume_and_degrade_equal_stacked(tmp_path):
    """Supervised runs over 4 spawned gloo ranks (one lane a rank) equal
    the stacked supervised runs with the same failures bit for bit, on
    every rank: replay, resume, and a degrade from 4 ranks onto a 2-rank
    subset mesh (the other ranks join the root's broadcast)."""
    data = _cover(n=256)
    results = run_ranks(_mesh_rank, 4, args=(data, str(tmp_path / "m")),
                        timeout=SPAWN_DEADLINE, workdir=str(tmp_path))
    for name, run in dict(MESH_RUNS, resume={}).items():
        want = _summary(*_port(tmp_path, name, data, lanes=4, branching=2,
                               spec=run.get("spec"),
                               max_restarts=run.get("max_restarts", 3)))
        for rank, out in enumerate(results):
            got = out[name]
            np.testing.assert_array_equal(got["ids"], want["ids"])
            np.testing.assert_array_equal(got["valid"], want["valid"])
            assert got["value"] == want["value"], (name, rank)
            if name != "resume":
                assert got["kinds"] == want["kinds"], (name, rank)
            assert (got["final_tree"], got["workers"]) == (
                want["final_tree"], want["workers"]), (name, rank)
    assert results[0]["degraded"]["final_tree"] == (2, 2, 1)
    assert results[0]["degraded"]["workers"] == [0, 1]
    assert results[0]["resume"]["kinds"][0] == ("resume", 1)


# ---------------------------------------------------------------------------
# the faultrun CLI
# ---------------------------------------------------------------------------


def test_faultrun_smoke_passes_on_the_cpu(capsys):
    assert faultrun.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fault smoke OK" in out and "bit-identical=True" in out
    assert faultrun.main(["--device", "cpu", "--fail-level", "1",
                          "--fail-lane", "3", "--permanent",
                          "--max-restarts", "1"]) == 0
    out = capsys.readouterr().out
    assert "degraded=True" in out and "reshard" in out
    assert faultrun.main(["--device", "cpu", "--stream", "--lanes", "4",
                          "--fail-level", "1", "--fail-lane", "1"]) == 0
    assert "restart" in capsys.readouterr().out
