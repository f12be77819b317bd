"""The port's checkpointing and elastic pieces against the reference, on
the CPU: `checkpoint/manager.py` (layout, keys, keep-N, the restore
protect-set, crash safety), checkpoints written by either package
restoring in the other (a lane `Solution` and a continuous
``{"states", "merged"}`` tree), `checkpoint/reshard.py`
(`restore_resharded` over a world-size-1 gloo DeviceMesh,
`reshard_solutions`), `sharding/axes.py::resolve_spec` over a table of
logical axes, shapes and mesh sizes (the reference on
`jax.sharding.AbstractMesh`), and `runtime/elastic.py`'s planners.

Every comparison here is exact: the checkpointed values are copied, not
computed (tolerance 0).
"""
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import manager as JM
from repro.checkpoint import reshard as JReshard
from repro.core.greedyml import empty_lane_solutions as j_empty
from repro.core.functions import make_objective as j_make
from repro.data import synthetic as JSyn
from repro.runtime import elastic as JE
from repro.runtime.fault import FailureInjector as JFI
from repro.runtime.fault import Supervisor as JSup
from repro.sharding import axes as JAxes
from repro.streaming import SieveStreamer as JStreamer
from repro_torch.checkpoint import manager
from repro_torch.checkpoint import reshard
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.greedy import Solution
from repro_torch.core.greedyml import empty_lane_solutions
from repro_torch.runtime import elastic
from repro_torch.runtime.fault import FailureInjector, Supervisor
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.sharding import axes
from repro_torch.streaming import SieveStreamer


def _tree(x=0.0):
    return {"a": torch.full((4, 3), float(x)),
            "b": {"c": torch.arange(5) + int(x)}}


# ---------------------------------------------------------------------------
# the manager (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    manager.save(d, 7, _tree(2.5), extra={"note": "hi"})
    tree, manifest = manager.restore(d, _tree())
    assert torch.equal(tree["a"], torch.full((4, 3), 2.5))
    assert torch.equal(tree["b"]["c"], torch.arange(5) + 2)
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "hi"
    # the reference's layout and keys
    assert sorted(os.listdir(d)) == ["step_00000007"]
    assert manifest["keys"] == ["a", "b/c"]


def test_keep_n_cleanup(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(6):
        manager.save(d, s, _tree(s), keep=3)
    assert manager.list_steps(d) == [3, 4, 5]
    assert manager.latest_step(d) == 5


def test_restore_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    manager.save(d, 1, _tree())
    bad = {"a": torch.zeros((2, 2)), "b": {"c": torch.arange(5)}}
    with pytest.raises(ValueError):
        manager.restore(d, bad)
    with pytest.raises(KeyError):
        manager.restore(d, {"z": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        manager.restore(str(tmp_path / "none"), _tree())


def test_atomicity_no_tmp_left(tmp_path):
    d = str(tmp_path / "ck")
    manager.save(d, 1, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_save_is_a_snapshot_of_the_state(tmp_path):
    """A SieveState is consumed in place by process_batch: what a save
    wrote must not follow the tensors it was given."""
    d = str(tmp_path / "ck")
    t = _tree(1.0)
    manager.save(d, 1, t)
    t["a"].fill_(9.0)
    back, _ = manager.restore(d, _tree())
    assert torch.equal(back["a"], torch.full((4, 3), 1.0))


def test_crashed_save_preserves_previous_checkpoint(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    manager.save(d, 1, _tree(1))
    real_rename = os.rename

    def crashing_rename(src, dst):
        if src.endswith(".tmp"):
            raise OSError("simulated crash mid-save")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", crashing_rename)
    with pytest.raises(OSError):
        manager.save(d, 2, _tree(2))
    monkeypatch.undo()
    assert manager.latest_step(d) == 1
    assert any(n.endswith(".tmp") for n in os.listdir(d))
    restored, manifest = manager.restore(d, _tree(0))
    assert manifest["step"] == 1
    assert torch.equal(restored["a"], _tree(1)["a"])
    manager.save(d, 3, _tree(3))
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert manager.list_steps(d) == [1, 3]


def test_keep_n_never_deletes_step_being_restored(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    manager.save(d, 1, _tree(1))
    real_load = np.load
    fired = []

    def interleaved_load(path, *a, **kw):
        out = real_load(path, *a, **kw)
        if not fired and "step_00000001" in str(path):
            fired.append(True)
            manager.save(d, 2, _tree(2), keep=1)
            manager.save(d, 3, _tree(3), keep=1)
        return out

    monkeypatch.setattr(np, "load", interleaved_load)
    restored, manifest = manager.restore(d, _tree(0), step=1)
    monkeypatch.undo()
    assert fired and manifest["step"] == 1
    assert torch.equal(restored["a"], _tree(1)["a"])
    manager.save(d, 4, _tree(4), keep=1)
    assert manager.list_steps(d) == [4]


def test_restore_casts_to_the_example_and_keeps_bf16(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.tensor([1.5, -2.25]).to(torch.bfloat16),
            "i": torch.tensor([3, -1], dtype=torch.int64)}
    manager.save(d, 1, tree)
    ex = {"w": torch.zeros(2, dtype=torch.bfloat16),
          "i": torch.zeros(2, dtype=torch.int32)}
    back, _ = manager.restore(d, ex)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert back["i"].dtype == torch.int32 and back["i"].tolist() == [3, -1]


# ---------------------------------------------------------------------------
# the step supervisor (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def test_supervisor_recovers_from_injected_failures(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(ckpt_dir=d, ckpt_every=10,
                     injector=FailureInjector((12, 25)))
    calls = []

    def step_fn(state, step):
        calls.append(step)
        return {"x": state["x"] + 1}, {"loss": 1.0}

    state, final = sup.run({"x": torch.zeros(())}, step_fn, 40)
    jsup = JSup(ckpt_dir=str(tmp_path / "j"), ckpt_every=10,
                injector=JFI((12, 25)))
    jstate, jfinal = jsup.run({"x": jnp.zeros(())},
                              lambda s, i: ({"x": s["x"] + 1},
                                            {"loss": 1.0}), 40)
    assert final == jfinal == 40
    assert [e["kind"] for e in sup.events] == [e["kind"]
                                              for e in jsup.events]
    assert [e.get("step") for e in sup.events] == [e.get("step")
                                                  for e in jsup.events]
    assert calls.count(11) >= 2
    assert float(state["x"]) == float(jstate["x"]) == 40


def test_supervisor_failure_before_first_checkpoint_cold_restarts(tmp_path):
    sup = Supervisor(ckpt_dir=str(tmp_path / "ck"), ckpt_every=10,
                     injector=FailureInjector((2,)), max_restarts=1)
    state, final = sup.run({"x": torch.zeros(())},
                           lambda s, i: ({"x": s["x"] + 1}, {}), 20)
    assert final == 20 and float(state["x"]) == 20
    kinds = [e["kind"] for e in sup.events]
    assert "cold_restart" in kinds and "failure" in kinds


def test_straggler_monitor_flags_persistent_outlier():
    mon = StragglerMonitor(window=10, threshold=2.0, patience=3)
    actions = []
    for step in range(30):
        dur = 1.0 if step < 20 else 5.0
        a = mon.observe(step, dur, host=3)
        if a:
            actions.append((step, a))
    assert actions and actions[0][1] == "exclude_on_next_reshard"
    assert mon.actions[0]["host"] == 3
    mon2 = StragglerMonitor(window=10, threshold=2.0, patience=3)
    trig = [mon2.observe(s, 5.0 if s % 7 == 0 else 1.0) for s in range(40)]
    assert not any(trig)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _lane_solutions(lanes=4, k=3, d=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (lanes, k))
    ids[0, -1] = -1
    pay = rng.standard_normal((lanes, k, d)).astype(np.float32)
    valid = ids >= 0
    value = rng.random(lanes).astype(np.float32)
    evals = rng.integers(0, 500, lanes)
    return ids, pay, valid, value, evals


def test_lane_solution_checkpoints_cross_both_ways(tmp_path):
    ids, pay, valid, value, evals = _lane_solutions()
    jsol = j_empty(4, 3, jnp.zeros((1, 5), jnp.float32))
    jsol = type(jsol)(jnp.asarray(ids, jnp.int32), jnp.asarray(pay),
                      jnp.asarray(valid), jnp.asarray(value),
                      jnp.asarray(evals, jnp.int32))
    tsol = Solution(torch.as_tensor(ids), torch.as_tensor(pay),
                    torch.as_tensor(valid), torch.as_tensor(value),
                    torch.as_tensor(evals))
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    JM.save(jd, 3, jsol, extra={"stage": 3})
    manager.save(td, 3, tsol, extra={"stage": 3})
    # the same keys in both manifests
    assert (manager.read_manifest(td, 3)["keys"]
            == json.load(open(os.path.join(jd, "step_00000003",
                                           "manifest.json")))["keys"]
            == ["0", "1", "2", "3", "4"])
    # reference → port: ids widen to int64
    got, man = manager.restore(jd, empty_lane_solutions(
        4, 3, torch.zeros((1, 5))))
    assert man["extra"]["stage"] == 3 and got.ids.dtype == torch.int64
    for f, want in zip(("ids", "payloads", "valid", "value", "evals"),
                       (ids, pay, valid, value, evals)):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want)
    # port → reference: ids narrow to int32
    back, _ = JM.restore(td, j_empty(4, 3, jnp.zeros((1, 5), jnp.float32)))
    assert back.ids.dtype == jnp.int32
    for f, want in zip(("ids", "payloads", "valid", "value", "evals"),
                       (ids, pay, valid, value, evals)):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), want)


@pytest.mark.parametrize("name", ["kcover", "facility"])
def test_continuous_tree_checkpoints_cross_both_ways(tmp_path, name):
    """A continuous merge's {"states": stacked sieves, "merged": Solution}
    tree, written by either package, restores in the other: the bitmap
    words' bit patterns (uint32 ↔ int32), ids (int32 ↔ int64) and every
    float exactly."""
    lanes, k = 2, 4
    st = JSyn.gen_stream(name, 64, d=6, universe=96, batch=16, seed=4)
    if name == "kcover":
        jo = j_make("kcover", universe=96, backend="ref")
        to = t_make("kcover", universe=96, device="cpu")
        jstr, tstr = JStreamer(jo, k, backend="ref"), SieveStreamer(to, k)
    else:
        g = st.payloads[:24]
        jo, to = (j_make(name, backend="ref"), t_make(name, device="cpu"))
        jstr = JStreamer(jo, k, ground=jnp.asarray(g), backend="ref")
        tstr = SieveStreamer(to, k, ground=torch.as_tensor(g))
    jst = jstr.init()
    for ids, pay, valid in list(st)[:2]:
        jst = jstr.process_batch(jst, jnp.asarray(ids), jnp.asarray(pay),
                                 jnp.asarray(valid))
    import jax
    jstates = jax.tree.map(lambda x: jnp.stack([x] * lanes), jst)
    jmerged = jstr.solution(jst)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    JM.save(jd, 1, {"states": jstates, "merged": jmerged})
    example = {"states": tstr.init(lanes=lanes),
               "merged": tstr.solution(tstr.init())}
    got, _ = manager.restore(jd, example)
    jflat = JM._flatten({"states": jstates, "merged": jmerged})
    tflat = manager._flatten(got)
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        have = tflat[key].numpy()
        want = np.asarray(want)
        if want.dtype == np.uint32:
            have = have.view(np.uint32)
        np.testing.assert_array_equal(have, want.astype(have.dtype))
    manager.save(td, 1, got)
    back, _ = JM.restore(td, {"states": jstates, "merged": jmerged})
    for key, want in jflat.items():
        np.testing.assert_array_equal(
            np.asarray(JM._flatten(back)[key]), np.asarray(want))


# ---------------------------------------------------------------------------
# sharding/axes.py, checkpoint/reshard.py, runtime/elastic.py
# ---------------------------------------------------------------------------

AXES_TABLE = [
    (("embed", "mlp"), (8, 12)),
    (("vocab", "embed"), (6, 16)),
    (("heads", "head_dim"), (28, 64)),
    (("experts", "expert_embed", "expert_mlp"), (8, 16, 32)),
    ((None, "embed"), (3, 7)),
    (("layers", "embed", "mlp"), (4, 32, 48)),
    (("kv_heads", "embed"), (2, 8)),
]
MESHES = [{"data": 2, "model": 4}, {"data": 4, "model": 1},
          {"pod": 2, "data": 2, "model": 2}, {"data": 1, "model": 1},
          {"data": 8, "model": 16}]


@pytest.mark.parametrize("sizes", MESHES)
def test_resolve_spec_matches_reference(sizes):
    from jax.sharding import AbstractMesh
    jmesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    for logical, shape in AXES_TABLE:
        want = JAxes.resolve_spec(logical, shape, jmesh,
                                  JAxes.DEFAULT_PARAM_RULES)
        got = axes.resolve_spec(logical, shape, sizes)
        assert got == tuple(want), (logical, shape, sizes)
    with pytest.raises(KeyError):
        axes.resolve_spec(("nope",), (4,), sizes)


@pytest.fixture
def world1():
    """A world-size-1 gloo process group in this process."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_restore_resharded_onto_a_device_mesh(tmp_path, world1):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    manager.save(d, 3, tree)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    restored, manifest = reshard.restore_resharded(
        d, tree, {"w": ("embed", "mlp")}, mesh)
    assert isinstance(restored["w"], DTensor) and manifest["step"] == 3
    assert tuple(restored["w"].placements) == (Replicate(), Replicate())
    assert torch.equal(restored["w"].full_tensor(), tree["w"])
    again, _ = elastic.rescale(d, tree, {"w": ("embed", "mlp")}, mesh)
    assert torch.equal(again["w"].full_tensor(), tree["w"])


def test_placements_shard_each_split_dim(world1):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    assert axes.placements(("data", "model"), mesh) == (Shard(0), Shard(1))
    assert axes.placements((None, "data"), mesh) == (Shard(1), Replicate())
    assert axes.placements((("data", "model"),), mesh) == (Shard(0),
                                                           Shard(0))
    assert axes.placements((), mesh) == (Replicate(), Replicate())


@pytest.mark.parametrize("survivors,new_lanes",
                         [([0, 1, 2, 4, 5, 6, 7], 4), ([1, 2, 3], 2),
                          ([5], 1), ([0, 2, 3, 4, 6], 1)])
def test_reshard_solutions_matches_reference(survivors, new_lanes):
    ids, pay, valid, value, evals = _lane_solutions(lanes=8, k=4, d=3,
                                                    seed=5)
    tsol = Solution(torch.as_tensor(ids), torch.as_tensor(pay),
                    torch.as_tensor(valid), torch.as_tensor(value),
                    torch.as_tensor(evals))
    jsol = type(j_empty(1, 1, jnp.zeros((1, 3))))(
        jnp.asarray(ids, jnp.int32), jnp.asarray(pay), jnp.asarray(valid),
        jnp.asarray(value), jnp.asarray(evals, jnp.int32))
    got = reshard.reshard_solutions(tsol, survivors, new_lanes)
    want = JReshard.reshard_solutions(jsol, survivors, new_lanes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError):
        reshard.reshard_solutions(tsol, [], 1)
    with pytest.raises(ValueError):
        reshard.reshard_solutions(tsol, survivors, len(survivors) + 1)


def test_elastic_planners_equal_the_reference():
    for s in range(1, 40):
        for b in range(2, 6):
            assert elastic.plan_degraded_tree(s, b) == \
                JE.plan_degraded_tree(s, b)
    for data in (1, 4, 8):
        for model in (1, 2, 4):
            for healthy in range(1, 70, 3):
                assert elastic.plan_new_mesh(data, model, healthy) == \
                    JE.plan_new_mesh(data, model, healthy)
    for bad in ((0, 2), (3, 1)):
        with pytest.raises(ValueError):
            elastic.plan_degraded_tree(*bad)
