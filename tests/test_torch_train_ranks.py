"""The sharded train step on 2 gloo ranks (one spawn holding both
meshes of two ranks): a (2, 1) ("data", "model") mesh — pure data
parallelism with the weights' embed dim split over "data" (FSDP) — and a
(1, 2) mesh — tensor parallelism alone, the batch whole on each rank.
smollm-135m and the qwen3-moe smoke config on (2, 1), mamba2-1.3b on
(1, 2) under remat 'full' (the others 'block'), AdamW for 2 steps. Each is held
against the port's one-device step with the same microbatches
(`test_torch_train_shard.hold_runs`), as `test_torch_train_shard.py`
holds the (2, 2) mesh.

Checkpoints and the supervisor over the ranks: a DTensor state saved
over 2 ranks writes the files a one-device save of the same state
writes (one rank writing, the arrays equal bit for bit); restoring it
onto the mesh gives each leaf its placements and values back; a
`Supervisor` run of 4 sharded steps, checkpointing every 2, with a
failure injected at step 3 resumes to the state of the unbroken run bit
for bit. The trainer's coreset over the ranks (`launch/train.py::
select_on_mesh`, the distributed tree over a `TreeMesh` of the mesh's
axes) is alike on both ranks.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import manager
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data import pipeline, selection, synthetic
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps
from repro_torch.launch import train as TTRAIN
from repro_torch.launch.spawn import run_ranks
from repro_torch.runtime.fault import FailureInjector, Supervisor
from repro_torch.sharding import axes as TA

from test_torch_train_shard import (BATCH, SEQ, dp_of, flat, hold_runs,
                                    initial_states, np_batch, ocfg_of,
                                    port_steps, run_cases)

SPAWN_DEADLINE = 240
MESH_CASES = {
    (2, 1): {"adamw": ("smollm-135m", {"name": "adamw"}, 2),
             "moe": ("qwen3-moe-30b-a3b", {"name": "adamw"}, 2)},
    (1, 2): {"mamba": ("mamba2-1.3b", {"name": "adamw"}, 2, "full")},
}
CKPT_CASE = ("smollm-135m", {"name": "adamw"})


def _placed_state(state0, mesh):
    arch, okw = CKPT_CASE
    cfg, ocfg = TR.smoke_config(arch), ocfg_of(okw)
    state = convert.train_state_to_torch(state0, cfg, ocfg, "cpu")
    if TA.spans(mesh):
        _, axes = steps.abstract_state(cfg, ocfg)
        state = steps.place_state(state,
                                  steps.state_shardings(axes, state, mesh))
    fn = steps.make_train_step(cfg, ocfg, TrainConfig(),
                               ShapeConfig("t", "train", SEQ, BATCH), mesh)
    return state, fn, cfg, ocfg


def _state_digest(state, cfg, ocfg) -> str:
    h = hashlib.sha1()
    for k, v in sorted(flat(convert.train_state_to_numpy(state, cfg,
                                                         ocfg)).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _supervised(state0, mesh, ckpt_dir, fail_at):
    state, fn, cfg, ocfg = _placed_state(state0, mesh)

    def one_step(st, step):
        st, m = fn(st, pipeline.place(np_batch(cfg.vocab_size, 10 + step),
                                      mesh, "cpu"))
        return st, {"loss": float(m["loss"])}

    sup = Supervisor(ckpt_dir=ckpt_dir, ckpt_every=2,
                     injector=FailureInjector(fail_at) if fail_at else None)
    state, done = sup.run(state, one_step, 4)
    return (_state_digest(state, cfg, ocfg), done,
            [e["kind"] for e in sup.events])


def _ckpt_checks(rank, mesh, state0, tmp):
    out = {}
    state, _, cfg, ocfg = _placed_state(state0, mesh)
    path = manager.save(f"{tmp}/sharded", 0, state)
    out["saved"] = path
    restored, _ = manager.restore(f"{tmp}/sharded", state)
    leaves = {k: v for k, v in manager._flatten(restored).items()}
    orig = manager._flatten(state)
    out["restored_placements"] = all(
        tuple(leaves[k].placements) == tuple(v.placements)
        for k, v in orig.items() if TA.is_dtensor(v))
    out["restored_equal"] = all(
        torch.equal(TA.full_tensor(leaves[k]), TA.full_tensor(v))
        for k, v in orig.items())
    out["n_dtensor"] = sum(TA.is_dtensor(v) for v in leaves.values())
    out["supervised"] = _supervised(state0, mesh, f"{tmp}/sup", (3,))
    out["unbroken"] = _supervised(state0, mesh, f"{tmp}/plain", ())
    toks = synthetic.gen_tokens(64, 17, 256, seed=0)
    emb = selection.embed_documents(toks[:, :16], seed=0)
    out["coreset"] = np.asarray(TTRAIN.select_on_mesh(
        emb, 8, "greedyml:facility", mesh, 0, "cpu"))
    return out


def _rank2(rank, states0, tmp):
    out = {"cases": {}}
    for shape, cases in MESH_CASES.items():
        mesh = TMESH.make_local_mesh(*shape, device="cpu")
        out["cases"][shape] = run_cases(rank, mesh, cases,
                                        states0[shape])
        if shape == (2, 1):
            out["ckpt"] = _ckpt_checks(rank, mesh, states0["ckpt"], tmp)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ranks2")
    states0 = {shape: initial_states(cases)
               for shape, cases in MESH_CASES.items()}
    states0["ckpt"] = states0[(2, 1)]["adamw"]
    ranks = run_ranks(_rank2, 2, args=(states0, str(tmp)),
                      timeout=SPAWN_DEADLINE, workdir=str(tmp))
    one = {}
    for shape, cases in MESH_CASES.items():
        for name, (arch, okw, n, *remat) in cases.items():
            for f64 in (False, True):
                one[(shape, name, f64)] = port_steps(
                    arch, okw, n, states0[shape][name], f64,
                    TMESH.make_local_mesh(device="cpu"),
                    mbpd=dp_of(shape), remat=remat[0] if remat else "block")
    return ranks, one, states0, tmp


@pytest.mark.parametrize("shape,name", [(s, n) for s, c in
                                        MESH_CASES.items() for n in c])
def test_two_rank_step_holds_one_device(world2, shape, name):
    ranks, one, states0, _ = world2
    runs, digests = ranks[0]["cases"][shape]
    assert ranks[1]["cases"][shape][1] == digests
    hold_runs(name, MESH_CASES[shape][name][1], states0[shape][name],
              runs[(name, False)], runs[(name, True)],
              one[(shape, name, False)], one[(shape, name, True)],
              f"one-device{shape}")


def test_sharded_checkpoint_equals_one_device_files(world2, tmp_path):
    ranks, _, states0, tmp = world2
    c0, c1 = ranks[0]["ckpt"], ranks[1]["ckpt"]
    assert c0["saved"] == c1["saved"]
    state, _, _, _ = _placed_state(states0["ckpt"], None)
    path = manager.save(str(tmp_path / "plain"), 0, state)
    got = np.load(f"{c0['saved']}/arrays.npz")
    want = np.load(f"{path}/arrays.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert manager.read_manifest(str(tmp / "sharded"), 0)["keys"] == \
        manager.read_manifest(str(tmp_path / "plain"), 0)["keys"]


def test_restore_onto_the_mesh_round_trips(world2):
    ranks, _, _, _ = world2
    for r in ranks:
        c = r["ckpt"]
        assert c["restored_placements"] and c["restored_equal"]
        assert c["n_dtensor"] > 0


def test_supervised_run_over_ranks_resumes_to_the_unbroken_state(world2):
    ranks, _, _, _ = world2
    for r in ranks:
        sup, plain = r["ckpt"]["supervised"], r["ckpt"]["unbroken"]
        assert sup[1] == plain[1] == 4
        assert sup[2] == ["checkpoint", "failure", "restart", "checkpoint"]
        assert sup[0] == plain[0]
    assert ranks[0]["ckpt"]["supervised"][0] == \
        ranks[1]["ckpt"]["supervised"][0]


def test_coreset_over_the_trainer_mesh(world2):
    ranks, _, _, _ = world2
    a, b = ranks[0]["ckpt"]["coreset"], ranks[1]["ckpt"]["coreset"]
    np.testing.assert_array_equal(a, b)
    assert 0 < len(a) <= 8 and len(set(a.tolist())) == len(a)
    assert a.max() < 64
