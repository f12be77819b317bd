"""The sharded train step over ranks (`launch/steps.py` on a DeviceMesh,
the state as DTensors placed by the reference's axis rules) on 4 gloo
ranks of a (2, 2) ("data", "model") mesh, held leaf by leaf against

  (a) the port's one-device step (a one-device mesh with the same
      microbatches: ``microbatch_per_device`` = the sharded run's data
      parallelism), and
  (b) the reference's step jitted with `state_shardings` over 4 forced
      host devices (one JAX subprocess, beside the ranks),

from one numpy state and one numpy batch a step. Cases: smollm-135m
(its 4 smoke heads on "model") under AdamW for 2 steps, Adafactor and
the keyless int8 codec for 1 (the MoE and mamba2 are
`test_torch_train_shard_models.py`'s). Every rank gathers
(``full_tensor``) the same state. The ranks
also check `constrain` and `named_sharding` over the mesh, `pipeline.
place`'s rows against the reference's ``place`` shard on the same
device, and the vocab-parallel lookup, logsumexp and label gather
against the unsharded ones.

Tolerance (`hold_runs`): each run also in float64 (the port's F32
patched in every model, optimizer, codec, schedule and step module; the
reference under x64 with its own patched), the float64 runs equal
within 1e-9 of scale, leaf by leaf. The optimizer state and the metrics
by `test_torch_models.hold` at 1e-5, as `test_torch_train_steps.py`
holds the one-device step: within 1e-5 of each leaf's scale, else the
sharded run's RMS error against the float64 yardstick at most 2.5× the
yardstick's own float32 run's. AdamW's parameters by the card's rule,
`optim/parity.py::update_error` at 1e-5: the sharded sums (the
data-parallel gradient, the row-parallel products, the vocab's
logsumexp) round in another order, and Adam's sign-like first update
amplifies a near-zero gradient's error in its parameter.

The reference's `make_local_mesh(2, 2)` has Explicit axes under jax
0.9 (``jax.make_mesh``'s default), where its own ``constrain``
(``with_sharding_constraint``) refuses the mesh; its step runs here on
the same devices in the same order under Auto axes (ROADMAP §C, F1).

This module imports no JAX at the top: the spawned ranks import it.
"""
import hashlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.models import moe as TX
from repro_torch.models import transformer as TT
from repro_torch.optim import adafactor as TAF
from repro_torch.optim import adamw as TAW
from repro_torch.optim import compress as TC
from repro_torch.optim import schedule as TS
from repro_torch.sharding import axes as TA

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
BATCH, SEQ = 4, 16
SPAWN_DEADLINE = 300
CASES = {  # name: (arch, optimizer, steps[, remat: 'block' by default])
    "adamw": ("smollm-135m", {"name": "adamw"}, 2),
    "adafactor": ("smollm-135m", {"name": "adafactor"}, 1),
    "int8": ("smollm-135m", {"name": "adamw", "compress_grads": "int8"}, 1),
}
PORT_F32 = (TL, TX, TMB, TT, steps, TAW, TAF, TC, TS)


def ocfg_of(okw) -> OptimConfig:
    return OptimConfig(**dict(okw, lr=3e-3, warmup_steps=2, total_steps=10))


def np_batch(vocab: int, seed: int):
    """Tokens and labels (the last position masked), as
    `test_torch_models.np_batch` draws them."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    lab = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    lab[:, -1] = -1
    return {"tokens": tok, "labels": lab}


def np64(tree):
    if isinstance(tree, dict):
        return {k: np64(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) \
        else a


class port64:
    """Every F32 of the port's model, optimizer and step modules set to
    float64 inside the block (`test_torch_train_steps.hold_case`'s)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = [m.F32 for m in PORT_F32]
        if self.on:
            for m in PORT_F32:
                m.F32 = torch.float64

    def __exit__(self, *exc):
        for m, f in zip(PORT_F32, self.saved):
            m.F32 = f


def port_steps(arch, okw, n_steps, state0, f64, mesh, mbpd=1,
               remat="block"):
    """The port's `n_steps` of (arch, okw) from the numpy state `state0`
    (the reference's layout) over `mesh`: [(state, metrics)] after each,
    the state gathered into the reference's layout (numpy)."""
    cfg, ocfg = TR.smoke_config(arch), ocfg_of(okw)
    if f64:
        cfg, state0 = cfg.replace(dtype="float64"), np64(state0)
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    out = []
    with port64(f64):
        state = convert.train_state_to_torch(state0, cfg, ocfg, "cpu")
        if TA.spans(mesh):
            _, axes = steps.abstract_state(cfg, ocfg)
            state = steps.place_state(
                state, steps.state_shardings(axes, state, mesh))
        fn = steps.make_train_step(
            cfg, ocfg, TrainConfig(microbatch_per_device=mbpd, remat=remat),
            shape, mesh)
        for s in range(n_steps):
            batch = pipeline.place(np_batch(cfg.vocab_size, 10 + s), mesh,
                                   "cpu")
            state, m = fn(state, batch)
            out.append((convert.train_state_to_numpy(state, cfg, ocfg),
                        {k: float(v) for k, v in m.items()}))
    return out


def digest(runs) -> str:
    h = hashlib.sha1()
    for state, _ in runs:
        for k, v in sorted(flat(state).items()):
            h.update(k.encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def dp_of(mesh_shape) -> int:
    """The data parallelism of the smoke batch over a (data, model) mesh
    (`steps.num_microbatches`' dp)."""
    return mesh_shape[0] if BATCH % mesh_shape[0] == 0 else 1


def run_cases(rank, mesh, cases, states0):
    """Every case f32 and f64 on this rank: rank 0's runs whole, every
    rank's digests."""
    runs, digests = {}, {}
    for name, (arch, okw, n, *remat) in cases.items():
        for f64 in (False, True):
            r = port_steps(arch, okw, n, states0[name], f64, mesh,
                           remat=remat[0] if remat else "block")
            digests[(name, f64)] = digest(r)
            if rank == 0:
                runs[(name, f64)] = r
    return runs, digests


def hold_runs(name, okw, state0, got32, got64, want32, want64, what):
    """Every step's state and metrics of a sharded run held against a
    yardstick's: the optimizer state and the metrics by
    `test_torch_models.hold`, as `hold_case`; under AdamW the parameters
    by `optim/parity.py::update_error` — the update the sharded run's own
    moments imply, from its state before the step, within one f32
    spacing and TOL of the leaf's change — after their float64 runs
    agree within 1e-9 of scale. AdamW's first update is a sign where a
    gradient lies near zero, so a parameter's f32 error is its
    gradient's amplified, and the sharded sums (the data-parallel
    gradient, the row-parallel products) round other than the one-device
    ones: the moments carry the gradient's error unamplified."""
    from repro_torch.optim import parity
    from test_torch_models import hold
    adam = okw["name"] == "adamw"
    before = state0
    for s in range(len(want32)):
        (g, gm), (w, wm) = got32[s], want32[s]
        (g64, _), (w64, wm64) = got64[s], want64[s]
        after = g
        g, w, g64, w64 = flat(g), flat(w), flat(g64), flat(w64)
        assert sorted(g) == sorted(w) == sorted(g64) == sorted(w64)
        assert int(g["opt/step"]) == int(w["opt/step"]) == s + 1
        for k in w:
            if k.endswith("step"):
                continue
            if adam and k.startswith("params/"):
                err64 = float(np.abs(g64[k] - w64[k]).max())
                assert err64 <= 1e-9 * max(1.0, float(np.abs(w64[k]).max())), (
                    what, name, s, k, err64)
                continue
            hold(g[k], w[k], w64[k], g64[k], f"{what}:{name}:{s}:{k}",
                 atol=TOL)
        if adam:
            err, leaf = parity.update_error(
                parity.flatten(before), parity.flatten(after),
                ocfg_of(okw), gm["lr"])
            assert err <= TOL, (what, name, s, leaf, err)
        before = after
        for k in wm:
            if k == "grad_norm":
                # step 1's from one state; step 2's is a gradient taken
                # where Adam's sign-like first update flipped, and an
                # int8 norm counts every quantization step a gradient's
                # f32 error crosses (both held through the state above)
                if s == 0 and okw.get("compress_grads") != "int8":
                    np.testing.assert_allclose(gm[k], wm[k], rtol=1e-4,
                                               err_msg=f"{what}:{name}")
                continue
            hold(gm[k], wm[k], wm64[k], got64[s][1][k],
                 f"{what}:{name}:{s}:{k}", atol=TOL)


def initial_states(cases):
    """The reference's initial state of every case (numpy, float32,
    drawn outside x64 mode)."""
    import jax
    from repro.configs import registry as JR
    from repro.configs.base import OptimConfig as JOptim
    from repro.launch import steps as JSteps
    out = {}
    for name, (arch, okw, *_) in cases.items():
        st, _ = JSteps.concrete_state(jax.random.PRNGKey(0),
                                      JR.smoke_config(arch), JOptim(**okw))
        out[name] = jax.tree.map(np.asarray, st)
    return out


# ---------------------------------------------------------------------------
# The ranks' checks of constrain, named_sharding, place and the vocab
# ---------------------------------------------------------------------------


def _vocab_checks(mesh):
    """The vocab-parallel lookup and CE against the unsharded ones: max
    |Δ| of each value and gradient (f32), and of the f64 gradients."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    out = {}
    g = torch.Generator().manual_seed(3)
    for dt in (torch.float32, torch.float64):
        tab = torch.randn(12, 8, generator=g, dtype=dt)
        tok = torch.randint(0, 12, (4, 6), generator=g)
        w = torch.randn(4, 6, 8, generator=g, dtype=dt)
        # the rules' layout (vocab on "model", embed on "data"), and the
        # vocab on "data" beside a batch split on "data"
        for layout, pl in (("rules", None), ("data", [Shard(0),
                                                      Replicate()])):
            if pl is None:
                sh = TA.named_sharding(mesh, ("vocab", "embed"), tab.shape)
                dtab = sh.place(tab.clone())
            else:
                dtab = distribute_tensor(tab.clone(), mesh, pl,
                                         src_data_rank=None)
            dtab.requires_grad_(True)
            dtok = TA.named_sharding(mesh, ("act_batch", None), tok.shape,
                                     TA.DEFAULT_ACT_RULES).place(tok)
            ptab = tab.clone().requires_grad_(True)
            want = F.embedding(tok, ptab)
            (want * w).sum().backward()
            with steps.sharded_ops(mesh):
                got = TL.vocab_embedding(dtab, dtok)
                (got * DTensor.from_local(
                    w, mesh, [Replicate()] * 2)).sum().backward()
            key = f"{layout}:{dt}"
            out[f"embed_value:{key}"] = float(
                (got.full_tensor() - want).abs().max())
            out[f"embed_grad:{key}"] = float(
                (dtab.grad.full_tensor() - ptab.grad).abs().max())
        logits = torch.randn(4, 6, 10, generator=g, dtype=dt)
        labels = torch.randint(0, 10, (4, 6), generator=g)
        mask = (torch.rand(4, 6, generator=g) > 0.2).to(dt)
        plog = logits.clone().requires_grad_(True)
        want = TL.cross_entropy(plog, labels, mask)
        want.backward()
        dlog = TA.named_sharding(mesh, ("act_batch", None, "act_vocab"),
                                 logits.shape, TA.DEFAULT_ACT_RULES).place(
            logits.clone()).requires_grad_(True)
        with steps.sharded_ops(mesh):
            dlab = TA.named_sharding(mesh, ("act_batch", None), labels.shape,
                                     TA.DEFAULT_ACT_RULES).place(labels)
            got = TL.cross_entropy(dlog, dlab, mask)
            got.backward()
        out[f"ce_value:{dt}"] = float((TA.full_tensor(got) - want).abs())
        out[f"ce_grad:{dt}"] = float(
            (dlog.grad.full_tensor() - plog.grad).abs().max())
    return out


def mesh_checks(rank, mesh, place_batch):
    """constrain, named_sharding and place over `mesh`, and the vocab."""
    from torch.distributed.tensor import DTensor, Replicate
    out = {}
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    dx = DTensor.from_local(x, mesh, [Replicate()] * 2)
    y = TA.constrain(dx, mesh, "act_batch", None, "act_vocab")
    out["constrain_placements"] = repr(tuple(y.placements))
    out["constrain_equal"] = bool(torch.equal(y.full_tensor(), x))
    out["constrain_local"] = tuple(y.to_local().shape)
    try:
        TA.constrain(x, mesh, "act_batch", None, "act_vocab")
        out["plain_raises"] = ""
    except TypeError as e:
        out["plain_raises"] = str(e)
    ns = TA.named_sharding(mesh, ("embed", "mlp"), (8, 12))
    out["named"] = (ns.spec, repr(tuple(ns.placements)))
    placed = pipeline.place(place_batch, mesh, "cpu")
    out["place_rows"] = {k: v.to_local().numpy() for k, v in placed.items()}
    out["place_placements"] = {k: repr(tuple(v.placements))
                               for k, v in placed.items()}
    out["vocab"] = _vocab_checks(mesh)
    return out


PLACE_BATCH = {"tokens": np.arange(8 * 5, dtype=np.int32).reshape(8, 5),
               "labels": np.arange(8 * 5, dtype=np.int32).reshape(8, 5)[
                   ::-1].copy()}


def _rank4(rank, cases, states0, checks):
    mesh = TMESH.make_local_mesh(2, 2, device="cpu")
    runs, digests = run_cases(rank, mesh, cases, states0)
    return {"runs": runs, "digests": digests,
            "checks": mesh_checks(rank, mesh, PLACE_BATCH) if checks
            else None,
            "coordinate": tuple(mesh.get_coordinate())}


REFERENCE_SNIPPET = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[3])
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import registry as JR
from repro.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro.data.pipeline import place
from repro.launch import mesh as JM, steps as JSteps
from repro.optim import adafactor as JAF, adamw as JAW, compress as JC
from repro.optim import schedule as JS
from test_torch_models import float64_reference, jax_batch, np64
from test_torch_train_steps import _patched
import jax.numpy as jnp
from test_torch_train_shard import np_batch, ocfg_of, BATCH, SEQ

with open(sys.argv[1], "rb") as f:
    cases, states0, place_batch = pickle.load(f)
local = JM.make_local_mesh(2, 2)
mesh = Mesh(local.devices, local.axis_names)     # the same devices, Auto
shape = ShapeConfig("t", "train", SEQ, BATCH)
out = {"runs": {}, "axis_types": repr(local.axis_types)}
for name, (arch, okw, n, *_) in cases.items():
    for f64 in (False, True):
        def run():
            cfg, ocfg = JR.smoke_config(arch), OptimConfig(
                **vars(ocfg_of(okw)))
            cfg = cfg.replace(dtype="float64") if f64 else cfg
            sds, axes = JSteps.abstract_state(cfg, ocfg)
            sh = JSteps.state_shardings(axes, sds, mesh)
            assert JSteps.num_microbatches(shape, mesh, TrainConfig()) == 2
            fn = jax.jit(JSteps.make_train_step(cfg, ocfg, TrainConfig(),
                                                shape, mesh),
                         in_shardings=(sh, None), out_shardings=(sh, None))
            st = jax.device_put(np64(states0[name]) if f64
                                else states0[name], sh)
            res = []
            for s in range(n):
                nb = np_batch(cfg.vocab_size, 10 + s)
                st, m = fn(st, np64(nb) if f64 else jax_batch(nb))
                res.append((jax.tree.map(np.asarray, st),
                            {k: float(v) for k, v in m.items()}))
            return res
        if f64:
            with float64_reference(), _patched((JSteps, JAW, JAF, JC, JS),
                                               jnp.float64):
                out["runs"][(name, f64)] = run()
        else:
            out["runs"][(name, f64)] = run()
placed = place(place_batch, mesh)
rows = {}
for k, arr in placed.items():
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    rows[k] = [by_dev[d] for d in mesh.devices.flat]
out["place_rows"] = rows
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def world4_runs(tmp, cases, checks: bool):
    """The 4 ranks' runs of `cases` on a (2, 2) mesh (and the mesh checks
    when `checks`), the reference's sharded runs (a JAX subprocess on 4
    host devices, beside them) and the port's one-device runs."""
    states0 = initial_states(cases)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((cases, states0, PLACE_BATCH), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_SNIPPET,
                            str(tmp / "in.pkl"), str(tmp / "out.pkl"),
                            str(ROOT / "tests")], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        ranks = run_ranks(_rank4, 4, args=(cases, states0, checks),
                          timeout=SPAWN_DEADLINE, workdir=str(tmp))
        one = {(name, f64): port_steps(arch, okw, n, states0[name], f64,
                                       TMESH.make_local_mesh(device="cpu"),
                                       mbpd=dp_of((2, 2)))
               for name, (arch, okw, n, *_) in cases.items()
               for f64 in (False, True)}
        out, err = ref.communicate(timeout=SPAWN_DEADLINE)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in out, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        reference = pickle.load(f)
    return ranks, one, reference, states0


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return world4_runs(tmp_path_factory.mktemp("train_shard4"), CASES, True)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_holds_one_device(world4, name):
    ranks, one, _, states0 = world4
    runs = ranks[0]["runs"]
    hold_runs(name, CASES[name][1], states0[name], runs[(name, False)],
              runs[(name, True)], one[(name, False)], one[(name, True)],
              "one-device")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_holds_reference(world4, name):
    ranks, _, reference, states0 = world4
    runs, ref = ranks[0]["runs"], reference["runs"]
    hold_runs(name, CASES[name][1], states0[name], runs[(name, False)],
              runs[(name, True)], ref[(name, False)], ref[(name, True)],
              "reference")


def test_every_rank_gathers_one_state(world4):
    ranks, _, reference, _ = world4
    assert [r["coordinate"] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    for key, d in ranks[0]["digests"].items():
        assert all(r["digests"][key] == d for r in ranks[1:]), key
    # the reference's own local mesh: Explicit axes (F1)
    assert "Explicit" in reference["axis_types"]


def test_constrain_and_named_sharding_over_the_mesh(world4):
    ranks, _, _, _ = world4
    for r in ranks:
        c = r["checks"]
        assert c["constrain_placements"] == "(Shard(dim=0), Shard(dim=2))"
        assert c["constrain_equal"] and c["constrain_local"] == (2, 6, 4)
        assert "act_batch" in c["plain_raises"] and \
            "sharded path" in c["plain_raises"]
        assert c["named"] == (("data", "model"),
                              "(Shard(dim=0), Shard(dim=1))")


def test_place_gives_each_rank_the_reference_rows(world4):
    ranks, _, reference, _ = world4
    for rank, r in enumerate(ranks):
        c = r["checks"]
        for k in PLACE_BATCH:
            assert c["place_placements"][k] == "(Shard(dim=0), Replicate())"
            want = reference["place_rows"][k][rank]
            np.testing.assert_array_equal(c["place_rows"][k], want)
            assert c["place_rows"][k].dtype == np.int64


def test_vocab_parallel_lookup_and_ce_match_unsharded(world4):
    """The lookup is exact (each row from one rank, zeros from the
    others); its gradient and the CE's sum in another order: within
    1e-6 in f32 and 1e-13 in f64."""
    ranks, _, _, _ = world4
    for r in ranks:
        v = r["checks"]["vocab"]
        for k, err in v.items():
            if k.startswith("embed_value"):
                assert err == 0.0, (k, err)
            elif "float64" in k:
                assert err <= 1e-13, (k, err)
            else:
                assert err <= 1e-6, (k, err)
