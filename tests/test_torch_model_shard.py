"""The models' sharded step for every arch family on 4 gloo ranks of a
(2, 2) ("data", "model") mesh, held against the one-device step on the
same draw and the same batches: one AdamW train step, a prefill and one
decode step from its cache. Cases (smoke configs):

  * jamba-v0.1-52b — mamba (the scan on each rank's rows and heads), MoE
    and attention;
  * qwen3-moe-30b-a3b, with and without ``token_exchange`` — the routing,
    dispatch and combine on each rank's own groups;
  * h2o-danube-3-4b — a prefill longer than its window (the SWA ring);
  * llava-next-mistral-7b and seamless-m4t-large-v2 — the frontends (the
    projected patches; the encoder and cross-attention).

The MoE cases take 4 rows × 256 positions: two groups of 512 tokens, one
a data rank, and each rank's slots hold only its own group (decode's one
group of 4 tokens, which the data ranks do not divide, is routed whole
on every rank). The parameters are the port's own draw (a torch
Generator), the batches numpy's.

h2o-danube also runs 3 rows, which the 2 data ranks do not divide: the
attention's rows split unevenly (2 and 1) and every other product
contracts the weights' FSDP split into partial sums over the data ranks
(`layers.einsum32`, ROADMAP §C W2).

The train steps of jamba and qwen3-moe (both dispatches) are also held
against the reference's step jitted with `state_shardings` over 4
forced host devices (a JAX subprocess beside the ranks, Auto axes as in
`test_torch_train_shard.py`), from the same state and batch. Against
the one-device step the token-exchange case runs with the expert block's
bf16 cotangent gate (`moe._grad_bf16`) as the identity in both steps:
the gate rounds to bf16 a cotangent whose last bits differ between the
sharded and the one-device sums, which no float64 tolerance holds.
Against the reference it runs with the gate in place, as the reference
does, and is held by `hold_bf16`.

Tolerance, as `test_torch_train_shard.py`'s: every run also in float64
(the port's F32 patched), the float64 runs equal within 1e-9 of scale;
the float32 train step by `hold_runs` (the optimizer state and metrics
by `test_torch_models.hold` at 1e-5, AdamW's parameters by
`optim/parity.py::update_error`), the logits by `hold` at 1e-5.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import moe as TX
from repro_torch.models import multimodal
from repro_torch.sharding import axes as TA
from test_torch_train_shard import (ROOT, TOL, flat, hold_runs, np64,
                                    ocfg_of, port64)

OKW = {"name": "adamw"}
CASES = {  # name: (arch, MoE config overrides, (rows, positions))
    "jamba": ("jamba-v0.1-52b", {}, (4, 256)),
    "qwen3_moe": ("qwen3-moe-30b-a3b", {}, (4, 256)),
    "qwen3_moe_exchange": ("qwen3-moe-30b-a3b", {"token_exchange": True},
                           (4, 256)),
    "h2o": ("h2o-danube-3-4b", {}, (4, 32)),
    "h2o_odd_rows": ("h2o-danube-3-4b", {}, (3, 32)),
    "llava": ("llava-next-mistral-7b", {}, (4, 16)),
    "seamless": ("seamless-m4t-large-v2", {}, (4, 16)),
}
SPAWN_DEADLINE = 300
# held against the reference's sharded step too
REF_CASES = ("jamba", "qwen3_moe", "qwen3_moe_exchange")
# two rows a data rank in one microbatch (the one-device step: four), so
# the MoE train step routes two groups of 512 tokens, one a data rank
MBPD = 2


def config(name):
    arch, moe, _ = CASES[name]
    cfg = TR.smoke_config(arch)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def np_batch(cfg, rows, seq, seed, kind="train"):
    """Tokens (and labels, the last position masked; the frontend's
    embeddings, unit norm) drawn by numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (rows, 1 if kind == "decode" else seq))}
    if kind == "train":
        lab = rng.integers(0, cfg.vocab_size, (rows, seq))
        lab[:, -1] = -1
        out["labels"] = lab
    if cfg.frontend is not None and kind != "decode":
        n = multimodal.frontend_num_embeds(cfg, seq)
        e = rng.standard_normal((rows, n, cfg.frontend.embed_dim))
        out["frames" if cfg.is_encdec else "patches"] = (
            e / np.linalg.norm(e, axis=-1, keepdims=True)).astype(np.float32)
    return {k: v.astype(np.int32) if v.dtype.kind == "i" else v
            for k, v in out.items()}


def initial_state(name):
    """The port's own draw of `name`'s state (numpy, float32)."""
    cfg = config(name)
    state, _ = steps.concrete_state(torch.Generator().manual_seed(0), cfg,
                                    ocfg_of(OKW))
    return convert.train_state_to_numpy(state, cfg, ocfg_of(OKW))


def _placed(cfg, batch, mesh, f64):
    out = pipeline.place(batch, mesh, "cpu")
    return {k: v.double() if f64 and v.is_floating_point() else v
            for k, v in out.items()}


def run_case(name, state0, f64, mesh, mbpd, gate: bool = False):
    """One train step, a prefill and a decode step of `name` over `mesh`
    from the numpy state `state0` (the same batches on every rank):
    {"train": [(state, metrics)] in the reference's layout, "prefill",
    "decode": logits (numpy)}. Under token_exchange the bf16 cotangent
    gate is the identity unless `gate` (then the train step alone)."""
    cfg, ocfg = config(name), ocfg_of(OKW)
    rows, seq = CASES[name][2]
    if f64:
        cfg, state0 = cfg.replace(dtype="float64"), np64(state0)
    shape = ShapeConfig("t", "train", seq, rows)
    saved = TX._grad_bf16
    if cfg.moe is not None and cfg.moe.token_exchange and not gate:
        TX._grad_bf16 = lambda t: t
    try:
        return _run_case(cfg, ocfg, shape, state0, f64, mesh, mbpd,
                         train_only=gate)
    finally:
        TX._grad_bf16 = saved


def _run_case(cfg, ocfg, shape, state0, f64, mesh, mbpd, train_only=False):
    rows, seq = shape.global_batch, shape.seq_len
    with port64(f64):
        state = convert.train_state_to_torch(state0, cfg, ocfg, "cpu")
        if TA.spans(mesh):
            _, axes = steps.abstract_state(cfg, ocfg)
            state = steps.place_state(
                state, steps.state_shardings(axes, state, mesh))
        fn = steps.make_train_step(
            cfg, ocfg, TrainConfig(microbatch_per_device=mbpd), shape, mesh)
        state, m = fn(state, _placed(cfg, np_batch(cfg, rows, seq, 10),
                                     mesh, f64))
        out = {"train": [(convert.train_state_to_numpy(state, cfg, ocfg),
                          {k: float(v) for k, v in m.items()})]}
        if train_only:
            return out
        params = state["params"]
        with torch.no_grad():
            logits, cache = steps.make_prefill_step(
                cfg, mesh, max_len=seq + 1)(params, _placed(
                    cfg, np_batch(cfg, rows, seq, 11, "prefill"), mesh, f64))
            dlogits, _ = steps.make_decode_step(cfg, mesh)(
                params, cache, _placed(
                    cfg, np_batch(cfg, rows, seq, 12, "decode"), mesh, f64))
    out["prefill"] = TA.full_tensor(logits).numpy()
    out["decode"] = TA.full_tensor(dlogits).numpy()
    return out


def _rank(rank, states0):
    mesh = TMESH.make_local_mesh(2, 2, device="cpu")
    slots = []
    orig = TX._slots_dtensor

    def record(xs, mesh_, want, shape):
        slots.append((tuple(xs.shape), tuple(want)))
        return orig(xs, mesh_, want, shape)
    TX._slots_dtensor = record
    out = {}
    for name in CASES:
        for f64 in (False, True):
            del slots[:]
            res = run_case(name, states0[name], f64, mesh, mbpd=MBPD)
            res["slots"] = list(slots)
            if rank:
                del res["train"]
            out[(name, f64)] = res
            if config(name).moe is not None and \
                    config(name).moe.token_exchange:
                gated = run_case(name, states0[name], f64, mesh, mbpd=MBPD,
                                 gate=True)
                if not rank:
                    out[(name, f64, "gated")] = gated
    return out


REFERENCE_SNIPPET = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[3])
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import registry as JR
from repro.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro.launch import mesh as JM, steps as JSteps
from repro.optim import adafactor as JAF, adamw as JAW, compress as JC
from repro.optim import schedule as JS
from test_torch_models import float64_reference, jax_batch, np64
from test_torch_train_steps import _patched

with open(sys.argv[1], "rb") as f:
    cases, states0, batches, ocfg, mbpd = pickle.load(f)
local = JM.make_local_mesh(2, 2)
mesh = Mesh(local.devices, local.axis_names)     # the same devices, Auto
out = {}
for name, (arch, moe, (rows, seq)) in cases.items():
    shape = ShapeConfig("t", "train", seq, rows)
    tcfg = TrainConfig(microbatch_per_device=mbpd)
    for f64 in (False, True):
        def run():
            cfg = JR.smoke_config(arch)
            if moe:
                cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
            cfg = cfg.replace(dtype="float64") if f64 else cfg
            jocfg = OptimConfig(**ocfg)
            sds, axes = JSteps.abstract_state(cfg, jocfg)
            sh = JSteps.state_shardings(axes, sds, mesh)
            assert JSteps.num_microbatches(shape, mesh, tcfg) == 1
            fn = jax.jit(JSteps.make_train_step(cfg, jocfg, tcfg, shape,
                                                mesh),
                         in_shardings=(sh, None), out_shardings=(sh, None))
            st = jax.device_put(np64(states0[name]) if f64
                                else states0[name], sh)
            nb = batches[name]
            st, m = fn(st, np64(nb) if f64 else jax_batch(nb))
            return [(jax.tree.map(np.asarray, st),
                     {k: float(v) for k, v in m.items()})]
        if f64:
            with float64_reference(), _patched((JSteps, JAW, JAF, JC, JS),
                                               jnp.float64):
                out[(name, f64)] = run()
        else:
            out[(name, f64)] = run()
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _reference(tmp, states0):
    """The reference's sharded train step of REF_CASES (a JAX subprocess
    on 4 host devices), started: (process, its output file)."""
    cases = {n: CASES[n] for n in REF_CASES}
    rows_seq = {n: CASES[n][2] for n in REF_CASES}
    batches = {n: np_batch(config(n), *rows_seq[n], 10) for n in REF_CASES}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((cases, {n: states0[n] for n in REF_CASES}, batches,
                     vars(ocfg_of(OKW)), MBPD), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_SNIPPET,
                             str(tmp / "in.pkl"), str(tmp / "out.pkl"),
                             str(ROOT / "tests")], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp / "out.pkl"


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    states0 = {name: initial_state(name) for name in CASES}
    proc, path = _reference(tmp_path_factory.mktemp("model_shard"), states0)
    try:
        ranks = run_ranks(_rank, 4, args=(states0,),
                          timeout=SPAWN_DEADLINE)
        one_mesh = TMESH.make_local_mesh(device="cpu")
        one = {(name, f64): run_case(name, states0[name], f64, one_mesh,
                                     mbpd=2 * MBPD)
               for name in CASES for f64 in (False, True)}
        out, err = proc.communicate(timeout=SPAWN_DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "OK" in out, err[-3000:]
    with open(path, "rb") as f:
        reference = pickle.load(f)
    return ranks, one, states0, reference


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_holds_one_device(world4, name):
    ranks, one, states0, _ = world4
    hold_runs(name, OKW, states0[name], ranks[0][(name, False)]["train"],
              ranks[0][(name, True)]["train"], one[(name, False)]["train"],
              one[(name, True)]["train"], "one-device")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_and_decode_hold_one_device(world4, name):
    from test_torch_models import hold
    ranks, one, _, _ = world4
    for what in ("prefill", "decode"):
        g32, g64 = ranks[0][(name, False)][what], ranks[0][(name, True)][what]
        w32, w64 = one[(name, False)][what], one[(name, True)][what]
        assert g32.shape == w32.shape == (CASES[name][2][0],
                                          config(name).vocab_size)
        err64 = float(np.abs(g64 - w64).max())
        assert err64 <= 1e-9 * max(1.0, float(np.abs(w64).max())), (
            name, what, err64)
        hold(g32, w32, w64, g64, f"{name}:{what}", atol=TOL)
        for r in ranks[1:]:        # every rank gathers the same logits
            np.testing.assert_array_equal(r[(name, False)][what], g32)


MOE_CASES = [n for n in CASES if config(n).moe is not None]


@pytest.mark.parametrize("name", MOE_CASES)
def test_each_rank_routes_its_own_groups(world4, name):
    """The slots a rank dispatches into hold its own groups only: (G / 2,
    X, C, E), split on "data", in the train step (its forward and remat's
    recompute) and the prefill; decode's one group whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard
    ranks, _, _, _ = world4
    cfg = config(name)
    rows, seq = CASES[name][2]
    groups = rows * seq // 512
    moe_layers = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    for r in ranks:
        slots = r[(name, False)]["slots"]
        split = [s for s, pl in slots if pl == (Shard(0), Replicate())]
        whole = [s for s, pl in slots if pl == (Replicate(), Replicate())]
        assert len(split) + len(whole) == len(slots)
        assert groups == 2 and {s[0] for s in split} == {groups // 2}
        assert {s[0] for s in whole} == {1}
        assert len(whole) == moe_layers            # the decode step's
        assert len(split) == 3 * moe_layers        # train, remat, prefill


@pytest.mark.parametrize("name", [n for n in REF_CASES
                                  if not config(n).moe.token_exchange])
def test_sharded_train_step_holds_reference(world4, name):
    ranks, _, states0, reference = world4
    hold_runs(name, OKW, states0[name], ranks[0][(name, False)]["train"],
              ranks[0][(name, True)]["train"], reference[(name, False)],
              reference[(name, True)], "reference")


def test_token_exchange_with_its_bf16_gate_holds_reference(world4):
    """qwen3-moe under token_exchange with the bf16 cotangent gate in
    place, sharded over the ranks, against the reference's sharded step
    (which always gates), by `hold_bf16`."""
    ranks, _, states0, reference = world4
    name = "qwen3_moe_exchange"
    for f64 in (False, True):
        hold_bf16(name, states0[name],
                  ranks[0][(name, f64, "gated")]["train"],
                  reference[(name, f64)], f64)



def hold_bf16(name, state0, got, want, f64: bool):
    """A train step under the bf16 cotangent gate held against the
    reference's. The gate rounds the expert block's output cotangent to
    bf16 (unit roundoff 2^-8), so an element whose two sums straddle a
    rounding boundary moves by one bf16 spacing in one run and not in
    the other. In float64 that is rare: every leaf, parameters included,
    within 1e-6 of its scale (max |reference|), and the grad norm within
    1e-6 of itself; rounding each rank's partial sum instead of their sum
    reads 6e-3. In float32 the moments within 2^-8 of their scale and the
    grad norm within 2^-8 of itself; the parameters by
    `optim/parity.py::update_error` at TOL (Adam's sign-like first update,
    as `hold_runs`). The forward's metrics within TOL of their scale."""
    from repro_torch.optim import parity
    tol = 1e-6 if f64 else 2.0 ** -8
    (g, gm), (w, wm) = got[0], want[0]
    fg, fw = flat(g), flat(w)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        if k.endswith("step"):
            assert int(fg[k]) == int(fw[k]) == 1
            continue
        if k.startswith("params/") and not f64:
            continue
        err = float(np.abs(fg[k].astype(np.float64) - fw[k]).max())
        assert err <= tol * float(np.abs(fw[k]).max()), (name, f64, k, err)
    err, leaf = parity.update_error(
        parity.flatten(np64(state0) if f64 else state0), parity.flatten(g),
        ocfg_of(OKW), gm["lr"])
    assert err <= TOL, (name, f64, leaf, err)
    for k in wm:
        bound = (tol if k == "grad_norm" else TOL) * max(1.0, abs(wm[k]))
        assert abs(gm[k] - wm[k]) <= bound, (name, f64, k, gm[k], wm[k])
