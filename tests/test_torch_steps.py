"""The step engines' state on the CPU: the ground's 'dist' norms taken
once per greedy and carried in RuleState, the gains wrapper's `gnorm=`
and the fused step's plan gate.

  * the step engine with the norms carried gives the same selections,
    values and evals as without them, bit for bit, for every feature
    rule, on the f32 and the forced int8 rung, with and without sampling;
  * the norms are taken once per greedy ('dist' rules only), and are the
    stored (int8: dequantized) rows' float64 sums of squares cast once;
  * the stochastic step engine still equals the reference's on injected
    draws (ids, valid and evals exact, values at 1e-5);
  * `ops.gains` refuses a `gnorm` beside a ground it would quantize; the
    fused step's tier follows the kernel's shared memory, and a ground
    too large for the cluster design keeps the fused engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import greedy as JG
from repro.core.functions import make_objective as j_make
from repro.data.synthetic import gen_images
from repro_torch import convert
from repro_torch.core import greedy as TG
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.objective import RuleObjective
from repro_torch.kernels import fused_step as TF
from repro_torch.kernels import ops, plans
from repro_torch.kernels import pairwise as TP
from repro_torch.kernels import rules as TR
from repro_torch.runtime import flags

FEATURE = ["kmedoid", "facility", "satcover", "graphcut", "mmr"]


def _pool(n=96, d=20, seed=4):
    x = gen_images(n, d, classes=5, seed=seed)
    return np.arange(n, dtype=np.int32), x, (np.arange(n) % 9) != 0


def _run(name, k=8, sample=0, draws=None, engine="step"):
    ids, x, valid = _pool()
    obj = t_make(name, device="cpu")
    kw = {}
    if sample:
        kw = {"sample": sample, "cand_idx": torch.as_tensor(draws)}
    return TG.greedy(obj, torch.as_tensor(ids), torch.as_tensor(x),
                     torch.as_tensor(valid), k, engine=engine, **kw)


def _same(a, b):
    for f in ("ids", "payloads", "valid", "value", "evals"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("rung", ["auto", "int8"])
@pytest.mark.parametrize("sample", [0, 20])
@pytest.mark.parametrize("name", FEATURE)
def test_step_engine_with_norms_carried_selects_as_without(
        name, sample, rung, monkeypatch):
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, rung)
    draws = np.random.default_rng(6).permuted(
        np.tile(np.arange(96), (8, 1)), axis=1)[:, :20]
    with_norms = _run(name, sample=sample, draws=draws)
    real = RuleObjective.prepare_ground

    def without(self, state):
        return dataclasses.replace(real(self, state), gnorm=None)

    monkeypatch.setattr(RuleObjective, "prepare_ground", without)
    _same(with_norms, _run(name, sample=sample, draws=draws))


@pytest.mark.parametrize("rung", ["auto", "int8"])
@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_norms_are_taken_once_per_greedy(name, rung, monkeypatch):
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, rung)
    calls = []
    real = ops.gains_norms

    def counting(ground, gscale=None):
        calls.append((tuple(ground.shape), ground.dtype, gscale is None))
        return real(ground, gscale)

    monkeypatch.setattr(ops, "gains_norms", counting)
    _run(name, k=6)
    if name == "facility":           # 'dot': no norms
        assert calls == []
    else:
        dtype = torch.int8 if rung == "int8" else torch.float32
        assert calls == [((1, 96, 20), dtype, rung != "int8")]


def test_prepare_ground_keeps_what_it_holds(monkeypatch):
    """prepare_ground fills gquant (forced int8 rung) and gnorm ('dist')
    once; a state that holds them passes through unchanged; bitmap rules
    are left as they are."""
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    _, x, valid = _pool()
    obj = t_make("kmedoid", device="cpu")
    st = obj.init_state(torch.as_tensor(x)[None],
                        torch.as_tensor(valid)[None])
    st = obj.prepare_ground(st)
    q, scale = st.gquant
    assert q.dtype == torch.int8 and st.gnorm.shape == (1, 96)
    assert obj.prepare_ground(st) is st
    torch.testing.assert_close(st.gnorm, TP.ground_norms(q, scale),
                               rtol=0, atol=0)
    cov = t_make("kcover", universe=64, device="cpu")
    words = torch.zeros(1, 5, 2, dtype=torch.int32)
    cst = cov.init_state(words, torch.ones(1, 5, dtype=torch.bool))
    assert cov.prepare_ground(cst) is cst


def test_ground_norms_on_the_cpu_are_the_float64_sums():
    _, x, _ = _pool(n=40, d=13)
    g = torch.as_tensor(x)[None]
    want = (g.double() ** 2).sum(-1).float()
    assert torch.equal(TP.ground_norms(g), want)
    q, scale = ops.quantize_ground(g)
    deq = TR.dequant(q, scale)
    assert torch.equal(TP.ground_norms(q, scale),
                       (deq.double() ** 2).sum(-1).float())
    assert torch.equal(ops.gains_norms(q, scale), TP.ground_norms(q, scale))


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_gains_take_gnorm_and_ignore_it_on_the_cpu(name):
    """The plain version needs no norms: gnorm passed or not, the CPU
    gains are the same bits (the kernel reads them on the card)."""
    _, x, _ = _pool(n=50, d=16)
    g = torch.as_tensor(x)[None]
    tr = t_make(name, device="cpu").rule
    row = TR.empty_row(g, torch.ones(1, 50, dtype=torch.bool), tr)
    row = TR.update_row(g, row, g[:, 3], tr)
    cands = g[:, 10:30]
    cv = torch.ones(1, 20, dtype=torch.bool)
    a = ops.gains(g, row, cands, cv, tr)
    b = ops.gains(g, row, cands, cv, tr, gnorm=ops.gains_norms(g))
    assert torch.equal(a, b)


def test_gains_refuse_gnorm_beside_a_ground_they_quantize(monkeypatch):
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    g = torch.rand(1, 8, 4)
    cv = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        ops.gains(g, torch.zeros(1, 8), g, cv, TR.DIST_MIN,
                  gnorm=ops.gains_norms(g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_fused_tier_follows_the_kernels_shared_memory(dtype):
    """A span's chunks spread over at most 8 blocks, each holding its
    chunks' (128,) f32 partials, its rows and (int8) their scales in the
    H100's 227 KB less 1 KB: the knapsack node and leaf shapes take the
    cluster design, up to 92,416 f32 or bf16 rows and 77,056 int8 rows;
    beyond, the global tier. The chunk does not depend on the rows."""
    bn = plans.fused_block_n(dtype)
    assert bn == plans.FUSED_BLOCK_N
    limit = 77_056 if dtype == "int8" else 92_416
    for n in (1, 400, 3125, limit):
        assert plans.fused_cluster_fits(dtype, n, bn)
    for n in (limit + 1, 100_000, 10 ** 6):
        assert not plans.fused_cluster_fits(dtype, n, bn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_fused_global_tier_host_plan(dtype, monkeypatch):
    """The global tier's host side: the gate — the cluster design up to
    16 chunks a block of a cluster of 8 (4,096 rows in chunks of 32: the
    knapsack node and leaf shapes), the global tier beyond, in every
    storage, and everywhere once FUSED_CLUSTER_CHUNKS is 0 (as the
    CUDA tests force it); a block's chunks (4 rounds of its lane groups:
    512 KB of the cache at 32-row chunks, fewer where the rows would take
    over a quarter of the shared memory); the scratch at the sequential
    Greedy's shape (1 × 100,000²: 782 spans) and at a ragged one."""
    for n in (1, 400, 3_125, 4_096):
        assert plans.fused_tier(dtype, n, 32) == "cluster"
    for n in (4_097, 12_500, 90_000, 100_000):
        assert plans.fused_tier(dtype, n, 32) == "global"
    assert plans.fused_tier(dtype, 2_048, 16) == "cluster"
    assert plans.fused_tier(dtype, 2_049, 16) == "global"
    monkeypatch.setattr(plans, "FUSED_CLUSTER_CHUNKS", 0)
    assert plans.fused_tier(dtype, 1, 32) == "global"
    monkeypatch.undo()
    item = TR.cache_itemsize(dtype)
    chunks = plans.fused_global_chunks(dtype, 32)
    assert chunks == 4 * 32 // item
    assert chunks * 32 * plans.FUSED_SPAN * item == 512 * 1024
    row_bytes = 8 if dtype == "int8" else 4
    for bn in (8, 512, 4096, 10 ** 6):
        got = plans.fused_global_chunks(dtype, bn)
        assert got == 1 or (got * bn * row_bytes
                            <= flags.H100_SMEM_PER_BLOCK // 4)
    assert plans.fused_global_chunks(dtype, 4096) < chunks
    assert plans.fused_global_scratch(1, 100_000, 100_000, 32) == (
        (1, 3125, 782 * 128), 2 * 782, 782 + 1)
    assert plans.fused_global_scratch(3, 77, 257, 32) == (
        (3, 3, 384), 2 * 3 * 3, 3 * 3 + 3)
    assert plans.fused_global_scratch(2, 0, 5, 32) == ((2, 1, 128), 4, 4)


def test_sequential_greedy_over_all_images_keeps_the_fused_engine(
        monkeypatch):
    """simulate.run_greedy_dense over all 100,000 Tiny-ImageNet images:
    the f32 cache (40,000 MB) fits the default 40,960 MB budget, so the
    plan is the fused engine (on its global tier), not the step engine
    that would recompute 2·N²·D products a step."""
    monkeypatch.delenv(flags.FUSED_CACHE_MB_ENV, raising=False)
    monkeypatch.delenv(flags.FUSED_CACHE_DTYPE_ENV, raising=False)
    monkeypatch.delenv(flags.FUSED_VMEM_MB_ENV, raising=False)
    plan = plans.select_engine(TR.DIST_MIN, 100_000, 100_000, 12_288)
    assert (plan.engine, plan.dtype) == ("fused", "float32")
    assert plan.block_n == plans.FUSED_BLOCK_N
    assert plans.fused_tier("float32", 100_000, plan.block_n) == "global"


def test_fused_step_cpu_ignores_the_launch_shape():
    """On CPU tensors fused_step is the plain version whatever chunk or
    tier the card would use."""
    _, x, _ = _pool(n=30, d=8)
    g = torch.as_tensor(x)[None]
    tr = TR.DIST_MIN
    mat = TP.pairwise_plain(g, g, "dist")
    row = TR.empty_row(g, torch.ones(1, 30, dtype=torch.bool), tr)
    mask = torch.ones(1, 30)
    want = TF.fused_step_plain(mat, row, mask, 4, tr)
    for kw in ({}, {"block_n": 8}, {"reference": True}):
        got = TF.fused_step(mat, row, mask, 4, tr, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_stochastic_step_engine_matches_reference_draws(name):
    """The reference's draws handed to the port as cand_idx: the step
    engine (norms carried) selects as the reference's step engine."""
    ids, x, valid = _pool(seed=9)
    key = jax.random.PRNGKey(3)
    k, sample = 8, 20
    draws = np.array(JG._sample_candidates(key, k, len(ids), sample))
    want = JG.greedy(j_make(name, backend="ref"), jnp.asarray(ids),
                     jnp.asarray(x), jnp.asarray(valid), k, sample=sample,
                     key=key, engine="step")
    got = TG.greedy(t_make(name, device="cpu"), torch.as_tensor(ids),
                    convert.to_torch(x, "cpu"), torch.as_tensor(valid), k,
                    sample=sample, cand_idx=torch.as_tensor(draws),
                    engine="step")
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.evals) == int(want.evals)
    assert abs(float(got.value) - float(want.value)) <= 1e-5 * max(
        1.0, abs(float(want.value)))
