"""The sharded leaf tier and the tree planner against the reference, on
the CPU (`repro_torch.kernels.shard_gains`, `kernels/plans.py`'s
shard_bytes / shard_plan / engine_hbm_bytes / select_engine(lanes=) /
plan_tree, `LevelDispatcher(shard=…)`, `make_tree_mesh(…, shard=…)`).

  * the planner on the same budget in both packages' flags: the gates,
    the ladder, the escalation to 'sharded', the byte model and
    `plan_tree` in the scenarios of tests/test_shard_scale.py;
  * `pad_pool`, `resolve_tile_c` and `shard_greedy_sim` against the
    reference's and against solo `greedy(engine='step')`: ids, valid and
    evals exact, values within the reference's tolerance — small-integer
    facility data exactly, real-valued pools but at a float64-proven tie
    (ROADMAP §C P1);
  * the launch contract by `kernels/counters.py` (calls on the CPU):
    k · n_s / tile_c gains a leaf greedy for every stacked lane at once,
    plus one gains_norms for 'dist', nothing else;
  * `LevelDispatcher(shard=2)` stacked against the reference's, stage by
    stage; its errors and its unbound leaves under a constraint;
  * spawned gloo ranks at world size 4 — (2,) machines × 2 shards and
    () × 4 shards — bit for bit against the stacked lanes, and a JAX
    subprocess with 4 forced host devices running the reference's
    `shard_greedy_distributed` on small-integer data, held equal to them.

The spawned ranks import this module: it imports no JAX at its top.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import greedy as TG
from repro_torch.core import greedyml as TGML
from repro_torch.core.constraints import KnapsackSpec
from repro_torch.core.functions import make_objective as t_make
from repro_torch.data.synthetic import gen_images
from repro_torch.kernels import counters
from repro_torch.kernels import plans as TP
from repro_torch.kernels import shard_gains as TSG
from repro_torch.launch import mesh as TM
from repro_torch.launch.spawn import run_ranks

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("ids", "payloads", "valid", "value", "evals")
BUDGETS = ("REPRO_FUSED_CACHE_MB", "REPRO_TORCH_FUSED_CACHE_MB")
DTYPES = ("REPRO_FUSED_CACHE_DTYPE", "REPRO_TORCH_FUSED_CACHE_DTYPE")
SPAWN_DEADLINE = 240.0


def _budget(monkeypatch, mb):
    for env in BUDGETS:
        monkeypatch.setenv(env, str(mb))


def _rule(name):
    return "facility" if name == "facility_int" else name


def _pool(name, n, d=8, seed=0):
    """(ids, payloads, valid) numpy: small integers for facility_int
    (every product and sum exact), else the class mixture."""
    if name == "facility_int":
        x = np.random.default_rng(seed + 50).integers(-3, 4, (n, d))
        x = x.astype(np.float32)
    else:
        x = gen_images(n, d, classes=6, seed=seed)
    return np.arange(n), x, np.ones(n, bool)


def _np(sol):
    return {f: np.asarray(getattr(sol, f)) for f in FIELDS}


def _hold(name, want, got, pool, valid, exact_value=False, pool_ids=None):
    """ids/valid/evals equal and values within 1e-5 (exact for exact
    data), or the first difference a tie that float64 proves."""
    want, got = _np(want), _np(got)
    if np.array_equal(want["ids"], got["ids"]):
        np.testing.assert_array_equal(want["valid"], got["valid"])
        assert int(want["evals"]) == int(got["evals"])
        if exact_value:
            assert float(want["value"]) == float(got["value"])
        else:
            np.testing.assert_allclose(got["value"], want["value"],
                                       rtol=1e-5, atol=1e-5)
        return 0
    assert name != "facility_int", (want["ids"], got["ids"])
    from test_torch_tree import _tie
    pool_ids = np.arange(len(pool)) if pool_ids is None else pool_ids
    a, b = want["ids"].astype(np.int64), got["ids"].astype(np.int64)
    assert (_tie(_rule(name), pool, valid, pool, valid, a, b, pool_ids)
            or _value_tie(name, pool, valid, pool_ids, a, b)), (a, b)
    return 1


def _value64(name, ground, gvalid, pool_ids, ids):
    """f(S) in float64 on the ground (the node's argmax{f(S), f(S_prev)}
    compares such values)."""
    where = {int(e): j for j, e in enumerate(pool_ids) if e >= 0}
    g = ground.astype(np.float64)[gvalid]
    x = ground.astype(np.float64)[[where[int(e)] for e in ids if e >= 0]]
    if name == "kmedoid":
        d0 = np.linalg.norm(g, axis=1)
        d = np.min(np.linalg.norm(g[:, None] - x[None], axis=2), axis=1,
                   initial=np.inf) if len(x) else d0
        return float(d0.mean() - np.minimum(d0, d).mean())
    return float(np.maximum((g @ x.T).max(axis=1, initial=0.0), 0).mean())


def _value_tie(name, ground, gvalid, pool_ids, ids_a, ids_b):
    """Whether two node answers (the new greedy and S_prev) have values
    within f32 rounding of each other: argmax{f(S), f(S_prev)} decided
    by rounding."""
    va = _value64(_rule(name), ground, gvalid, pool_ids, ids_a)
    vb = _value64(_rule(name), ground, gvalid, pool_ids, ids_b)
    return abs(va - vb) <= 1e-5 * max(1.0, abs(va))


def _j_objective(name):
    from repro.core.objective import make_objective
    return make_objective(_rule(name), backend="ref")


def _j_sim(name, ids, pay, val, k, lanes, tile_c=0):
    import jax.numpy as jnp
    from repro.kernels.shard_gains import shard_greedy_sim
    return shard_greedy_sim(_j_objective(name), jnp.asarray(ids, jnp.int32),
                            jnp.asarray(pay), jnp.asarray(val), k,
                            lanes=lanes, tile_c=tile_c)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def _rules():
    from repro.core.objective import make_objective
    return {(pkg, name): (make_objective(name, backend="ref", **kw).rule
                          if pkg == "j" else
                          t_make(name, device="cpu", **kw).rule)
            for pkg in ("j", "t")
            for name, kw in (("facility", {}), ("kmedoid", {}),
                             ("coverage", {"universe": 512}))}


@pytest.mark.parametrize("n,d,lanes,tile", [(512, 16, 8, 16), (90, 8, 4, 8),
                                            (100_000, 12_288, 16, 512),
                                            (7, 3, 2, 512)])
def test_shard_bytes_matches_reference(n, d, lanes, tile):
    from repro.kernels import plans as JP
    assert TP.shard_bytes(n, d, lanes, tile) == JP.shard_bytes(n, d, lanes,
                                                                tile)


@pytest.mark.parametrize("mb", [0.001, 0.005, 0.02, 0.25, 64])
def test_shard_plan_gates_and_ladder_match_reference(monkeypatch, mb):
    from repro.kernels import plans as JP
    _budget(monkeypatch, mb)
    r = _rules()
    assert TP._SHARD_TILES == JP._SHARD_TILES
    assert TP.SHARD_TILE_MIN == JP.SHARD_TILE_MIN
    for name in ("facility", "kmedoid"):
        for n, d, lanes in ((512, 16, 8), (512, 16, 1), (512, None, 8),
                            (4096, 64, 4), (96, 8, 2)):
            want = JP.shard_plan(r["j", name], n, d, lanes)
            got = TP.shard_plan(r["t", name], n, d, lanes)
            assert got == want, (name, n, d, lanes, got, want)
    # bitmap rules never shard
    assert TP.shard_plan(r["t", "coverage"], 512, None, 8) is None
    assert TP.shard_plan(r["t", "coverage"], 16, 16, 8) is None


def test_select_engine_escalates_to_sharded_like_reference(monkeypatch):
    from repro.kernels import plans as JP
    _budget(monkeypatch, 0.02)
    r = _rules()
    for name in ("facility", "kmedoid"):
        jr, tr = r["j", name], r["t", name]
        p = TP.select_engine(tr, 512, 512, 16, lanes=8)
        q = JP.select_engine(jr, 512, 512, 16, lanes=8)
        assert (p.engine, p.tier, p.tile_c, p.lanes, p.dtype) == (
            q.engine, q.tier, q.tile_c, q.lanes, q.dtype) == (
            "sharded", "sharded", 16, 8, "float32")
        assert not p.cached and "sharded" in TP.ENGINES
        for kw in ({"sampling": True}, {"constrained": True},
                   {"requested": "fused"}, {"requested": "step"}, {}):
            lanes = 1 if not kw else 8
            assert TP.select_engine(tr, 512, 512, 16, lanes=lanes,
                                    **kw).engine == JP.select_engine(
                jr, 512, 512, 16, lanes=lanes, **kw).engine == "step", kw
        # the budget refusing even the least tile: the step engine
        _budget(monkeypatch, 0.001)
        assert TP.select_engine(tr, 512, 512, 16, lanes=8).engine == "step"
        _budget(monkeypatch, 0.02)
    for env in BUDGETS:
        monkeypatch.delenv(env)
    # a roomy budget: a cached solo tier wins before the escalation
    assert TP.select_engine(r["t", "facility"], 512, 512, 16, lanes=8).cached


def test_engine_hbm_bytes_matches_reference(monkeypatch):
    """The byte model, tier for tier, where both packages store the same
    rung (the port's int8 rung also counts its row scales)."""
    from repro.kernels import plans as JP
    r = _rules()
    _budget(monkeypatch, 0.02)
    for name in ("facility", "kmedoid"):
        p = TP.select_engine(r["t", name], 512, 512, 16, lanes=8)
        q = JP.select_engine(r["j", name], 512, 512, 16, lanes=8)
        assert TP.engine_hbm_bytes(p, 512, 512, 16) == JP.engine_hbm_bytes(
            q, 512, 512, 16)
        s = TP.select_engine(r["t", name], 512, 512, 16)
        t = JP.select_engine(r["j", name], 512, 512, 16)
        assert TP.engine_hbm_bytes(s, 512, 512, 16) == JP.engine_hbm_bytes(
            t, 512, 512, 16)
    for env in BUDGETS:
        monkeypatch.delenv(env)
    for dt in ("float32", "bfloat16"):
        p = TP.EnginePlan("fused", r["t", "facility"], dtype=dt)
        q = JP.EnginePlan("fused", r["j", "facility"], "ref", dtype=dt)
        assert TP.engine_hbm_bytes(p, 300, 200, 24) == JP.engine_hbm_bytes(
            q, 300, 200, 24)
    p = TP.EnginePlan("fused", r["t", "coverage"], dtype="uint32")
    q = JP.EnginePlan("fused", r["j", "coverage"], "ref", dtype="uint32")
    assert TP.engine_hbm_bytes(p, 16, 200) == JP.engine_hbm_bytes(q, 16, 200)
    p = TP.EnginePlan("fused", r["t", "facility"], dtype="int8")
    q = JP.EnginePlan("fused", r["j", "facility"], "ref", dtype="int8")
    assert TP.engine_hbm_bytes(p, 300, 200, 24) == JP.engine_hbm_bytes(
        q, 300, 200, 24) + 4 * 300


@pytest.mark.parametrize("m", [1, 2, 4, 6, 8, 16, 27])
def test_radix_options_match_reference(m):
    from repro.kernels import plans as JP
    assert TP._radix_options(m) == JP._radix_options(m)


PLAN_SCENARIOS = [
    # (budget MB, rule, n, d, k, lanes, words): tests/test_shard_scale.py
    (0.25, "facility", 4096, 64, 32, 8, None),
    (0.02, "facility", 512, 16, 8, 4, None),
    (0.02, "kmedoid", 512, 16, 8, 4, None),
    (0.02, "facility", 512, 16, 8, 8, None),
    (0.0095, "facility", 512, 16, 8, 4, None),
    (0.001, "facility", 1 << 20, 64, 32, 8, None),
    (64, "coverage", 256, None, 8, 4, 16),
    (0.5, "kmedoid", 8192, 32, 16, 16, None),
]


@pytest.mark.parametrize("mb,name,n,d,k,lanes,words", PLAN_SCENARIOS)
def test_plan_tree_matches_reference(monkeypatch, mb, name, n, d, k, lanes,
                                     words):
    from repro.kernels import plans as JP
    _budget(monkeypatch, mb)
    r = _rules()
    want = JP.plan_tree(r["j", name], n, d, k, lanes, words=words)
    got = TP.plan_tree(r["t", name], n, d, k, lanes, words=words)
    if want is None:
        assert got is None
        return
    assert (got.radices, got.shard, got.leaf_n, got.peak_bytes, got.cost,
            got.model) == (want.radices, want.shard, want.leaf_n,
                           want.peak_bytes, want.cost, want.model)
    assert (got.machines, got.branching, got.lanes) == (
        want.machines, want.branching, want.lanes)
    assert got.lanes == lanes and got.peak_bytes <= mb * 2 ** 20
    assert (got.leaf_plan.engine == "sharded") == (
        want.leaf_plan.engine == "sharded")
    assert got.leaf_plan.tile_c == want.leaf_plan.tile_c
    assert got.node_plan.cached == want.node_plan.cached
    if got.model:
        assert got.model["levels"] == len(got.radices)
        assert got.model["elements_per_interior"] == got.branching * k


def test_plan_tree_bitmap_guard_and_verdicts(monkeypatch):
    r = _rules()
    with pytest.raises(ValueError, match="words="):
        TP.plan_tree(r["t", "coverage"], 256, None, 8, 4)
    _budget(monkeypatch, 0.02)
    fac = TP.plan_tree(r["t", "facility"], 512, 16, 8, 4)
    assert fac.shard == 4 and fac.radices == () and fac.model == {}
    assert fac.leaf_plan.engine == "sharded"
    km = TP.plan_tree(r["t", "kmedoid"], 512, 16, 8, 4)
    assert (km.shard, km.radices) == (2, (2,))
    # an explicit budget outranks the flag
    assert TP.plan_tree(r["t", "facility"], 512, 16, 8, 4,
                        budget_mb=0.001) is None


# ---------------------------------------------------------------------------
# pad_pool, resolve_tile_c
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,lanes,tile", [(90, 4, 8), (96, 4, 8), (7, 2, 512),
                                          (33, 8, 1)])
def test_pad_pool_matches_reference(n, lanes, tile):
    import jax.numpy as jnp
    from repro.kernels.shard_gains import pad_pool
    ids, pay, val = _pool("facility", n)
    val[::5] = False
    want = pad_pool(jnp.asarray(ids, jnp.int32), jnp.asarray(pay),
                    jnp.asarray(val), lanes, tile)
    got = TSG.pad_pool(torch.as_tensor(ids), torch.as_tensor(pay),
                       torch.as_tensor(val), lanes, tile)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[0] % (lanes * tile) == 0


@pytest.mark.parametrize("mb", [0.001, 0.02, 2048])
def test_resolve_tile_c_matches_reference(monkeypatch, mb):
    from repro.kernels.shard_gains import resolve_tile_c
    _budget(monkeypatch, mb)
    r = _rules()
    for name in ("facility", "kmedoid"):
        for args in ((512, 16, 8, 0), (512, 16, 8, 24), (96, 8, 2, 0)):
            assert TSG.resolve_tile_c(r["t", name], *args) == \
                resolve_tile_c(r["j", name], *args)


# ---------------------------------------------------------------------------
# shard_greedy_sim against the reference's and solo greedy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["facility_int", "facility", "kmedoid"])
@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_sim_matches_reference_and_solo(name, lanes):
    ids, pay, val = _pool(name, 96, seed=3)
    k, exact = 6, name == "facility_int"
    obj = t_make(_rule(name), device="cpu")
    got = TSG.shard_greedy_sim(obj, ids, pay, val, k, lanes=lanes, tile_c=8)
    solo = TG.greedy(obj, ids, pay, val, k, engine="step")
    want = _j_sim(name, ids, pay, val, k, lanes, tile_c=8)
    _hold(name, want, got, pay, val, exact_value=exact)
    _hold(name, solo, got, pay, val, exact_value=exact)
    np.testing.assert_array_equal(
        got.payloads.numpy()[got.valid.numpy()],
        pay[got.ids.numpy()[got.valid.numpy()]])


@pytest.mark.parametrize("name", ["facility_int", "facility", "kmedoid"])
def test_sim_invalid_and_ragged_pools(name):
    """90 elements over 4 lanes (padded), every 7th invalid; and a pool
    whose valid elements run out before k: rejected steps are −1."""
    ids, pay, val = _pool(name, 90, seed=7)
    val[::7] = False
    obj = t_make(_rule(name), device="cpu")
    exact = name == "facility_int"
    for k, v in ((5, val), (8, val & (np.arange(90) < 6))):
        got = TSG.shard_greedy_sim(obj, ids, pay, v, k, lanes=4, tile_c=8)
        solo = TG.greedy(obj, ids, pay, v, k, engine="step")
        _hold(name, solo, got, pay, v, exact_value=exact)
        _hold(name, _j_sim(name, ids, pay, v, k, 4, tile_c=8), got, pay, v,
              exact_value=exact)
        assert set(got.ids.numpy()[got.valid.numpy()]) <= set(
            ids[v].tolist())
    assert int(got.valid.sum()) <= 5 and (got.ids.numpy()[
        ~got.valid.numpy()] == -1).all()


@pytest.mark.parametrize("name", ["facility_int", "kmedoid"])
def test_sim_forced_int8_ground_matches_reference(monkeypatch, name):
    """Under the forced int8 rung each lane's ground is quantized (once a
    greedy, the bits of the reference's per-call quantization)."""
    for env in DTYPES:
        monkeypatch.setenv(env, "int8")
    ids, pay, val = _pool(name, 64, seed=11)
    obj = t_make(_rule(name), device="cpu")
    counters.reset()
    got = TSG.shard_greedy_sim(obj, ids, pay, val, 5, lanes=4, tile_c=8)
    assert counters.snapshot()["gains[int8]"]["calls"] == 5 * 2
    assert counters.snapshot().get("gains", {"calls": 0})["calls"] == 0
    want = _j_sim(name, ids, pay, val, 5, 4, tile_c=8)
    solo = TG.greedy(obj, ids, pay, val, 5, engine="step")
    _hold(name, want, got, pay, val)
    _hold(name, solo, got, pay, val)
    for env in DTYPES:
        monkeypatch.delenv(env)
    f32 = TSG.shard_greedy_sim(obj, ids, pay, val, 5, lanes=4, tile_c=8)
    if name == "facility_int":        # small integers quantize exactly
        assert float(f32.value) == float(got.value)


def test_sim_default_tile_from_the_planner(monkeypatch):
    _budget(monkeypatch, 0.01)
    ids, pay, val = _pool("facility_int", 200, d=16)
    obj = t_make("facility", device="cpu")
    tile = TSG.resolve_tile_c(obj.rule, 200, 16, 4)
    assert tile == TP.shard_plan(obj.rule, 200, 16, 4)["tile_c"] < 512
    counters.reset()
    got = TSG.shard_greedy_sim(obj, ids, pay, val, 4, lanes=4)
    n_s = -(-50 // tile) * tile
    assert counters.snapshot()["gains"]["calls"] == 4 * n_s // tile
    _hold("facility_int", TG.greedy(obj, ids, pay, val, 4, engine="step"),
          got, pay, val, exact_value=True)


# ---------------------------------------------------------------------------
# the launch contract
# ---------------------------------------------------------------------------


LAUNCHED = ("gains", "gains[int8]", "gains_norms", "pairwise", "fused_step",
            "greedy_loop", "greedy_loop_resident")


@pytest.mark.parametrize("name,norms", [("kmedoid", 1), ("facility", 0)])
def test_launch_contract_stacked_lanes(name, norms):
    """A stacked sharded leaf stage (2 machines × 4 lanes): ONE gains
    call a (step, tile) serves all 8 lanes — k · n_s / tile_c — plus one
    gains_norms for 'dist'; nothing else."""
    ids, pay, val = _pool(name, 256, seed=2)
    disp = TGML.LevelDispatcher(t_make(name, device="cpu"), 5, (2,), shard=4,
                                tile_c=8)
    lanes = TGML.shard_lanes(torch.as_tensor(ids), torch.as_tensor(pay),
                             torch.as_tensor(val), 8)
    counters.reset()
    disp.leaves(*lanes)
    calls = {n: c["calls"] for n, c in counters.snapshot().items()
             if c["calls"]}
    assert calls == {"gains": 5 * (256 // 8) // 8,
                     **({"gains_norms": 1} if norms else {})}, calls
    assert set(calls) <= set(LAUNCHED)


# ---------------------------------------------------------------------------
# LevelDispatcher(shard=…) against the reference's, stage by stage
# ---------------------------------------------------------------------------


def _j_dispatcher(name, k, radices, shard, **kw):
    from repro.core.greedyml import LevelDispatcher
    return LevelDispatcher(_j_objective(name), k, radices, shard=shard, **kw)


def _j_sol(sol):
    import jax.numpy as jnp
    from repro.core.greedy import Solution
    return Solution(*(jnp.asarray(getattr(sol, f).numpy()).astype(
        jnp.int32 if f in ("ids", "evals") else None) for f in FIELDS))


def _t_sol(sol):
    return TG.Solution(*(torch.as_tensor(np.asarray(getattr(sol, f)))
                         for f in FIELDS))


def _hold_lanes(name, want, got, pools, valids, exact, pool_ids=None):
    """`_hold` lane by lane; pool_ids (lanes, n): the pools' global ids
    (default: the global ids are the pool's positions)."""
    ties = 0
    w, g = _np(want), _np(got)
    for i in range(w["ids"].shape[0]):
        ties += _hold(name, TG.Solution(*(torch.as_tensor(w[f][i])
                                          for f in FIELDS)),
                      TG.Solution(*(torch.as_tensor(g[f][i])
                                    for f in FIELDS)),
                      pools[i], valids[i], exact_value=exact,
                      pool_ids=None if pool_ids is None else pool_ids[i])
    return ties


@pytest.mark.parametrize("name", ["facility_int", "facility", "kmedoid"])
def test_dispatcher_shard2_matches_reference_stage_by_stage(name):
    """(2, 2) machines × 2 shards, stacked: the leaves against the
    reference's `LevelDispatcher(shard=2, mesh=None)` (its lanes
    machine-major, shard digit fastest), then each level fed the
    reference's previous stage."""
    import jax.numpy as jnp
    k, lanes = 5, 8
    ids, pay, val = _pool(name, 128, seed=4)
    jd = _j_dispatcher(name, k, (2, 2), 2)
    td = TGML.LevelDispatcher(t_make(_rule(name), device="cpu"), k, (2, 2),
                              shard=2)
    assert (td.machines, td.lanes) == (4, lanes)
    t_in = TGML.shard_lanes(torch.as_tensor(ids), torch.as_tensor(pay),
                            torch.as_tensor(val), lanes)
    want = jd.leaves(*(jnp.asarray(x.numpy()) for x in t_in))
    got = td.leaves(*t_in)
    exact = name == "facility_int"
    mpools = pay.reshape(4, -1, pay.shape[1])
    mval = val.reshape(4, -1)
    rep = np.repeat(np.arange(4), 2)
    _hold_lanes(name, want, got, mpools[rep], mval[rep], exact)
    for i in range(0, lanes, 2):          # a machine's lanes alike
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f)[i].numpy(),
                                          getattr(got, f)[i + 1].numpy())
    sols = want
    for lvl in range(2):
        want = jd.level(sols, lvl)
        got = td.level(_t_sol(sols), lvl)
        mach = _t_sol(sols).map(lambda x: x[::2])
        u_pay = TGML.gather_groups(mach.payloads, (2, 2), lvl).numpy()
        u_val = TGML.gather_groups(mach.valid, (2, 2), lvl).numpy()
        ties = _hold_lanes(name, want, got, u_pay[rep], u_val[rep], exact,
                           TGML.gather_groups(mach.ids, (2, 2),
                                              lvl).numpy()[rep])
        assert not (exact and ties)
        sols = want


def test_dispatcher_shard_errors_and_unbound_leaves():
    """sample_leaf with shard > 1 raises; a constrained sharded dispatcher
    builds, binds nothing at its leaves and binds every level — as the
    reference's (ROADMAP §C: S_prev, an unbound leaf, may then win a
    level over the budget)."""
    import jax.numpy as jnp
    from repro.core.constraints import KnapsackSpec as JKnapsack
    obj = t_make("facility", device="cpu")
    with pytest.raises(ValueError, match="stochastic"):
        TGML.LevelDispatcher(obj, 3, (2,), shard=2, sample_leaf=5)
    ids, pay, val = _pool("facility_int", 64)
    costs = np.random.default_rng(5).uniform(0.5, 2.0, 64).astype(np.float32)
    spec = KnapsackSpec(torch.as_tensor(costs), 3.0)
    lanes = TGML.shard_lanes(torch.as_tensor(ids), torch.as_tensor(pay),
                             torch.as_tensor(val), 4)
    bound = TGML.LevelDispatcher(obj, 6, (2,), shard=2, constraint=spec)
    free = TGML.LevelDispatcher(obj, 6, (2,), shard=2)
    lb, lf = bound.leaves(*lanes), free.leaves(*lanes)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(lb, f).numpy(),
                                      getattr(lf, f).numpy())
    assert float(spec.spent(lb.ids[0], lb.valid[0])) > 3.0
    jd = _j_dispatcher("facility_int", 6, (2,), 2,
                       constraint=JKnapsack(jnp.asarray(costs), 3.0))
    jl = jd.leaves(*(jnp.asarray(x.numpy()) for x in lanes))
    for want, got in ((jl, lb), (jd.level(jl, 0), bound.level(lb, 0))):
        for f in ("ids", "valid", "value", "evals"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(),
                np.asarray(getattr(want, f)).astype(
                    getattr(got, f).numpy().dtype), err_msg=f)


# ---------------------------------------------------------------------------
# ranks: world size 4, one spawn
# ---------------------------------------------------------------------------

N_RANK, K_RANK = 96, 6


def _rank_data():
    return {name: _pool(name, N_RANK, seed=8)[1]
            for name in ("facility_int", "facility", "kmedoid")}


def _world4_rank(rank, data):
    """Both meshes in one process group: () × 4 shards (the sharded
    greedy alone) and (2,) × 2 shards (the dispatcher's stages)."""
    flat = TM.make_tree_mesh((), shard=4, device="cpu")
    tree = TM.make_tree_mesh((2,), shard=2, device="cpu")
    assert (flat.machine, flat.shard_digit) == (0, rank)
    assert (tree.machine, tree.shard_digit) == divmod(rank, 2)
    assert TGML.machine_flat_id(tree) == rank // 2
    out = {}
    for name, pay in data.items():
        obj = t_make(_rule(name), device="cpu")
        counters.reset()
        sol = TSG.shard_greedy_distributed(obj, np.arange(N_RANK), pay,
                                           np.ones(N_RANK, bool), K_RANK,
                                           flat, tile_c=8)
        out[f"{name}_flat"] = _np(sol)
        out[f"{name}_calls"] = {n: c["calls"] for n, c in
                                counters.snapshot().items() if c["calls"]}
        disp = TGML.LevelDispatcher(obj, K_RANK, (2,), mesh=tree, shard=2,
                                    tile_c=8)
        blk = lambda x: torch.as_tensor(TM.local_block(x, tree))[None]
        leaves = disp.leaves(blk(np.arange(N_RANK)), blk(pay),
                             blk(np.ones(N_RANK, bool)))
        out[f"{name}_stages"] = [_np(leaves), _np(disp.level(leaves, 0))]
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The reference's shard_greedy_distributed on 4 host devices (a JAX
    subprocess, small-integer data) beside the port's 4 ranks."""
    tmp = tmp_path_factory.mktemp("shard4")
    data = _rank_data()
    np.save(tmp / "in.npy", data["facility_int"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_SNIPPET,
                            str(tmp / "in.npy"), str(tmp / "out.npz"),
                            str(K_RANK)], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        results = run_ranks(_world4_rank, 4, args=(data,),
                            timeout=SPAWN_DEADLINE, workdir=str(tmp))
        out, err = ref.communicate(timeout=SPAWN_DEADLINE)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in out, err[-3000:]
    return results, data, dict(np.load(tmp / "out.npz"))


REFERENCE_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core.objective import make_objective
from repro.kernels.shard_gains import shard_greedy_distributed
from repro.launch.mesh import make_tree_mesh

pay = np.load(sys.argv[1])
k = int(sys.argv[3])
n = pay.shape[0]
mesh = make_tree_mesh((), 4)
obj = make_objective("facility", backend="ref")
run = jax.jit(lambda i, p, v: shard_greedy_distributed(obj, i, p, v, k, mesh,
                                                       tile_c=8))
sol = run(jnp.arange(n, dtype=jnp.int32), jnp.asarray(pay),
          jnp.ones(n, bool))
np.savez(sys.argv[2], **{f: np.asarray(getattr(sol, f))
                         for f in ("ids", "valid", "value", "evals")})
print("OK")
"""


@pytest.mark.parametrize("name", ["facility_int", "facility", "kmedoid"])
def test_world4_flat_shard_equals_stacked_lanes(world4, name):
    """() × 4 ranks: every rank's Solution is shard_greedy_sim's over the
    same pool bit for bit, with the stacked launch count a rank."""
    results, data, _ = world4
    pay = data[name]
    obj = t_make(_rule(name), device="cpu")
    counters.reset()
    want = _np(TSG.shard_greedy_sim(obj, np.arange(N_RANK), pay,
                                    np.ones(N_RANK, bool), K_RANK, lanes=4,
                                    tile_c=8))
    calls = {n: c["calls"] for n, c in counters.snapshot().items()
             if c["calls"]}
    assert calls["gains"] == K_RANK * (N_RANK // 4 // 8)
    for r in results:
        for f in FIELDS:
            np.testing.assert_array_equal(r[f"{name}_flat"][f], want[f],
                                          err_msg=f)
        assert r[f"{name}_calls"] == calls


@pytest.mark.parametrize("name", ["facility_int", "facility", "kmedoid"])
def test_world4_tree_shard_equals_stacked_dispatcher(world4, name):
    """(2,) × 2 ranks: the dispatcher's leaves and level, rank for lane,
    bit for bit against the stacked LevelDispatcher(shard=2)."""
    results, data, _ = world4
    pay = data[name]
    disp = TGML.LevelDispatcher(t_make(_rule(name), device="cpu"), K_RANK,
                                (2,), shard=2, tile_c=8)
    lanes = TGML.shard_lanes(torch.arange(N_RANK), torch.as_tensor(pay),
                             torch.ones(N_RANK, dtype=torch.bool), 4)
    leaves = disp.leaves(*lanes)
    stages = [_np(leaves), _np(disp.level(leaves, 0))]
    for r, res in enumerate(results):
        for s in range(2):
            for f in FIELDS:
                np.testing.assert_array_equal(
                    res[f"{name}_stages"][s][f][0], stages[s][f][r],
                    err_msg=f"stage {s} {f}")


def test_world4_matches_reference_shard_greedy_distributed(world4):
    results, _, ref = world4
    for r in results:
        got = r["facility_int_flat"]
        for f in ("ids", "valid", "value", "evals"):
            np.testing.assert_array_equal(
                got[f], ref[f].astype(got[f].dtype), err_msg=f)


def test_shard_mesh_layout():
    """Level groups with shard lanes: the ranks sharing every machine digit
    but digit ℓ and the shard digit; each machine's shard group its
    contiguous ranks (pure, no process group)."""
    radices, shard = (2, 2), 2
    lanes = 8
    for lvl in range(2):
        seen = []
        for g in TM.level_partition(radices, lvl, shard):
            assert g == sorted(g)
            assert len({r % shard for r in g}) == 1
            seen += g
        assert sorted(seen) == list(range(lanes))
        for lane in range(lanes):
            machines = TM.level_ranks(radices, lvl, lane // shard)
            assert TM.level_ranks(radices, lvl, lane, shard) == [
                m * shard + lane % shard for m in machines]
    assert TM.shard_partition(4, 2) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    # gather_groups over the machine lanes is the same tree
    ids = torch.arange(4).unsqueeze(1)
    for lvl in range(2):
        rows = TGML.gather_groups(ids, radices, lvl)
        for lane in range(lanes):
            assert [r // shard for r in TM.level_ranks(
                radices, lvl, lane, shard)] == rows[lane // shard].tolist()


def test_selection_tie_rule():
    """parity.selection_tie (what chip_smoke holds the sharded leaves to
    where rounding splits a greedy): a known near-tie of the reference's
    and the port's kmedoid greedies is one; an arbitrary swap is not."""
    from repro.core.greedy import greedy as j_greedy
    import jax.numpy as jnp
    from repro_torch.kernels import parity
    rng = np.random.default_rng(1)
    pay = rng.standard_normal((128, 8)).astype(np.float32)[64:96]
    ids, val = np.arange(64, 96), np.ones(32, bool)
    obj = t_make("kmedoid", device="cpu")
    got = TG.greedy(obj, ids, pay, val, 5, engine="step").ids
    want = np.asarray(j_greedy(_j_objective("kmedoid"),
                               jnp.asarray(ids, jnp.int32), jnp.asarray(pay),
                               jnp.asarray(val), 5, engine="step").ids)
    assert not np.array_equal(want, got.numpy())        # rounding split it
    x, v = torch.as_tensor(pay), torch.as_tensor(val)
    assert parity.selection_tie(x, v, ids, want, got, obj.rule)
    assert parity.selection_tie(x, v, ids, got, got, obj.rule)
    # the first pick swapped for the pool's least gain (float64)
    g64 = pay.astype(np.float64)
    dist = np.linalg.norm(g64[:, None] - g64[None], axis=2)
    first = np.maximum(np.linalg.norm(g64, axis=1)[:, None] - dist, 0).sum(0)
    worst = got.clone()
    worst[0] = int(ids[np.argmin(first)])
    assert worst[0] != got[0]
    assert not parity.selection_tie(x, v, ids, got, worst, obj.rule)
