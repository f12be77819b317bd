"""The serving subsystem of the port against the reference, on the CPU
(tests/test_serving.py's cases): admission batching, bounded-queue
backpressure, the memory budget capping a batch, the solo fallbacks, one
dispatch per admitted batch (`kernels/counters.py` calls on the CPU, the
reference's jaxpr count), `plans.serve_key`/`serve_plan`, the serve
flags, tenant sessions over the continuous driver, and the metrics.

Both packages get the same numpy pools (the reference on its `ref`
backend). Selections must be equal (ids, valid, evals exact); values
agree within 1e-4, the reference test's tolerance (its kmedoid distances
use the expansion formula of ROADMAP §C F0). Against the port's own solo
``greedy(engine="mega")`` every query of a batch is equal bit for bit —
ids, valid, value, evals and payloads — whatever its pool size and k.
"""
import inspect
import json

import numpy as np
import pytest
import torch

from repro_torch.core.constraints import Knapsack
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.greedy import greedy as t_greedy
from repro_torch.data import synthetic as TSyn
from repro_torch.kernels import counters, plans
from repro_torch.kernels import rules as TR
from repro_torch.runtime import flags
from repro_torch.serving import (Query, QueryEngine, QueueFull,
                                 ServeMetrics, SessionManager,
                                 TenantSession, percentile)
from repro_torch.streaming import stream_select_continuous

FIELDS = ("ids", "payloads", "valid", "value", "evals")
SERVE_ENVS = ("REPRO_TORCH_SERVE_BATCH", "REPRO_TORCH_SERVE_QUEUE",
              "REPRO_TORCH_SERVE_MEM_MB")


def _pool(n=96, d=32, seed=0):
    pay = TSyn.gen_images(n, d, classes=8, seed=seed)
    return np.arange(n), pay, (np.arange(n) % 11) != 0


def _query(name="facility", k=8, n=96, d=32, seed=0, **kw):
    return Query(name, k, *_pool(n, d, seed), **kw)


def _cover_query(k=8, n=100, seed=0, universe=600):
    sets = TSyn.gen_kcover(n, universe, seed=seed)
    pay = TSyn.pack_bitmaps(sets, universe)
    return Query("kcover", k, np.arange(n), pay, np.ones(n, bool),
                 universe=universe)


def _engine(**kw):
    return QueryEngine(device="cpu", **kw)


def _solo(q: Query, **kw):
    obj = (t_make(q.objective, universe=q.universe, device="cpu")
           if q.universe else t_make(q.objective, device="cpu"))
    return t_greedy(obj, q.ids, q.payloads, q.valid, q.k, **kw)


def _bitwise(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _reference_drain(queries, **kw):
    import jax.numpy as jnp
    from repro.serving import Query as JQ
    from repro.serving import QueryEngine as JE
    eng = JE(backend="ref", **kw)
    for q in queries:
        eng.submit(JQ(q.objective, q.k, jnp.asarray(q.ids, jnp.int32),
                      jnp.asarray(q.payloads), jnp.asarray(q.valid),
                      universe=q.universe, engine=q.engine))
    return eng.drain(), eng


def _held(jres, tres):
    np.testing.assert_array_equal(tres.solution.ids.numpy(),
                                  np.asarray(jres.solution.ids))
    np.testing.assert_array_equal(tres.solution.valid.numpy(),
                                  np.asarray(jres.solution.valid))
    assert int(tres.solution.evals) == int(jres.solution.evals)
    assert abs(float(tres.solution.value)
               - float(jres.solution.value)) <= 1e-4
    assert (tres.batched, tres.batch_size) == (jres.batched,
                                               jres.batch_size)


# ---------------------------------------------------------------------------
# queue + admission
# ---------------------------------------------------------------------------


def test_queue_bound_backpressure():
    eng = _engine(queue_cap=2)
    eng.submit(_query(seed=0))
    eng.submit(_query(seed=1))
    assert eng.pending == 2
    with pytest.raises(QueueFull):
        eng.submit(_query(seed=2))
    res = eng.drain()
    assert len(res) == 2 and eng.pending == 0
    eng.submit(_query(seed=2))


def test_admission_groups_compatible_fifo():
    order = ["facility", "kmedoid", "facility", "kmedoid", "facility"]
    queries = [_query(name, k=6 + i, seed=i) for i, name in enumerate(order)]
    eng = _engine(max_batch=2)
    qids = [eng.submit(q) for q in queries]
    res = eng.drain()
    jres, jeng = _reference_drain(queries, max_batch=2)
    assert len(res) == 5 and all(res[q].batched for q in qids)
    assert sorted(b["size"] for b in eng.metrics.batches) == [1, 2, 2]
    assert ([b["size"] for b in eng.metrics.batches]
            == [b["size"] for b in jeng.metrics.batches])
    assert len({res[q].key for q in qids}) == 2
    assert res[qids[0]].key == res[qids[2]].key == res[qids[4]].key
    for q in qids:
        _held(jres[q], res[q])
        _bitwise(res[q].solution, _solo(queries[q], engine="mega"))


def test_heterogeneous_pool_sizes_share_a_bucket():
    queries = [_query(n=96, k=5, seed=1), _query(n=120, k=9, seed=2),
               _query(n=200, k=5, seed=3)]
    eng = _engine()
    a, b, c = (eng.submit(q) for q in queries)
    res = eng.drain()
    jres, _ = _reference_drain(queries)
    assert res[a].key == res[b].key != res[c].key
    assert res[a].batch_size == 2 and res[c].batch_size == 1
    for q in (a, b, c):
        _held(jres[q], res[q])
        _bitwise(res[q].solution, _solo(queries[q], engine="mega"))


@pytest.mark.parametrize("name", ["facility", "kmedoid", "satcover",
                                  "graphcut", "mmr"])
def test_every_query_of_a_batch_equals_its_solo_run(name):
    """Four pool sizes (two buckets), four k, one engine: each query
    equals its solo greedy(engine="mega") bit for bit; fill queries pad
    the 3-query bucket to 4 and return nothing."""
    queries = [_query(name, k=k, n=n, d=24, seed=s) for s, (n, k) in
               enumerate([(70, 3), (128, 9), (100, 16), (250, 7)])]
    eng = _engine()
    qids = [eng.submit(q) for q in queries]
    res = eng.drain()
    assert [r.batch_size for r in res.values()] == [3, 3, 3, 1]
    for q in qids:
        _bitwise(res[q].solution, _solo(queries[q], engine="mega"))


def test_bitmap_queries_batch_and_equal_solo():
    queries = [_cover_query(k=k, n=n, seed=s) for s, (n, k) in
               enumerate([(100, 8), (128, 5), (60, 12)])]
    eng = _engine()
    qids = [eng.submit(q) for q in queries]
    counters.reset()
    res = eng.drain()
    snap = counters.snapshot()
    assert snap["greedy_loop_resident[coverage]"]["calls"] == 1
    assert eng.metrics.batches[0]["dispatches"] == 1
    jres, _ = _reference_drain(queries)
    for q in qids:
        assert res[q].batched and res[q].batch_size == 3
        _bitwise(res[q].solution, _solo(queries[q], engine="mega"))
        _held(jres[q], res[q])


def test_memory_budget_caps_admitted_batch(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SERVE_MEM_MB", "0.05")
    eng = _engine()
    for seed in range(4):
        eng.submit(_query(seed=seed))
    res = eng.drain()
    assert all(r.batched and r.batch_size == 1 for r in res.values())
    monkeypatch.delenv("REPRO_TORCH_SERVE_MEM_MB")
    eng2 = _engine()
    for seed in range(4):
        eng2.submit(_query(seed=seed))
    assert {r.batch_size for r in eng2.drain().values()} == {4}


# ---------------------------------------------------------------------------
# solo fallbacks
# ---------------------------------------------------------------------------


def test_sampling_query_falls_back_solo_and_matches():
    """The port's draws come from a torch.Generator seeded with the
    query's seed (ROADMAP §C D1): equal to greedy() with that generator."""
    q = Query("facility", 8, *_pool(seed=4), sample=32, seed=7)
    eng = _engine()
    qid = eng.submit(q)
    r = eng.drain()[qid]
    assert not r.batched and eng.metrics.batches == []
    _bitwise(r.solution,
             _solo(q, sample=32, key=torch.Generator().manual_seed(7)))


def test_engine_override_falls_back_solo():
    q = _query(seed=5, engine="step")
    eng = _engine()
    qid = eng.submit(q)
    r = eng.drain()[qid]
    assert not r.batched
    _bitwise(r.solution, _solo(q, engine="step"))
    jres, _ = _reference_drain([q])
    _held(jres[0], r)


def test_constrained_query_falls_back_solo():
    ids, pay, valid = _pool(seed=8)
    costs = np.random.default_rng(8).uniform(0.5, 2.0, ids.shape[0])
    con = Knapsack(torch.as_tensor(costs, dtype=torch.float32), 4.0)
    q = Query("facility", 8, ids, pay, valid, constraint=con)
    eng = _engine()
    qid = eng.submit(q)
    r = eng.drain()[qid]
    assert not r.batched and eng.metrics.batches == []
    _bitwise(r.solution, _solo(q, constraint=con))


def test_resident_overflow_falls_back_solo(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_FUSED_VMEM_MB", "0.001")
    eng = _engine()
    q = _query(seed=6)
    qid = eng.submit(q)
    r = eng.drain()[qid]
    assert not r.batched and bool(r.solution.valid.any())
    _bitwise(r.solution, _solo(q))


# ---------------------------------------------------------------------------
# one dispatch per admitted batch
# ---------------------------------------------------------------------------


def test_admitted_batch_is_one_dispatch():
    eng = _engine(max_batch=4)
    for seed in range(4):
        eng.submit(_query(k=5 + seed, seed=seed))
    counters.reset()
    res = eng.drain()
    assert all(r.batched and r.batch_size == 4 for r in res.values())
    assert [b["dispatches"] for b in eng.metrics.batches] == [1]
    calls = {n: c["calls"] for n, c in counters.snapshot().items()
             if c["calls"]}
    assert calls == {"greedy_loop_resident": 1}


def test_batched_loop_is_one_dispatch_and_a_loop_pays_b():
    """The counterpart of the reference's vmap contract: B stacked
    queries are ONE resident call; a loop over the same queries, B."""
    obj = t_make("facility", device="cpu")
    b, n, d, k = 4, 96, 32, 6
    pays = torch.stack([torch.as_tensor(_pool(n, d, s)[1])
                        for s in range(b)])
    vals = torch.ones(b, n, dtype=torch.bool)
    ks = torch.tensor([6, 3, 5, 1], dtype=torch.int32)
    lims = torch.tensor([[n, n]] * b, dtype=torch.int32)
    counters.reset()
    _, bests, _ = obj.megakernel_loop_batched(pays, vals, ks, k,
                                              logical=lims)
    assert counters.counter("greedy_loop_resident").calls == 1
    counters.reset()
    for i in range(b):
        _, one, _ = obj.megakernel_loop_batched(pays[i:i + 1],
                                                vals[i:i + 1], ks[i:i + 1],
                                                k, logical=lims[i:i + 1])
        assert torch.equal(one[0], bests[i])
    assert counters.counter("greedy_loop_resident").calls == b
    assert bool((bests[1, 3:] == -1).all())


def test_batched_loop_matches_reference():
    import jax.numpy as jnp
    from repro.core.objective import make_objective as j_make
    b, n, d, k = 3, 96, 32, 7
    raw = [_pool(n, d, s) for s in range(b)]
    pays = np.stack([p for _, p, _ in raw])
    vals = np.stack([v for _, _, v in raw])
    ks = np.array([7, 4, 2], np.int32)
    lims = np.array([[n, n]] * b, np.int32)
    for name in ("facility", "kmedoid"):
        _, want, wg = j_make(name, backend="ref").megakernel_loop_batched(
            jnp.asarray(pays), jnp.asarray(vals), jnp.asarray(ks), k,
            logical=jnp.asarray(lims))
        _, got, gg = t_make(name, device="cpu").megakernel_loop_batched(
            torch.as_tensor(pays), torch.as_tensor(vals),
            torch.as_tensor(ks), k, logical=torch.as_tensor(lims))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(gg.numpy(), np.asarray(wg), atol=1e-4)
    assert t_make("facility", device="cpu").megakernel_loop_batched(
        torch.as_tensor(pays), torch.as_tensor(vals), torch.as_tensor(ks),
        k, plan=plans.EnginePlan("fused", TR.DOT_MAX)) is None


# ---------------------------------------------------------------------------
# the serving plan surface (kernels/plans.py)
# ---------------------------------------------------------------------------


def test_serve_key_discriminates_like_reference():
    from repro.kernels import plans as JP
    from repro.kernels import rules as JR
    pairs = [((TR.DOT_MAX, 96, 96, 32), (JR.DOT_MAX, 96, 96, 32)),
             ((TR.DOT_MAX, 120, 120, 32), (JR.DOT_MAX, 120, 120, 32)),
             ((TR.DOT_MAX, 96, 96, 48), (JR.DOT_MAX, 96, 96, 48)),
             ((TR.DOT_MAX, 200, 200, 32), (JR.DOT_MAX, 200, 200, 32)),
             ((TR.DIST_MIN, 96, 96, 32), (JR.DIST_MIN, 96, 96, 32)),
             ((TR.sat_sum(1.5), 96, 96, 32), (JR.sat_sum(1.5), 96, 96, 32)),
             ((TR.sat_sum(2.0), 96, 96, 32), (JR.sat_sum(2.0), 96, 96, 32)),
             ((TR.BITS_OR, 12, 96, None), (JR.BITS_OR, 12, 96, None)),
             ((TR.BITS_OR, 13, 96, None), (JR.BITS_OR, 13, 96, None))]
    for (t_args, j_args) in pairs:
        assert (plans.serve_key(*t_args, "cpu")
                == JP.serve_key(*j_args, "cpu"))
    k1 = plans.serve_key(TR.DOT_MAX, 96, 96, 32, "cuda")
    assert k1 == plans.serve_key(TR.DOT_MAX, 120, 120, 32, "cuda")
    assert k1 != plans.serve_key(TR.DOT_MAX, 96, 96, 32, "cpu")
    assert k1 != plans.serve_key(TR.DOT_MAX, 200, 200, 32, "cuda")


def test_serve_plan_budget_math(monkeypatch):
    for var in SERVE_ENVS:
        monkeypatch.delenv(var, raising=False)
    sp = plans.serve_plan(TR.DOT_MAX, 128, 128, 32)
    assert sp is not None and sp["plan"].engine == "mega_resident"
    need = (plans._resident_need(128, 128, 32, TR.DOT_MAX)
            + plans.cache_bytes(128, 128, "float32"))
    assert sp["bytes_per_query"] == need
    assert sp["b_max"] == flags.serve_batch() == 16
    monkeypatch.setenv("REPRO_TORCH_SERVE_MEM_MB", str(3.5 * need / 2 ** 20))
    assert plans.serve_plan(TR.DOT_MAX, 128, 128, 32)["b_max"] == 3
    monkeypatch.setenv("REPRO_TORCH_SERVE_MEM_MB", "0.0001")
    assert plans.serve_plan(TR.DOT_MAX, 128, 128, 32)["b_max"] == 1
    monkeypatch.setenv("REPRO_TORCH_SERVE_MEM_MB", "4096")
    assert plans.serve_plan(TR.DOT_MAX, 128, 128, 32)["b_max"] == 16
    # the L2 gate of the resident tier caps B too: 16 × 512² f32 = 16 MB
    monkeypatch.setenv("REPRO_TORCH_RESIDENT_L2_MB", "4.5")
    capped = plans.serve_plan(TR.DOT_MAX, 512, 512, 32)
    assert capped["b_max"] == 4      # 4 × 1 MB ≤ 4.5 MB < 5 × 1 MB
    monkeypatch.delenv("REPRO_TORCH_RESIDENT_L2_MB")
    bits = plans.serve_plan(TR.BITS_OR, 19, 128, None)
    assert bits["bytes_per_query"] == (plans._resident_need(
        19, 128, None, TR.BITS_OR) + plans.cache_bytes(19, 128, "uint32"))
    monkeypatch.setenv("REPRO_TORCH_FUSED_VMEM_MB", "0.001")
    assert plans.serve_plan(TR.DOT_MAX, 128, 128, 32) is None


def test_serve_flags_accessors(monkeypatch):
    for var in SERVE_ENVS:
        monkeypatch.delenv(var, raising=False)
    assert flags.serve_batch() == 16
    assert flags.serve_queue() == 1024
    assert flags.serve_mem_mb() == 132 * 232_448 / 2 ** 20
    monkeypatch.setenv("REPRO_TORCH_SERVE_BATCH", "3")
    monkeypatch.setenv("REPRO_TORCH_SERVE_QUEUE", "7")
    monkeypatch.setenv("REPRO_TORCH_SERVE_MEM_MB", "1.5")
    assert (flags.serve_batch(), flags.serve_queue(),
            flags.serve_mem_mb()) == (3, 7, 1.5)


def test_no_raw_environ_in_serving():
    import repro_torch.serving.engine as E
    import repro_torch.serving.metrics as M
    import repro_torch.serving.session as S
    for mod in (E, M, S):
        assert "os.environ" not in inspect.getsource(mod), mod.__name__


# ---------------------------------------------------------------------------
# tenant sessions (streaming)
# ---------------------------------------------------------------------------


def test_tenant_session_matches_continuous_driver():
    from repro.data.synthetic import gen_stream as j_stream
    from repro.core.objective import make_objective as j_make
    from repro.serving import TenantSession as JSession
    import jax.numpy as jnp
    st = TSyn.gen_stream("facility", 128, d=24, universe=384, batch=32,
                         seed=1)
    obj = t_make("facility", device="cpu")
    ground = torch.as_tensor(st.payloads)
    kw = dict(lanes=2, merge_every=2, ground=ground)
    sess = TenantSession("t0", obj, 6, **kw)
    for ids, pay, valid in st:
        sess.push(ids, pay, valid)
    ref_sol, ref_info = stream_select_continuous(obj, st, 6, **kw)
    got = sess.query()
    assert torch.equal(got.ids, ref_sol.ids)
    assert torch.equal(got.valid, ref_sol.valid)
    info = sess.info()
    assert info["merges"] == ref_info["merges"]
    assert info["tenant"] == "t0"
    assert sess.metrics.tenant_stats("t0")["stream_pushes"] == 4
    jst = j_stream("facility", 128, d=24, universe=384, batch=32, seed=1)
    jsess = JSession("t0", j_make("facility", backend="ref"), 6, lanes=2,
                     merge_every=2, ground=jnp.asarray(jst.payloads),
                     backend="ref")
    for ids, pay, valid in jst:
        jsess.push(ids, pay, valid)
    np.testing.assert_array_equal(got.ids.numpy(),
                                  np.asarray(jsess.query().ids))
    np.testing.assert_allclose(info["merges"], jsess.info()["merges"],
                               atol=1e-4)


def test_session_manager_lifecycle():
    st = TSyn.gen_stream("facility", 64, d=16, universe=384, batch=32,
                         seed=2)
    obj = t_make("facility", device="cpu")
    ground = torch.as_tensor(st.payloads)
    mgr = SessionManager()
    s = mgr.open("alice", obj, 4, lanes=2, ground=ground)
    with pytest.raises(ValueError):
        mgr.open("alice", obj, 4)
    for ids, pay, valid in st:
        mgr.get("alice").push(ids, pay, valid)
    assert mgr.tenants() == ["alice"]
    sol = mgr.close("alice")
    assert bool(sol.valid.any()) and mgr.tenants() == []
    assert mgr.metrics.tenant_stats("alice")["stream_pushes"] == 2
    assert s.metrics is mgr.metrics


def test_empty_session_raises():
    obj = t_make("coverage", universe=64, device="cpu")
    with pytest.raises(ValueError):
        TenantSession("t", obj, 4).query()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_percentile_matches_reference():
    from repro.serving import percentile as jp
    assert percentile([], 50) is None
    assert percentile([3.0], 99) == 3.0
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0) == 1.0
    assert percentile(xs, 100) == 4.0
    assert percentile(xs, 50) == pytest.approx(2.5)
    assert percentile(xs, 99) == pytest.approx(3.97)
    rng = np.random.default_rng(0)
    for _ in range(10):
        v = list(rng.random(rng.integers(1, 30)))
        for q in (0, 13, 50, 99, 100):
            assert percentile(v, q) == jp(v, q)


def test_metrics_snapshot_with_fake_clock():
    t = [0.0]
    m = ServeMetrics(clock=lambda: t[0])
    t0 = m.submitted("a")
    t[0] = 0.25
    assert m.completed("a", t0, batched=True) == pytest.approx(0.25)
    t0b = m.submitted("b")
    t[0] = 0.5
    m.completed("b", t0b, batched=False)
    m.batch_executed("key", 2, 1, 0.1)
    snap = m.snapshot()
    assert snap["total_queries"] == 2
    assert snap["total_batches"] == 1
    assert snap["solo_fallbacks"] == 1
    assert snap["dispatches_per_batch"] == [1]
    assert snap["queries_per_s"] == pytest.approx(4.0)
    assert snap["tenants"]["a"]["p50_ms"] == pytest.approx(250.0)


def test_snapshot_json_roundtrips_with_empty_tenants():
    m = ServeMetrics(clock=lambda: 0.0)
    m.submitted("pending")
    m.stream_push("streamer")
    back = json.loads(json.dumps(m.snapshot(), allow_nan=False))
    assert back["tenants"]["pending"]["p50_ms"] is None
    assert back["tenants"]["pending"]["p99_ms"] is None
    assert back["tenants"]["streamer"]["p50_ms"] is None
    assert back["p50_ms"] is None and back["p99_ms"] is None
    t0 = m.submitted("live")
    m.completed("live", t0, batched=True)
    back = json.loads(json.dumps(m.snapshot(), allow_nan=False))
    assert back["tenants"]["live"]["p50_ms"] is not None
    assert back["tenants"]["pending"]["p50_ms"] is None
