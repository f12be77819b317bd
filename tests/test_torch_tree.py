"""The whole slice: the port's accumulation tree against the reference's.

`run_tree_dense` of both packages on the same numpy data, for kmedoid and
facility on two trees (the binary T(8, 2) and RandGreedi T(8, 8)). The
eval counts (`evals_total`, `evals_critical`, `per_node_evals`) and
`comm_elements` must be equal; root `ids` must be equal and `value`
agree within 1e-5 — unless the runs met a genuine tie.

Why ties need a rule: the data holds exact mathematical ties (for
kmedoid, two remaining elements that improve only each other's rows
score each other symmetrically; for facility on unit-norm data, the same
holds for mutually closest pairs), and at an exact tie the first-argmax
is decided by rounding — XLA and PyTorch sum in different orders. So a
lockstep walk holds the port against the reference at EVERY greedy and
every argmax{f(S), f(S_prev)} of the reference's own path, on identical
inputs: equal selections and decisions, except where a float64 oracle
shows the two choices' gains (or the two values) within the f32
rounding bound of each other. When the lockstep meets no tie, the whole
runs must agree exactly. Both packages are deterministic, so the full
runs' first divergence is a greedy or argmax that got identical inputs
on both — one on the reference's path, which the lockstep holds; when
the full runs differ, the lockstep must therefore have met a tie.

Also: the port's per-level launch accounting against the reference's
`ops.count_pallas_dispatches` on the interpret backend, tier for tier.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import greedy as JG
from repro.core import simulate as JS
from repro.core.functions import make_objective as j_make
from repro.core.tree import AccumulationTree as JTree
from repro.core.tree import randgreedi_tree as j_randgreedi
from repro.data.synthetic import gen_images
from repro.kernels import ops as JOps
from repro.kernels import plans as JPlans
from repro_torch.core import greedy as TG
from repro_torch.core import simulate as TS
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.tree import AccumulationTree as TTree
from repro_torch.core.tree import randgreedi_tree as t_randgreedi
from repro_torch.kernels import counters
from repro_torch.kernels import plans as TPlans

EPS32 = float(np.finfo(np.float32).eps)
N, D, K, M = 512, 64, 8, 8
TREES = {"binary": (lambda: JTree(M, 2), lambda: TTree(M, 2)),
         "randgreedi": (lambda: j_randgreedi(M), lambda: t_randgreedi(M))}


@pytest.fixture(scope="module")
def data():
    return gen_images(N, D, classes=8, seed=0)


# ---------------------------------------------------------------------------
# the float64 oracle of a genuine tie
# ---------------------------------------------------------------------------


def _entry_err(name, ground, cands):
    """Per-entry f32 error bound of the cached matrix, (N, C) float64:
    a D-term dot product rounds by ≤ D·eps·‖g‖‖c‖; the 'dist' expansion
    by B = D·eps·(‖g‖+‖c‖)² in squared form, i.e. ≤ min(√B, B/2d) in d."""
    g = ground.astype(np.float64)
    c = cands.astype(np.float64)
    gn = np.linalg.norm(g, axis=1)[:, None]
    cn = np.linalg.norm(c, axis=1)[None, :]
    dim = g.shape[1]
    if name == "facility":
        return 2 * dim * EPS32 * gn * cn
    b = 2 * dim * EPS32 * (gn + cn) ** 2
    dist = np.sqrt(np.maximum(((g[:, None, :] - c[None]) ** 2).sum(-1), 0))
    return np.minimum(np.sqrt(b), b / np.maximum(2 * dist, 1e-300))


def _matrix64(name, ground, cands):
    g = ground.astype(np.float64)
    c = cands.astype(np.float64)
    if name == "facility":
        return g @ c.T
    return np.sqrt(((g[:, None, :] - c[None]) ** 2).sum(-1))


def _row64(name, ground, gvalid, mat, prefix):
    """State row after folding the prefix columns, float64."""
    if name == "facility":
        row = np.where(gvalid, 0.0, 3.0e38)
        for j in prefix:
            row = np.maximum(row, mat[:, j])
    else:
        row = np.where(gvalid, np.linalg.norm(ground.astype(np.float64),
                                              axis=1), 0.0)
        for j in prefix:
            row = np.minimum(row, mat[:, j])
    return row


def _raw_gain64(name, row, col):
    part = (np.maximum(row - col, 0) if name == "kmedoid"
            else np.maximum(col - row, 0))
    return float(part.sum())


def _tie(name, ground, gvalid, pool, pool_valid, ids_a, ids_b, pool_ids):
    """Whether two greedies over the same inputs first differ at a genuine
    tie. ids_*: (k,) selected global ids (−1 = rejected)."""
    diff = np.nonzero(ids_a != ids_b)[0]
    s = int(diff[0])
    where = {int(e): j for j, e in enumerate(pool_ids) if e >= 0}
    mat = _matrix64(name, ground, pool)
    err = _entry_err(name, ground, pool)
    prefix = [where[int(e)] for e in ids_a[:s] if e >= 0]
    row = _row64(name, ground, gvalid, mat, prefix)
    gains, tols = [], []
    for e in (ids_a[s], ids_b[s]):
        if e < 0:
            gains.append(0.0)
            tols.append(0.0)
            continue
        j = where[int(e)]
        g = _raw_gain64(name, row, mat[:, j])
        gains.append(g)
        tols.append(float(err[:, j][gvalid].sum()) + 2 * len(row) * EPS32
                    * abs(g))
    return abs(gains[0] - gains[1]) <= tols[0] + tols[1] + 1e-12


# ---------------------------------------------------------------------------
# the lockstep walk on the reference's path
# ---------------------------------------------------------------------------


def _np_sol(sol):
    return {f: np.asarray(getattr(sol, f))
            for f in ("ids", "payloads", "valid", "value", "evals")}


def _hold_greedies(name, jsol, tsol, ground, gvalid, pools, pool_valid,
                   pool_ids):
    """Hold B port greedies against the reference's; returns ties met."""
    ties = 0
    t_ids = tsol.ids.numpy()
    for i in range(jsol["ids"].shape[0]):
        a, b = jsol["ids"][i].astype(np.int64), t_ids[i]
        assert int(jsol["evals"][i]) == int(tsol.evals[i])
        if np.array_equal(a, b):
            err = _entry_err(name, ground[i], pools[i])
            tol = float(err.max()) + 4 * EPS32 * abs(float(jsol["value"][i]))
            assert abs(float(jsol["value"][i])
                       - float(tsol.value[i])) <= tol + 1e-7
            continue
        assert _tie(name, ground[i], gvalid[i], pools[i], pool_valid[i], a,
                    b, pool_ids[i]), f"greedy {i}: {a} vs {b} is no tie"
        ties += 1
    return ties


def _lockstep(name, x, k, jtree, seed=0, hold=_hold_greedies):
    """Walk the tree along the reference's decisions, holding the port's
    greedy_batch / replay_value / select_better at every node (each
    level's greedies by `hold`, `_hold_greedies`' signature)."""
    jobj = j_make(name, backend="ref")
    tobj = t_make(name, device="cpu")
    n = x.shape[0]
    m, b, L = jtree.m, jtree.b, jtree.num_levels
    pool_ids, pool_valid = TS._pools(JS.partition(n, m, seed), m)
    pay = x[np.maximum(pool_ids, 0)] * pool_valid[..., None]
    jleaf = jax.vmap(lambda i, p, v: JG.greedy(jobj, i, p, v, k))
    sols = _np_sol(jleaf(jnp.asarray(pool_ids, jnp.int32), jnp.asarray(pay),
                         jnp.asarray(pool_valid)))
    tsol = TG.greedy_batch(tobj, torch.as_tensor(pool_ids),
                           torch.as_tensor(pay), torch.as_tensor(pool_valid),
                           k)
    ties = hold(name, sols, tsol, pay, pool_valid, pay, pool_valid,
                          pool_ids)
    level_ids = list(range(m))
    for lvl in range(1, L + 1):
        nodes = jtree.nodes_at_level(lvl)
        bk = b * k
        u_ids = np.full((len(nodes), bk), -1, np.int64)
        u_val = np.zeros((len(nodes), bk), bool)
        u_pay = np.zeros((len(nodes), bk, x.shape[1]), np.float32)
        for r, nid in enumerate(nodes):
            for j, cid in enumerate(jtree.children_of(lvl, nid)):
                row = level_ids.index(cid)
                u_ids[r, j * k:(j + 1) * k] = sols["ids"][row]
                u_val[r, j * k:(j + 1) * k] = sols["valid"][row]
                u_pay[r, j * k:(j + 1) * k] = sols["payloads"][row]
        jnode = jax.vmap(lambda i, p, v: JG.greedy(jobj, i, p, v, k,
                                                   ground=p, ground_valid=v))
        jnew = _np_sol(jnode(jnp.asarray(u_ids, jnp.int32),
                             jnp.asarray(u_pay), jnp.asarray(u_val)))
        tnew = TG.greedy_batch(tobj, torch.as_tensor(u_ids),
                               torch.as_tensor(u_pay), torch.as_tensor(u_val),
                               k)
        ties += hold(name, jnew, tnew, u_pay, u_val, u_pay, u_val,
                               u_ids)
        prev_rows = np.asarray([level_ids.index(nid) for nid in nodes])
        prev = {f: v[prev_rows] for f, v in sols.items()}
        jscore = np.asarray(jax.vmap(
            lambda p, v, g, gv: JG.replay_value(jobj, p, v, g, gv))(
                jnp.asarray(prev["payloads"]), jnp.asarray(prev["valid"]),
                jnp.asarray(u_pay), jnp.asarray(u_val)))
        tscore = TG.replay_value(tobj, torch.as_tensor(prev["payloads"]),
                                 torch.as_tensor(prev["valid"]),
                                 torch.as_tensor(u_pay),
                                 torch.as_tensor(u_val)).numpy()
        for r in range(len(nodes)):
            err = _entry_err(name, u_pay[r], u_pay[r])
            tol = 2 * float(err.max()) + 8 * EPS32 * abs(float(jscore[r]))
            assert abs(float(jscore[r]) - float(tscore[r])) <= tol
            take_j = jnew["value"][r] >= jscore[r]
            take_t = float(tnew.value[r]) >= float(tscore[r])
            if take_j != take_t:
                assert abs(float(jnew["value"][r]) - float(jscore[r])) \
                    <= 2 * tol, f"node {nodes[r]}: argmax is no tie"
                ties += 1
        take = (jnew["value"] >= jscore)
        sols = {f: np.where(take.reshape((-1,) + (1,) * (jnew[f].ndim - 1)),
                            jnew[f], prev[f]) for f in ("ids", "payloads",
                                                         "valid")}
        sols["value"] = np.where(take, jnew["value"], jscore)
        sols["evals"] = jnew["evals"] + prev["evals"]
        level_ids = nodes
    return ties


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_pools_match_reference_element_loop():
    """The vectorized pool build gives the pools of the reference's
    per-element loop (simulate.py ~118-130)."""
    n, m = 300, 7
    assign = JS.partition(n, m, 4)
    counts = np.bincount(assign, minlength=m)
    want_ids = np.full((m, counts.max()), -1, np.int64)
    cursor = np.zeros(m, np.int64)
    for e in range(n):
        want_ids[assign[e], cursor[assign[e]]] = e
        cursor[assign[e]] += 1
    ids, valid = TS._pools(assign, m)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(valid, want_ids >= 0)


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_run_tree_dense_matches_reference(name, tree, data):
    jt, tt = TREES[tree]
    want = JS.run_tree_dense(name, data, K, jt(), seed=0, backend="ref")
    got = TS.run_tree_dense(name, data, K, tt(), seed=0, device="cpu")
    assert got.evals_total == want.evals_total
    assert got.evals_critical == want.evals_critical
    assert got.per_node_evals == want.per_node_evals
    assert got.comm_elements == want.comm_elements
    assert (got.levels, got.machines, got.branching) == (
        want.levels, want.machines, want.branching)
    ties = _lockstep(name, data, K, jt())
    same = np.array_equal(got.ids, np.asarray(want.ids, np.int64))
    # runs that differ must have split at a tie the lockstep met
    assert same or ties >= 1, (got.ids, want.ids)
    if same:
        assert abs(got.value - want.value) <= 1e-5


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_run_tree_dense_augment_and_lost_leaves_match_reference(name, data):
    """The node-augmentation images (drawn from the same numpy tape) and
    lost partitions (`drop_leaves`) on RandGreedi T(8, 8)."""
    want = JS.run_tree_dense(name, data, K, j_randgreedi(M), seed=0,
                             backend="ref", augment=16, drop_leaves=(3,))
    got = TS.run_tree_dense(name, data, K, t_randgreedi(M), seed=0,
                            device="cpu", augment=16, drop_leaves=(3,))
    assert got.per_node_evals == want.per_node_evals
    assert got.comm_elements == want.comm_elements
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids, np.int64))
    assert abs(got.value - want.value) <= 1e-5


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_run_greedy_dense_matches_reference(name, data):
    want = JS.run_greedy_dense(name, data[:200], K, backend="ref")
    got = TS.run_greedy_dense(name, data[:200], K, device="cpu")
    assert got.evals_total == want.evals_total
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids, np.int64))
    assert abs(got.value - want.value) <= 1e-5


def test_global_value_matches_reference(data):
    ids = np.array([3, 17, 250, 411, -1])
    for name in ("kmedoid", "facility"):
        want = JS.global_value(name, data, ids)
        got = TS.global_value(name, data, ids, device="cpu")
        assert abs(got - want) <= 1e-6


# ---------------------------------------------------------------------------
# launch accounting, tier for tier
# ---------------------------------------------------------------------------


def _jax_level_dispatches(name, x, k, m, b, seed):
    """Dispatches per level of the reference's dense tree, counted from
    the jaxprs of its vmapped leaf stage, node stage and replay on the
    interpret backend (levels of T(m, b) share one node shape)."""
    obj = j_make(name, backend="interpret")
    pool_ids, pool_valid = TS._pools(JS.partition(x.shape[0], m, seed), m)
    pay = x[np.maximum(pool_ids, 0)] * pool_valid[..., None]
    with JOps.fused_replicas(m):
        leaf = jax.make_jaxpr(jax.vmap(
            lambda i, p, v: JG.greedy(obj, i, p, v, k)))(
                jnp.asarray(pool_ids, jnp.int32), jnp.asarray(pay),
                jnp.asarray(pool_valid))
    nodes = m // b
    u_ids = jnp.zeros((nodes, b * k), jnp.int32)
    u_pay = jnp.zeros((nodes, b * k, x.shape[1]), jnp.float32)
    u_val = jnp.ones((nodes, b * k), bool)
    with JOps.fused_replicas(nodes):
        node = jax.make_jaxpr(jax.vmap(
            lambda i, p, v: JG.greedy(obj, i, p, v, k, ground=p,
                                      ground_valid=v)))(u_ids, u_pay, u_val)
    replay = jax.make_jaxpr(jax.vmap(
        lambda p, v, g, gv: JG.replay_value(obj, p, v, g, gv)))(
            jnp.zeros((nodes, k, x.shape[1])), jnp.ones((nodes, k), bool),
            u_pay, u_val)
    count = JOps.count_pallas_dispatches
    return (count(leaf.jaxpr),
            count(node.jaxpr) + count(replay.jaxpr))


def _port_level_calls(name, x, k, tree):
    per_level = []
    counters.reset()

    def record(lvl):
        snap = counters.snapshot()
        per_level.append({n: c["calls"] for n, c in snap.items()})
        counters.reset()

    TS.run_tree_dense(name, x, k, tree, seed=0, device="cpu",
                      on_level=record)
    return per_level


def _tiers(name, x, k, m, b):
    n_leaf = int(np.bincount(JS.partition(x.shape[0], m, 0),
                             minlength=m).max())
    d = x.shape[1]
    rule_j = j_make(name, backend="interpret").rule
    rule_t = t_make(name, device="cpu").rule
    with JOps.fused_replicas(m):
        jl = JPlans.select_engine(rule_j, n_leaf, n_leaf, d,
                                  backend="interpret").engine
    with JOps.fused_replicas(m // b):
        jn = JPlans.select_engine(rule_j, b * k, b * k, d,
                                  backend="interpret").engine
    tl = TPlans.select_engine(rule_t, n_leaf, n_leaf, d, replicas=m).engine
    tn = TPlans.select_engine(rule_t, b * k, b * k, d,
                              replicas=m // b).engine
    return (jl, jn), (tl, tn)


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_level_launches_match_reference_resident(name, data):
    """Default budgets at this size: both planners send leaves and nodes
    to the resident tier — 1 launch per leaf stage, 1 resident + 1
    replay pairwise per level."""
    (jl, jn), (tl, tn) = _tiers(name, data, K, M, 2)
    assert (jl, jn) == (tl, tn) == ("mega_resident", "mega_resident")
    leaf_j, level_j = _jax_level_dispatches(name, data, K, M, 2, 0)
    calls = _port_level_calls(name, data, K, TTree(M, 2))
    assert leaf_j == 1 and level_j == 2
    assert sum(calls[0].values()) == leaf_j
    assert calls[0].get("greedy_loop_resident") == 1
    for lvl in calls[1:]:
        assert sum(lvl.values()) == level_j
        assert lvl.get("greedy_loop_resident") == 1
        assert lvl.get("pairwise") == 1


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_level_launches_match_reference_streaming(name, data, monkeypatch):
    """Budgets shrunk in both packages so the leaves cannot be resident:
    the reference's VMEM budget admits its streaming loop but not the
    resident working set, the port's L2 share admits no resident batch
    of leaves. Leaves: pairwise + streaming loop = 2 launches in both."""
    monkeypatch.setenv("REPRO_FUSED_VMEM_MB", "0.14")
    n_leaf = int(np.bincount(JS.partition(N, M, 0), minlength=M).max())
    l2_mb = (M * n_leaf * n_leaf * 4 - 1) / 2 ** 20
    monkeypatch.setenv("REPRO_TORCH_RESIDENT_L2_MB", str(l2_mb))
    (jl, jn), (tl, tn) = _tiers(name, data, K, M, 2)
    assert jl == tl == "mega_stream"
    leaf_j, level_j = _jax_level_dispatches(name, data, K, M, 2, 0)
    calls = _port_level_calls(name, data, K, TTree(M, 2))
    assert leaf_j == 2
    assert calls[0]["pairwise"] == calls[0]["greedy_loop"] == 1
    assert sum(calls[0].values()) == leaf_j
    assert jn == tn == "mega_resident"
    for lvl in calls[1:]:
        assert sum(lvl.values()) == level_j == 2
        assert lvl["greedy_loop_resident"] == lvl["pairwise"] == 1
