"""The memory-capped cache tiers: bf16 and int8 cached matrices.

The planner steps a feature rule's cache storage down f32 → bf16 → int8
as each rung busts the device-memory budget (or one rung is forced):
REPRO_TORCH_FUSED_CACHE_MB / REPRO_TORCH_FUSED_CACHE_DTYPE in the port,
REPRO_FUSED_CACHE_MB / REPRO_FUSED_CACHE_DTYPE in the reference.

  * the per-module plain versions over a stored cache against the
    reference's Pallas kernels in interpret mode (`pairwise_pallas` with a
    bf16 output, `fused_step_pallas` and `greedy_loop_pallas` with and
    without int8 scales);
  * the int8 cache built in chunks of greedies equals the one-shot
    `quantize_rows` bit for bit; `apply_column` gathers a column in its
    storage and equals the whole matrix's dequant; the planner's bytes
    (`cache_bytes` counts the int8 scale rows, `resident_fits` the
    rung's bytes: the resident steps keep the rung's matrix, as the
    reference's gate counts them) and its verdicts at the
    Tiny-ImageNet leaves under 1,024 MB (bf16) and 512 MB (int8);
  * whole trees under each forced rung: `run_tree_dense` (kmedoid,
    facility; leaves resident, and streaming with the L2 share shrunk as
    `test_torch_tree.test_level_launches_match_reference_streaming`
    does) and the knapsack `LevelDispatcher`, against the reference in
    the lockstep walks of tests/test_torch_tree.py and
    tests/test_torch_greedyml.py.

The trees run on small-integer features. There both packages build every
f32 matrix entry exactly ('dot' an integer, 'dist' the correctly rounded
square root of one), so their bf16 and int8 caches are equal bit for bit
— which `_stored64` asserts for every greedy it holds. A greedy must then
equal the reference's, or split where a float64 oracle over that stored
cache shows the two choices' gains within the f32 reordering bound of
their sums (ROADMAP §C P1, with no entry error left to allow for).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as JC
from repro.core import greedyml as JGML
from repro.core import simulate as JS
from repro.core.functions import make_objective as j_make
from repro.core.tree import AccumulationTree as JTree
from repro.kernels import ops as JOps
from repro.kernels import rules as JR
from repro.kernels.fused_step import fused_step_pallas
from repro.kernels.greedy_loop import greedy_loop_pallas
from repro.kernels.pairwise import pairwise_pallas
from repro_torch.configs import paper_kmedoid
from repro_torch.core import constraints as TC
from repro_torch.core import greedyml as TGML
from repro_torch.core import simulate as TS
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.tree import AccumulationTree as TTree
from repro_torch.kernels import counters
from repro_torch.kernels import fused_step as TF
from repro_torch.kernels import greedy_loop as TL
from repro_torch.kernels import ops as TOps
from repro_torch.kernels import pairwise as TP
from repro_torch.kernels import parity
from repro_torch.kernels import plans as TPlans
from repro_torch.kernels import ref as TRef
from repro_torch.kernels import rules as TR
from repro_torch.runtime import flags
import test_torch_greedyml as TGtest
import test_torch_tree as TTtest
from test_torch_tree import EPS32

RULES = {"kmedoid": (JR.DIST_MIN, TR.DIST_MIN),
         "facility": (JR.DOT_MAX, TR.DOT_MAX)}
RUNG = {"bfloat16": "bf16", "int8": "int8"}


def _int_features(n, d, seed):
    """Small-integer features: every f32 matrix entry exact in both
    packages."""
    return np.random.default_rng(seed).integers(-3, 4, (n, d)).astype(
        np.float32)


def _force(monkeypatch, dtype):
    """Force one storage rung in both packages."""
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, RUNG[dtype])
    monkeypatch.setenv("REPRO_FUSED_CACHE_DTYPE", RUNG[dtype])


def _t(x):
    return torch.as_tensor(np.array(x))


def _stored_np(mat):
    """A cache of either package as f32 numpy values."""
    if isinstance(mat, TOps.QuantMatrix):
        return TR.dequant(mat.q, mat.scale).numpy()
    if isinstance(mat, torch.Tensor):
        return mat.to(torch.float32).numpy()
    return np.asarray(JOps._dequant_mat(mat)).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dot", "dist"])
def test_pairwise_bf16_plain_matches_interpret_kernel(mode):
    """bf16 output: the f32 entries rounded to nearest even, as the
    reference's kernel stores them. On integer features the f32 entries
    are exact in both, so the bf16 caches are equal bit for bit."""
    g = _int_features(256, 128, 1)
    c = _int_features(128, 128, 2)
    want = pairwise_pallas(jnp.asarray(g), jnp.asarray(c), mode=mode,
                           out_dtype="bfloat16", interpret=True)
    counters.reset()
    got = TP.pairwise(_t(g)[None], _t(c)[None], mode,
                      out_dtype=torch.bfloat16)[0]
    assert got.dtype == torch.bfloat16
    assert counters.snapshot()["pairwise[bf16]"] == {"calls": 1,
                                                     "launches": 0}
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def _stored_cache(jr, dtype, seed):
    """A (256, 128) cache in `dtype` built by the reference's 'ref'
    backend from real-valued features, and a live state row."""
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1, (256, 16)).astype(np.float32)
    c = rng.normal(0, 1, (128, 16)).astype(np.float32)
    mat = JOps.pairwise_matrix(jnp.asarray(g), jnp.asarray(c), jr,
                               backend="ref", dtype=dtype)
    row = np.asarray(JR.empty_row(jnp.asarray(g), jnp.ones(256, bool), jr))
    logical = JOps._dequant_mat(mat)
    for j in (3, 40):
        row = np.asarray(JR.fold_winner(jnp.asarray(row), logical[:, j],
                                        jnp.int32(j), jr))
    mask = (rng.random(128) > 0.25).astype(np.float32)
    return mat, row, mask


def _port_cache(mat):
    """The reference's stored cache as the port's (B = 1) kernel operands
    (matrix, scale)."""
    if isinstance(mat, JOps.QuantMatrix):
        return _t(mat.q)[None], _t(mat.scale)[None]
    return _t(np.asarray(mat).astype(np.float32)).to(torch.bfloat16)[None], \
        None


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(RULES))
def test_fused_step_plain_matches_interpret_kernel_quant(name, dtype):
    """`fused_step_pallas` over a stored bf16/int8 cache (`_kernel_quant`
    with its scales) against the port's fused_step over the same storage:
    rows equal bit for bit, the pick equal, the gain within 1e-5
    relative (the two sum in other orders)."""
    jr, tr = RULES[name]
    mat, row, mask = _stored_cache(jr, dtype, 3)
    quant = isinstance(mat, JOps.QuantMatrix)
    w_row, w_best, w_gain = fused_step_pallas(
        mat.q if quant else mat, jnp.asarray(row), jnp.asarray(mask),
        jnp.int32(7), jr, block_n=128, interpret=True,
        scale=mat.scale if quant else None)
    tmat, scale = _port_cache(mat)
    counters.reset()
    g_row, g_best, g_gain = TF.fused_step(tmat, _t(row)[None],
                                          _t(mask)[None], torch.tensor([7]),
                                          tr, scale=scale)
    tag = "[int8]" if quant else "[bf16]"
    assert counters.snapshot()["fused_step" + tag]["calls"] == 1
    np.testing.assert_array_equal(g_row[0].numpy(), np.asarray(w_row))
    assert int(g_best[0]) == int(w_best)
    np.testing.assert_allclose(float(g_gain[0]), float(w_gain), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(RULES))
def test_greedy_loop_plain_matches_interpret_kernel_quant(name, dtype):
    """`greedy_loop_pallas` over a stored bf16/int8 cache
    (`_stream_kernel_quant`) against the port's streaming loop over the
    same storage, held by kernels/parity.py's loop rule (same matrix: no
    entry differences)."""
    jr, tr = RULES[name]
    mat, row, mask = _stored_cache(jr, dtype, 4)
    quant = isinstance(mat, JOps.QuantMatrix)
    want = greedy_loop_pallas(mat.q if quant else mat,
                              jnp.asarray(row)[None], jnp.asarray(mask)[None],
                              8, jr, block_n=128, interpret=True,
                              scale=mat.scale if quant else None)
    tmat, scale = _port_cache(mat)
    got = TL.greedy_loop(tmat, _t(row)[None], _t(mask)[None], 8, tr,
                         scale=scale)
    res = parity.compare_loops(
        got, tuple(_t(w)[None] for w in want), tr,
        what=f"greedy_loop {name} {dtype}")
    assert res["ties"] == 0


# ---------------------------------------------------------------------------
# the chunked int8 build, the column flush, the planner's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(RULES))
def test_int8_cache_built_in_chunks_equals_one_shot(name, monkeypatch):
    """5 greedies in chunks of 2 (three pairwise calls), each chunk
    quantized in place, against quantize_rows of the whole f32 build —
    and that against the reference's quantize_rows of the same f32
    matrix: q and scales equal bit for bit."""
    _, tr = RULES[name]
    rng = np.random.default_rng(5)
    g = _t(rng.normal(0, 2, (5, 37, 16)).astype(np.float32))
    c = _t(rng.normal(0, 2, (5, 29, 16)).astype(np.float32))
    monkeypatch.setattr(TPlans, "QUANT_CHUNK_BYTES", 2 * 4 * 37 * 29 + 1)
    assert TPlans.quant_chunk(37, 29) == 2
    counters.reset()
    got = TOps.pairwise_matrix(g, c, tr, dtype="int8")
    assert counters.snapshot()["pairwise"]["calls"] == 3
    whole = TP.pairwise_plain(g, c, tr.pairwise)
    q, scale = TR.quantize_rows(whole)
    assert torch.equal(got.q, q) and torch.equal(got.scale, scale)
    assert got.q.dtype == torch.int8 and got.scale.shape == (5, 1, 37)
    for i in range(5):
        jq, js = JR.quantize_rows(jnp.asarray(whole[i].numpy()))
        np.testing.assert_array_equal(q[i].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale[i].numpy(), np.asarray(js))


def test_quantize_rows_in_place_and_division():
    """Quantizing into an int8 `out` with the input as the work buffer
    gives the bits of the out-of-place call, and the scale is an IEEE
    division by 127 (not a product with 1/127)."""
    rng = np.random.default_rng(6)
    m = rng.normal(0, 3, (4, 50, 33)).astype(np.float32)
    m[1, 7] = 0.0
    q0, s0 = TR.quantize_rows(_t(m))
    out = torch.empty(m.shape, dtype=torch.int8)
    q1, s1 = TR.quantize_rows(_t(m), out=out)
    assert q1 is out
    assert torch.equal(q0, q1) and torch.equal(s0, s1)
    amax = np.abs(m).max(-1)
    want = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0))
    np.testing.assert_array_equal(s0[:, 0].numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(RULES))
def test_apply_column_equals_the_whole_matrix_dequant(name, dtype):
    """The final-winner flush gathers each greedy's column in its storage
    and widens only it: the same bits as dequantizing the whole cache."""
    _, tr = RULES[name]
    rng = np.random.default_rng(7)
    g = _t(rng.normal(0, 1, (3, 21, 8)).astype(np.float32))
    c = _t(rng.normal(0, 1, (3, 13, 8)).astype(np.float32))
    mat = TOps.pairwise_matrix(g, c, tr, dtype=dtype)
    row = TR.empty_row(g, torch.ones(3, 21, dtype=torch.bool), tr)
    idx = torch.tensor([4, -1, 12])
    got = TOps.apply_column(mat, row, idx, tr)
    whole = TOps._dequant_mat(mat)
    want = TR.fold_winner(row, TRef.column(whole, idx), idx, tr)
    assert torch.equal(got, want)
    assert torch.equal(got[1], row[1])             # idx −1 folds nothing


def test_cache_bytes_count_the_int8_scale_rows():
    g = torch.rand(3, 40, 8)
    c = torch.rand(3, 25, 8)
    q = TOps.pairwise_matrix(g, c, TR.DOT_MAX, dtype="int8")
    assert TPlans.cache_bytes(40, 25, "int8", 3) == (
        q.q.numel() * q.q.element_size()
        + q.scale.numel() * q.scale.element_size()) == 3 * (40 * 25 + 160)
    b = TOps.pairwise_matrix(g, c, TR.DOT_MAX, dtype="bfloat16")
    assert TPlans.cache_bytes(40, 25, "bfloat16", 3) == b.numel() * 2


def test_resident_gate_counts_the_f32_scratch(monkeypatch):
    """The resident kernel's f32 build is a scratch written once and read
    once; its steps keep the rung's matrix: an int8 plan is admitted to
    L2 where the int8 bytes (and row scales) fit, even where the f32
    build's would not, as the reference's gate counts the itemsize."""
    n, reps = 400, 16
    f32 = reps * n * n * 4
    q8 = TPlans.cache_bytes(n, n, "int8", reps)
    assert q8 == reps * (n * n + 4 * n)
    monkeypatch.setenv(flags.RESIDENT_L2_MB_ENV, str((f32 - 1) / 2 ** 20))
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    assert not TPlans.resident_fits(n, n, 64, TR.DIST_MIN, replicas=reps)
    assert TPlans.resident_fits(n, n, 64, TR.DIST_MIN, replicas=reps,
                                dtype="int8")
    plan = TPlans.fused_plan(n, n, 64, TR.DIST_MIN, replicas=reps)
    assert plan["dtype"] == "int8" and plan["tier"] == "resident"
    monkeypatch.setenv(flags.RESIDENT_L2_MB_ENV, str((q8 - 1) / 2 ** 20))
    plan = TPlans.fused_plan(n, n, 64, TR.DIST_MIN, replicas=reps)
    assert plan["dtype"] == "int8" and plan["tier"] == "streaming"


@pytest.mark.parametrize("budget_mb,dtype", [(None, "float32"),
                                             (1024, "bfloat16"),
                                             (512, "int8")])
def test_planner_ladder_at_tiny_imagenet(budget_mb, dtype, monkeypatch):
    """32 leaves × 3,284²: f32 1.38 GB busts 1,024 MB and bf16 0.69 GB
    fits; under 512 MB only int8 (0.345 GB + scales) does. The leaves
    stream; the nodes (16 × 400², 10.2 MB) stay f32 and resident."""
    cfg = paper_kmedoid.TINY_IMAGENET
    if budget_mb is not None:
        monkeypatch.setenv(flags.FUSED_CACHE_MB_ENV, str(budget_mb))
    n_leaf = int(np.bincount(TS.partition(cfg.n, cfg.num_machines,
                                          cfg.seed)).max())
    assert n_leaf == 3284
    leaf = TPlans.select_engine(TR.DIST_MIN, n_leaf, n_leaf, cfg.feature_dim,
                                replicas=cfg.num_machines)
    assert (leaf.engine, leaf.dtype) == ("mega_stream", dtype)
    assert leaf.loop_block_n == TPlans.LOOP_BLOCK_MAX
    bk = cfg.branching * cfg.k
    node = TPlans.select_engine(TR.DIST_MIN, bk, bk, cfg.feature_dim,
                                replicas=cfg.num_machines // cfg.branching)
    assert (node.engine, node.dtype) == ("mega_resident", "float32")


# ---------------------------------------------------------------------------
# whole trees under a forced rung, in lockstep with the reference
# ---------------------------------------------------------------------------

_OBJ = {}


def _objectives(name):
    if name not in _OBJ:
        _OBJ[name] = (j_make(name, backend="ref"), t_make(name, device="cpu"))
    return _OBJ[name]


def _stored64(name, dtype, ground, pool):
    """The (N, C) cache a greedy over `pool` with evaluation rows `ground`
    runs on, float64 — asserted equal bit for bit in both packages."""
    jobj, tobj = _objectives(name)
    t = _stored_np(TOps.pairwise_matrix(_t(ground)[None], _t(pool)[None],
                                        tobj.rule, dtype=dtype))[0]
    j = _stored_np(JOps.pairwise_matrix(jnp.asarray(ground),
                                        jnp.asarray(pool), jobj.rule,
                                        backend="ref", dtype=dtype))
    np.testing.assert_array_equal(t, j)
    return t.astype(np.float64)


def _start_row64(name, ground, gvalid):
    """The empty solution's state row as both packages hold it: the f32
    norms (correctly rounded square roots of exact integers) for
    kmedoid, 0 for facility; invalid rows at their pad value."""
    if name == "facility":
        return np.where(gvalid, 0.0, 3.0e38)
    norm = np.linalg.norm(ground.astype(np.float64), axis=1)
    return np.where(gvalid, norm.astype(np.float32), 0.0).astype(np.float64)


def _tie_stored(name, mat, ground, gvalid, ids_a, ids_b, pool_ids):
    """Whether two greedies over the same stored cache first differ at a
    genuine tie: the float64 gains of both choices, after the common
    prefix, within the f32 reordering bound 2·N·eps·|g| of each."""
    s = int(np.nonzero(ids_a != ids_b)[0][0])
    where = {int(e): j for j, e in enumerate(pool_ids) if e >= 0}
    row = _start_row64(name, ground, gvalid)
    for e in ids_a[:s]:
        if e >= 0:
            col = mat[:, where[int(e)]]
            row = (np.minimum(row, col) if name == "kmedoid"
                   else np.maximum(row, col))
    gains, tols = [], []
    for e in (ids_a[s], ids_b[s]):
        g = (0.0 if e < 0 else
             TTtest._raw_gain64(name, row, mat[:, where[int(e)]]))
        gains.append(g)
        tols.append(2 * len(row) * EPS32 * abs(g))
    return abs(gains[0] - gains[1]) <= tols[0] + tols[1] + 1e-12


def _value_tol(name, ground, gvalid, value):
    """Two f32 evaluations of one solution over the same rows differ by
    their sums' order: 2·N·eps of the terms (kmedoid's value is the base
    term less the mean row, each at most the base)."""
    base = (float(np.mean(_start_row64(name, ground, gvalid)[gvalid]))
            if name == "kmedoid" and gvalid.any() else 0.0)
    return 2 * len(gvalid) * EPS32 * (2 * abs(base) + abs(value)) + 1e-7


def _hold_lane(dtype):
    """test_torch_greedyml._hold_greedy over the stored cache."""
    def hold(name, want, got, ground, gvalid, pool, pool_ids):
        mat = _stored64(name, dtype, ground, pool)
        if np.array_equal(want["ids"], got["ids"]):
            assert np.array_equal(want["valid"], got["valid"])
            assert int(want["evals"]) == int(got["evals"])
            assert abs(float(want["value"]) - float(got["value"])) <= \
                _value_tol(name, ground, gvalid, float(want["value"]))
            return 0
        assert _tie_stored(name, mat, ground, gvalid,
                           want["ids"].astype(np.int64),
                           np.asarray(got["ids"], np.int64), pool_ids), (
                               want["ids"], got["ids"])
        return 1
    return hold


def _hold_levels(dtype):
    """test_torch_tree._hold_greedies over the stored caches."""
    lane = _hold_lane(dtype)

    def hold(name, jsol, tsol, ground, gvalid, pools, pool_valid, pool_ids):
        ties = 0
        for i in range(jsol["ids"].shape[0]):
            want = {f: v[i] for f, v in jsol.items()}
            got = {"ids": tsol.ids[i].numpy(), "valid": tsol.valid[i].numpy(),
                   "evals": tsol.evals[i], "value": tsol.value[i]}
            ties += lane(name, want, got, ground[i], gvalid[i], pools[i],
                         pool_ids[i])
        return ties
    return hold


@pytest.mark.parametrize("leaves", ["resident", "streaming"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(RULES))
def test_run_tree_dense_matches_reference(name, dtype, leaves, monkeypatch):
    """run_tree_dense on T(8, 2) under a forced rung: eval counts and
    communication equal, every greedy held in the lockstep walk, the
    roots equal unless the walk met a tie. Streaming leaves: the L2
    share admits no resident batch of leaves, so they run the pairwise
    build + the streaming loop over the stored cache; the nodes run the
    resident loop with the rung's rounding."""
    _force(monkeypatch, dtype)
    n, m = TTtest.N, TTtest.M
    x = _int_features(n, TTtest.D, 11)
    if leaves == "streaming":
        n_leaf = int(np.bincount(JS.partition(n, m, 0), minlength=m).max())
        stored = TPlans.cache_bytes(n_leaf, n_leaf, dtype, m)
        monkeypatch.setenv(flags.RESIDENT_L2_MB_ENV,
                           str((stored - 1) / 2 ** 20))
    want = JS.run_tree_dense(name, x, TTtest.K, JTree(m, 2), seed=0,
                             backend="ref")
    calls = []

    def record(lvl):
        calls.append({k: c["calls"] for k, c in counters.snapshot().items()
                      if c["calls"]})
        counters.reset()

    counters.reset()
    got = TS.run_tree_dense(name, x, TTtest.K, TTree(m, 2), seed=0,
                            device="cpu", on_level=record)
    tag = "[bf16]" if dtype == "bfloat16" else "[int8]"
    if leaves == "streaming":
        assert calls[0] == {("pairwise" + tag if dtype == "bfloat16"
                             else "pairwise"): 1, "greedy_loop" + tag: 1}
    else:
        assert calls[0] == {"greedy_loop_resident" + tag: 1}
    for lvl in calls[1:]:
        assert lvl == {"greedy_loop_resident" + tag: 1, "pairwise": 1}
    assert got.evals_total == want.evals_total
    assert got.per_node_evals == want.per_node_evals
    assert got.comm_elements == want.comm_elements
    ties = TTtest._lockstep(name, x, TTtest.K, JTree(m, 2),
                            hold=_hold_levels(dtype))
    same = np.array_equal(got.ids, np.asarray(want.ids, np.int64))
    # runs that differ must have split at a tie the lockstep met
    assert same or ties >= 1, (got.ids, want.ids)
    if same:
        assert abs(got.value - want.value) <= 1e-5


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(RULES))
def test_rung_bytes_admit_resident_nodes(name, dtype, monkeypatch):
    """run_tree_dense on T(8, 2) under a forced rung with an L2 share just
    short of a level-1 node batch's f32 matrices: the planner refuses the
    batch at f32 and admits it in the rung's bytes, so every node level
    runs the resident loop (mega_resident) over the rung's matrices; the
    tree equals the reference's on its ref backend (the roots unless the
    lockstep walk met a tie)."""
    n, m, k, d = TTtest.N, TTtest.M, TTtest.K, TTtest.D
    nodes, bk = m // 2, 2 * k
    f32 = TPlans.cache_bytes(bk, bk, "float32", nodes)
    monkeypatch.setenv(flags.RESIDENT_L2_MB_ENV, str((f32 - 1) / 2 ** 20))
    rule = RULES[name][1]
    assert TPlans.select_engine(rule, bk, bk, d,
                                replicas=nodes).engine == "mega_stream"
    _force(monkeypatch, dtype)
    plan = TPlans.select_engine(rule, bk, bk, d, replicas=nodes)
    assert (plan.engine, plan.dtype) == ("mega_resident", dtype)
    x = _int_features(n, d, 13)
    want = JS.run_tree_dense(name, x, k, JTree(m, 2), seed=0, backend="ref")
    calls = []

    def record(lvl):
        calls.append({c: v["calls"] for c, v in counters.snapshot().items()
                      if v["calls"]})
        counters.reset()

    counters.reset()
    got = TS.run_tree_dense(name, x, k, TTree(m, 2), seed=0, device="cpu",
                            on_level=record)
    tag = "[bf16]" if dtype == "bfloat16" else "[int8]"
    for lvl in calls[1:]:
        assert lvl.get("greedy_loop_resident" + tag) == 1, calls
    assert got.evals_total == want.evals_total
    ties = TTtest._lockstep(name, x, k, JTree(m, 2), hold=_hold_levels(dtype))
    same = np.array_equal(got.ids, np.asarray(want.ids, np.int64))
    assert same or ties >= 1, (got.ids, want.ids)
    if same:
        assert abs(got.value - want.value) <= 1e-5


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(RULES))
def test_knapsack_tree_matches_reference(name, dtype, monkeypatch):
    """The knapsack LevelDispatcher under a forced rung (every stage on
    the fused engine over the stored cache, the final winner flushed by
    apply_column), walked as test_torch_greedyml walks it, with
    small-integer features and evaluation rows; spent ≤ budget."""
    _force(monkeypatch, dtype)
    data = _int_features(TGtest.N, TGtest.D, 12)
    aug = _int_features(32, TGtest.D, 13)
    costs = TGtest._costs()
    jobj, tobj = _objectives(name)
    jd = JGML.LevelDispatcher(jobj, TGtest.K, TGtest.RADICES,
                              constraint=JC.KnapsackSpec(
                                  jnp.asarray(costs), TGtest.BUDGET))
    td = TGML.LevelDispatcher(tobj, TGtest.K, TGtest.RADICES,
                              constraint=TC.KnapsackSpec(
                                  torch.as_tensor(costs), TGtest.BUDGET))
    counters.reset()
    _, root = TGtest._lockstep(name, data, jd, td, aug, hold=_hold_lane(dtype))
    tag = "[bf16]" if dtype == "bfloat16" else "[int8]"
    assert counters.snapshot()["fused_step" + tag]["calls"] > 0
    spent = TC.KnapsackSpec(torch.as_tensor(costs), TGtest.BUDGET).spent(
        torch.as_tensor(root["ids"], dtype=torch.int64),
        torch.as_tensor(root["valid"]))
    assert bool((spent <= TGtest.BUDGET).all())
    assert root["valid"][0].sum() >= 1
