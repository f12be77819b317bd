"""The paper's coverage problems — k-cover and k-dominating set, the
bitmap rule — through the port against the JAX package on its `ref`
backend, on the same numpy inputs made from a seed.

Coverage gains and values are integers (popcount sums), exact in f32 on
both sides, and both packages take the first index among equal gains:
so ids, values, eval counts and — under a knapsack — spent must be
EQUAL (tolerance 0), with no tie rule. Also: the graph generators are
identical copies, the port's 32-bit words (int32 bit patterns) round-trip
words with bit 31 set and give the reference's gain parts, and the
planner budgets a bitmap cache at the bytes its tensors allocate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_kcover as j_kcover
from repro.configs import paper_kdom as j_kdom
from repro.core import constraints as JC
from repro.core import greedyml as JGML
from repro.core import simulate as JS
from repro.core.functions import make_objective as j_make
from repro.core.tree import AccumulationTree as JTree
from repro.data import synthetic as JSyn
from repro.kernels import rules as JR
from repro_torch import convert
from repro_torch.configs import paper_kcover, paper_kdom
from repro_torch.core import constraints as TC
from repro_torch.core import greedy as TG
from repro_torch.core import greedyml as TGML
from repro_torch.core import simulate as TS
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.tree import AccumulationTree as TTree
from repro_torch.data import synthetic as TSyn
from repro_torch.kernels import ops, plans as TPlans
from repro_torch.kernels import rules as TR
from test_torch_greedyml import _reference_sampler

K = 8


def _kdom(n, seed=11):
    """Closed neighbourhoods of the road-like graph, packed (universe n)."""
    return JSyn.pack_bitmaps(JSyn.gen_graph_road(n, seed=seed), n), n


def _kcover(n, universe=600, seed=7):
    return JSyn.pack_bitmaps(JSyn.gen_kcover(n, universe, seed=seed),
                             universe), universe


DATA = {"kdom": lambda: _kdom(1024), "kcover": lambda: _kcover(1024)}


# ---------------------------------------------------------------------------
# data and configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("gen", ["gen_graph_road", "gen_graph_social"])
def test_graph_generators_are_identical_copies(gen, seed):
    want = getattr(JSyn, gen)(700, seed=seed)
    got = getattr(TSyn, gen)(700, seed=seed)
    assert len(got) == len(want)
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want))


def test_coverage_configs_match_reference():
    for t, j in ((paper_kcover.CONFIG, j_kcover.CONFIG),
                 (paper_kdom.CONFIG, j_kdom.CONFIG)):
        assert t == type(t)(**{f: getattr(j, f) for f in (
            "objective", "k", "n", "universe", "feature_dim",
            "num_machines", "branching", "seed", "augment")})
    full = paper_kcover.KOSARAK
    assert (full.n, full.universe, full.k) == (990_002, 41_270, 64)
    assert (full.num_machines, full.branching, full.seed) == (32, 2, 7)


def test_full_size_coverage_tiers():
    """KOSARAK: m = 32 leaves of ≈30,938 stream (m = 8 would be fused: its
    123,750-candidate mask busts a block), every level is resident; the
    kdom configuration: leaves stream, nodes resident."""
    for cfg, m_fused in ((paper_kcover.KOSARAK, 8), (paper_kdom.CONFIG, None)):
        w = (cfg.universe + 31) // 32
        n_leaf = int(np.bincount(TS.partition(cfg.n, cfg.num_machines,
                                              cfg.seed)).max())
        leaf = TPlans.select_engine(TR.BITS_OR, w, n_leaf,
                                    replicas=cfg.num_machines)
        assert leaf.engine == "mega_stream" and leaf.dtype == "uint32"
        levels = TTree(cfg.num_machines, cfg.branching).num_levels
        for lvl in range(1, levels + 1):
            nodes = cfg.num_machines // cfg.branching ** lvl
            node = TPlans.select_engine(TR.BITS_OR, w, cfg.branching * cfg.k,
                                        replicas=nodes)
            assert node.engine == "mega_resident", (cfg, lvl)
        if m_fused:
            n8 = int(np.bincount(TS.partition(cfg.n, m_fused,
                                              cfg.seed)).max())
            assert TPlans.select_engine(TR.BITS_OR, w, n8,
                                        replicas=m_fused).engine == "fused"


# ---------------------------------------------------------------------------
# 32-bit words
# ---------------------------------------------------------------------------


def _top_bit_words(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    a.reshape(-1)[::3] |= np.uint32(2 ** 31)
    a.reshape(-1)[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    return a


def test_words_narrow_to_int32_and_round_trip():
    a = _top_bit_words((40, 9), 1)
    t = TR.to_words(a)
    assert t.dtype == torch.int32 == TR.BITS_OR.dtype
    assert t.untyped_storage().data_ptr() == a.ctypes.data   # no copy
    np.testing.assert_array_equal(t.numpy().view(np.uint32), a)
    wide = torch.as_tensor(a.astype(np.int64))
    np.testing.assert_array_equal(TR.to_words(wide).numpy(), t.numpy())
    np.testing.assert_array_equal(convert.to_numpy(t, np.uint32), a)
    np.testing.assert_array_equal(
        TR.to_words(torch.as_tensor(a)).numpy(), t.numpy())


def test_popcount_parts_match_population_count_on_top_bit_words():
    row, mat = _top_bit_words(50, 2), _top_bit_words((50, 30), 3)
    want = np.asarray(JR.gain_part(jnp.asarray(row)[:, None],
                                   jnp.asarray(mat), JR.BITS_OR))
    got = TR.gain_part(TR.to_words(row)[:, None], TR.to_words(mat),
                       TR.BITS_OR)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TR.popcount(TR.to_words(mat)).numpy(),
        np.asarray(jax.lax.population_count(jnp.asarray(mat))))
    folded = TR.fold_cols(TR.to_words(row), TR.to_words(mat[:, 4]),
                          TR.BITS_OR)
    np.testing.assert_array_equal(
        folded.numpy().view(np.uint32),
        np.asarray(JR.fold_cols(jnp.asarray(row), jnp.asarray(mat[:, 4]),
                                JR.BITS_OR)))


@pytest.mark.parametrize("replicas", [1, 3])
def test_planner_bitmap_bytes_equal_allocated_bytes(replicas, monkeypatch):
    """The bytes the planner budgets for a bitmap cache are the bytes the
    CPU path allocates for it: the pool words the (W, C) "matrix" views
    (prepare copies nothing), on the streaming tier as on the fused."""
    words, universe = _kcover(120 * replicas, 500, seed=3)
    w = words.shape[1]
    obj = t_make("kcover", universe=universe, device="cpu")
    pay = torch.as_tensor(words.reshape(replicas, 120, w).view(np.int32))
    ids = torch.arange(120 * replicas).reshape(replicas, 120)
    valid = torch.ones(replicas, 120, dtype=torch.bool)
    seen = {}
    real = ops.greedy_loop

    def spy(mat, row, mask, k, rule, plan=None):
        seen["mat"] = mat
        return real(mat, row, mask, k, rule, plan=plan)

    monkeypatch.setattr(ops, "greedy_loop", spy)
    monkeypatch.setenv("REPRO_TORCH_RESIDENT_L2_MB", "0")
    TG.greedy_batch(obj, ids, pay, valid, 4)
    mat = seen["mat"]
    plan = TPlans.select_engine(TR.BITS_OR, w, 120, replicas=replicas)
    assert plan.engine == "mega_stream"
    allocated = mat.untyped_storage().nbytes()
    assert allocated == TPlans.cache_bytes(w, 120, plan.dtype, replicas)
    assert mat.untyped_storage().data_ptr() == pay.untyped_storage().data_ptr()
    state = obj.init_state(pay, valid)
    fused = obj.prepare(state, pay, valid,
                        TPlans.select_engine(TR.BITS_OR, w, 120,
                                             requested="fused",
                                             replicas=replicas))
    assert fused[0].untyped_storage().nbytes() == allocated
    assert state.row.element_size() * state.row.numel() == 4 * replicas * w


# ---------------------------------------------------------------------------
# whole trees against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["auto", "mega_stream", "fused", "step"])
@pytest.mark.parametrize("name", ["kdom", "kcover"])
def test_run_tree_dense_equals_reference(name, engine, monkeypatch):
    """T(8, 2) at n = 1,024: ids, values, eval counts and communication
    equal. 'mega_stream' is 'auto' with no L2 share for resident leaves,
    so the leaves take the streaming loop."""
    data, universe = DATA[name]()
    if engine == "mega_stream":
        monkeypatch.setenv("REPRO_TORCH_RESIDENT_L2_MB", "0.01")
        engine = "auto"
    want = JS.run_tree_dense(name, data, K, JTree(8, 2), seed=0,
                             universe=universe, backend="ref", engine=engine)
    got = TS.run_tree_dense(name, data, K, TTree(8, 2), seed=0,
                            universe=universe, engine=engine, device="cpu")
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    assert got.value == want.value
    assert got.per_node_evals == want.per_node_evals
    assert got.evals_total == want.evals_total
    assert got.comm_elements == want.comm_elements


def test_run_tree_dense_takes_words_as_a_tensor():
    """Words already narrowed and placed (as chip_smoke.py hands the
    kosarak bitmaps over) give the numpy run's result."""
    data, universe = DATA["kcover"]()
    want = TS.run_tree_dense("kcover", data, K, TTree(8, 2), seed=1,
                             universe=universe, device="cpu")
    got = TS.run_tree_dense("kcover", TR.to_words(data), K, TTree(8, 2),
                            seed=1, universe=universe, device="cpu")
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.value == want.value


def _dispatch(pkg, name, data, universe, k, radices, costs, **kw):
    """A whole LevelDispatcher tree of one package → its stacked lanes as
    numpy (ids, valid, value, evals) and the lanes' spent."""
    n = data.shape[0]
    if pkg == "jax":
        obj = j_make(name, universe=universe, backend="ref")
        spec = (JC.KnapsackSpec(jnp.asarray(costs), 4.0)
                if costs is not None else None)
        d = JGML.LevelDispatcher(obj, k, radices, constraint=spec, **kw)
        ids, pay, val = JGML.shard_lanes(
            jnp.arange(n, dtype=jnp.int32), jnp.asarray(data),
            jnp.ones(n, bool), d.lanes)
        sols = d.leaves(ids, pay, val)
        for lvl in range(d.num_levels):
            sols = d.level(sols, lvl)
        out = {f: np.asarray(getattr(sols, f))
               for f in ("ids", "valid", "value", "evals")}
    else:
        obj = t_make(name, universe=universe, device="cpu")
        spec = (TC.KnapsackSpec(torch.as_tensor(costs), 4.0)
                if costs is not None else None)
        d = TGML.LevelDispatcher(obj, k, radices, constraint=spec, **kw)
        ids, pay, val = TGML.shard_lanes(
            torch.arange(n), TR.to_words(data),
            torch.ones(n, dtype=torch.bool), d.lanes)
        sols = d.leaves(ids, pay, val)
        for lvl in range(d.num_levels):
            sols = d.level(sols, lvl)
        out = {f: getattr(sols, f).numpy()
               for f in ("ids", "valid", "value", "evals")}
    if costs is not None:
        ids_ = np.where(out["valid"], out["ids"], 0)
        out["spent"] = np.where(out["valid"], costs[ids_], 0.0).sum(-1)
    return out


@pytest.mark.parametrize("case", ["knapsack", "stochastic"])
@pytest.mark.parametrize("name", ["kdom", "kcover"])
def test_dispatcher_trees_equal_reference(name, case):
    """LevelDispatcher over (2, 2, 2) lanes, whole trees: with a knapsack
    (fused engine at every stage) and with stochastic leaves (the
    reference's own draws): every lane's ids, values, eval counts and
    spent equal."""
    data, universe = (_kdom(256) if name == "kdom"
                      else _kcover(256, 300, seed=4))
    costs, kw, tkw = None, {}, {}
    if case == "knapsack":
        costs = np.random.default_rng(2).uniform(0.5, 2.0, 256).astype(
            np.float32)
    else:
        kw = dict(sample_leaf=10, seed=5)
        tkw = dict(sampler=_reference_sampler(5))
    want = _dispatch("jax", name, data, universe, 6, (2, 2, 2), costs, **kw)
    got = _dispatch("torch", name, data, universe, 6, (2, 2, 2), costs,
                    **kw, **tkw)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f].astype(got[f].dtype))
    if costs is not None:
        assert (got["spent"] <= 4.0).all()
        assert got["valid"][0].sum() < 6          # the budget binds
