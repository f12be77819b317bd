"""The lazy Minoux engine against the reference's, on the CPU
(`repro_torch.core.simulate`: SparseCoverage, DenseMedoid, lazy_greedy,
run_tree_lazy, run_greedy_lazy).

  * kcover and kdom exactly: ids, value, per-node evals, evals totals,
    comm elements;
  * kmedoid on small-integer data: equal selections and evals, values
    within 1e-5 (the port's DenseMedoid is torch, the reference's numpy);
  * the port's own dense-vs-lazy agreement, as tests/test_simulate.py
    holds the reference's, over its four (m, b).
"""
import numpy as np
import pytest
import torch

from repro.core import simulate as JS
from repro.core.tree import AccumulationTree as JTree
from repro.data import synthetic as jsyn
from repro_torch.core import simulate as TS
from repro_torch.core.tree import AccumulationTree as TTree
from repro_torch.data import synthetic as tsyn

UNIVERSE = 512


@pytest.fixture(scope="module")
def cover():
    sets = tsyn.gen_kcover(256, UNIVERSE, seed=2)
    return sets, tsyn.pack_bitmaps(sets, UNIVERSE)


def _int_points(n, d, seed):
    return np.random.default_rng(seed).integers(-3, 4, (n, d)).astype(
        np.float32)


def _same(want, got, exact=True):
    assert list(np.asarray(got.ids)) == list(np.asarray(want.ids))
    assert got.per_node_evals == want.per_node_evals
    assert (got.evals_total, got.evals_critical, got.comm_elements,
            got.levels, got.machines, got.branching) == (
        want.evals_total, want.evals_critical, want.comm_elements,
        want.levels, want.machines, want.branching)
    if exact:
        assert got.value == want.value
    else:
        assert abs(got.value - want.value) <= 1e-5 * max(1.0,
                                                          abs(want.value))


def test_synthetic_sets_match_reference():
    a = tsyn.gen_kcover(64, UNIVERSE, seed=2)
    b = jsyn.gen_kcover(64, UNIVERSE, seed=2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_sparse_coverage_and_lazy_greedy_match_reference(cover):
    sets, _ = cover
    want_st, got_st = JS.SparseCoverage(sets, UNIVERSE), \
        TS.SparseCoverage(sets, UNIVERSE)
    for e in (3, 17, 3, 200):
        assert got_st.marginal(e) == want_st.marginal(e)
        got_st.add(e)
        want_st.add(e)
        assert got_st.value() == want_st.value()
    np.testing.assert_array_equal(got_st.covered, want_st.covered)
    want = JS.lazy_greedy(JS.SparseCoverage(sets, UNIVERSE), range(256), 12)
    got = TS.lazy_greedy(TS.SparseCoverage(sets, UNIVERSE), range(256), 12)
    assert got == want


def test_dense_medoid_matches_reference():
    x = _int_points(96, 12, 3)
    ground = np.arange(0, 96, 2)
    want = JS.DenseMedoid(x, ground)
    got = TS.DenseMedoid(x, ground, device="cpu")
    assert abs(got.base - want.base) <= 1e-6
    for e in (5, 40, 5, 77):
        assert abs(got.marginal(e) - want.marginal(e)) <= 1e-6
        got.add(e)
        want.add(e)
        assert abs(got.value() - want.value()) <= 1e-6
    cands = list(range(96))
    batched = got.marginals(cands)
    one = [got.marginal(e) for e in cands]
    np.testing.assert_allclose(batched, one, rtol=0, atol=1e-6)
    np.testing.assert_allclose(batched, [want.marginal(e) for e in cands],
                               rtol=0, atol=1e-6)
    assert got.ground.device.type == "cpu"


def test_dense_medoid_fill_in_batches():
    """The first fill in batches smaller than the candidates: the same
    marginals as one batch."""
    x = _int_points(40, 6, 5)
    st = TS.DenseMedoid(x, np.arange(40), device="cpu")
    whole = st.marginals(range(40))
    st.FILL_BYTES = 4 * 40 * 6 * 3          # 3 candidates a batch
    np.testing.assert_array_equal(st.marginals(range(40)), whole)


@pytest.mark.parametrize("name", ["kcover", "kdom"])
@pytest.mark.parametrize("m,b", [(4, 2), (8, 2), (8, 4), (6, 3)])
def test_run_tree_lazy_coverage_matches_reference(cover, name, m, b):
    sets, _ = cover
    want = JS.run_tree_lazy(name, sets, 8, JTree(m, b), seed=5,
                            universe=UNIVERSE)
    got = TS.run_tree_lazy(name, sets, 8, TTree(m, b), seed=5,
                           universe=UNIVERSE)
    _same(want, got)


@pytest.mark.parametrize("m,b,augment", [(4, 2, 0), (8, 2, 16), (6, 3, 0)])
def test_run_tree_lazy_kmedoid_matches_reference(m, b, augment):
    x = _int_points(192, 16, 4)
    want = JS.run_tree_lazy("kmedoid", x, 8, JTree(m, b), seed=5,
                            augment=augment)
    got = TS.run_tree_lazy("kmedoid", x, 8, TTree(m, b), seed=5,
                           augment=augment, device="cpu")
    _same(want, got, exact=False)
    # a tensor keeps its device
    again = TS.run_tree_lazy("kmedoid", torch.as_tensor(x), 8, TTree(m, b),
                             seed=5, augment=augment)
    _same(got, again)


@pytest.mark.parametrize("name,k", [("kcover", 12), ("kdom", 20)])
def test_run_greedy_lazy_coverage_matches_reference(cover, name, k):
    sets, _ = cover
    want = JS.run_greedy_lazy(name, sets, k, universe=UNIVERSE)
    got = TS.run_greedy_lazy(name, sets, k, universe=UNIVERSE)
    _same(want, got)


def test_run_greedy_lazy_kmedoid_matches_reference():
    x = _int_points(160, 10, 6)
    want = JS.run_greedy_lazy("kmedoid", x, 10)
    got = TS.run_greedy_lazy("kmedoid", x, 10, device="cpu")
    _same(want, got, exact=False)


def test_lazy_kmedoid_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.run_greedy_lazy("kmedoid", _int_points(8, 2, 0), 2)


def test_port_dense_and_lazy_engines_agree_greedy(cover):
    sets, bm = cover
    g_d = TS.run_greedy_dense("kcover", bm, 12, universe=UNIVERSE,
                              device="cpu")
    g_l = TS.run_greedy_lazy("kcover", sets, 12, universe=UNIVERSE)
    assert g_d.value == g_l.value
    assert g_l.evals_total <= g_d.evals_total


@pytest.mark.parametrize("m,b", [(4, 2), (8, 2), (8, 4), (6, 3)])
def test_port_dense_and_lazy_engines_agree_tree(cover, m, b):
    sets, bm = cover
    t = TTree(m, b)
    d = TS.run_tree_dense("kcover", bm, 8, t, seed=5, universe=UNIVERSE,
                          device="cpu")
    lz = TS.run_tree_lazy("kcover", sets, 8, t, seed=5, universe=UNIVERSE)
    assert d.value == lz.value
    assert d.levels == lz.levels
    assert d.comm_elements == lz.comm_elements
    assert lz.evals_total <= d.evals_total
