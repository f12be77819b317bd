"""The port's selection algebra (repro_torch.kernels.rules) against the
reference's (repro.kernels.rules), primitive by primitive, for every
registered rule. Inputs are made with numpy from a seed and handed to
both packages.

Tolerances: the elementwise primitives repeat the same IEEE operations in
the same order, so they are held at rtol 1e-6; reductions (partial gains,
norms) sum in another order than XLA and are held at f32 rtol 1e-5. The
'dist' expansion is compared in its squared form against the rounding
bound of a D-term f32 dot product, d·eps·(‖g‖²+‖c‖²+2‖g‖‖c‖): the square
root of a near-zero expansion amplifies rounding (fault F0), and that
is not a defect of either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rules as JR
from repro_torch.kernels import rules as TR

RULES = {
    "kmedoid": (JR.DIST_MIN, TR.DIST_MIN),
    "facility": (JR.DOT_MAX, TR.DOT_MAX),
    "coverage": (JR.BITS_OR, TR.BITS_OR),
    "satcover": (JR.sat_sum(2.0), TR.sat_sum(2.0)),
    "graphcut": (JR.graph_cut(0.5), TR.graph_cut(0.5)),
    "mmr": (JR.mmr(0.3, 2.0), TR.mmr(0.3, 2.0)),
}
NAMES = sorted(RULES)
EPS32 = float(np.finfo(np.float32).eps)


def _t(x):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a))


def _np(t, bitmap=False):
    a = t.numpy()
    return a.astype(np.uint32) if bitmap else a


def _row_mat(name, n=48, c=20, seed=0):
    """(state row (N,), matrix (N, C)) in the rule's types; feature rows
    include pad sentinels so the pad algebra is exercised."""
    rng = np.random.default_rng(seed)
    jr, _ = RULES[name]
    if jr.is_bitmap:
        row = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
        mat = rng.integers(0, 2 ** 32, (n, c), dtype=np.uint32)
        return row, mat
    mat = rng.normal(0.0, 1.0, (n, c)).astype(np.float32)
    if jr.pairwise == "dist":
        mat = np.abs(mat)
    row = rng.uniform(0.0, 2.5, n).astype(np.float32)
    row[::7] = jr.row_pad
    return row, mat


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_rule_specs_match(name):
    jr, tr = RULES[name]
    for field in ("name", "pairwise", "fold", "row_dtype", "row_pad", "cap",
                  "lam"):
        assert getattr(jr, field) == getattr(tr, field), field
    assert jr.is_bitmap == tr.is_bitmap
    if name in ("kmedoid", "facility", "coverage"):
        assert TR.get(name) == tr


@pytest.mark.parametrize("name", NAMES)
def test_gain_part(name):
    jr, tr = RULES[name]
    row, mat = _row_mat(name)
    want = JR.gain_part(jnp.asarray(row)[:, None], jnp.asarray(mat), jr)
    got = TR.gain_part(_t(row)[:, None], _t(mat), tr)
    _close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_fold_cols_and_winner(name):
    jr, tr = RULES[name]
    row, mat = _row_mat(name, seed=1)
    col = mat[:, 3]
    bitmap = jr.is_bitmap
    want = JR.fold_cols(jnp.asarray(row), jnp.asarray(col), jr)
    got = TR.fold_cols(_t(row), _t(col), tr)
    np.testing.assert_array_equal(_np(got, bitmap), np.asarray(want))
    for prev in (-1, 3):
        w = JR.fold_winner(jnp.asarray(row), jnp.asarray(col),
                           jnp.int32(prev), jr)
        g = TR.fold_winner(_t(row), _t(col), torch.tensor(prev), tr)
        np.testing.assert_array_equal(_np(g, bitmap), np.asarray(w))


@pytest.mark.parametrize("name", NAMES)
def test_partial_gains(name):
    jr, tr = RULES[name]
    row, mat = _row_mat(name, seed=2)
    want = JR.partial_gains(jnp.asarray(row)[None, :], jnp.asarray(mat), jr)
    got = TR.partial_gains(_t(row)[None, :], _t(mat), tr)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_argmax_first_max(seed):
    rng = np.random.default_rng(seed)
    gains = rng.integers(0, 4, (1, 64)).astype(np.float32)   # many ties
    mask = (rng.random((1, 64)) > 0.3).astype(np.float32)
    jb, jm = JR.masked_argmax(jnp.asarray(gains), jnp.asarray(mask))
    tb, tm = TR.masked_argmax(_t(gains), _t(mask))
    assert int(tb[0]) == int(jb)
    assert float(tm[0]) == float(jm)
    # every column masked: index 0 and -inf, as the reference
    jb, jm = JR.masked_argmax(jnp.asarray(gains), jnp.zeros((1, 64)))
    tb, tm = TR.masked_argmax(_t(gains), torch.zeros(1, 64))
    assert int(tb[0]) == int(jb) == 0 and float(tm[0]) == float(jm)


def test_masked_argmax_batched_rows_are_independent():
    rng = np.random.default_rng(5)
    gains = rng.integers(0, 3, (6, 40)).astype(np.float32)
    mask = (rng.random((6, 40)) > 0.5).astype(np.float32)
    tb, tm = TR.masked_argmax(_t(gains), _t(mask))
    for i in range(6):
        jb, jm = JR.masked_argmax(jnp.asarray(gains[i:i + 1]),
                                  jnp.asarray(mask[i:i + 1]))
        assert int(tb[i]) == int(jb) and float(tm[i]) == float(jm)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_and_dequant(seed):
    rng = np.random.default_rng(seed)
    mat = rng.normal(0.0, 2.0, (24, 40)).astype(np.float32)
    mat[3] = 0.0                       # an all-zero row keeps scale 1
    jq, js = JR.quantize_rows(jnp.asarray(mat))
    tq, ts = TR.quantize_rows(_t(mat))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TR.dequant(tq, ts).numpy(),
                                  np.asarray(JR.dequant(jq, js)))


def test_cache_itemsize():
    for dt in ("float32", "uint32", "bfloat16", "int8"):
        assert TR.cache_itemsize(dt) == JR.cache_itemsize(dt)


def _sq_bound(g, c):
    """Rounding bound of the squared 'dist' expansion, per entry."""
    gn = (g.astype(np.float64) ** 2).sum(1)[:, None]
    cn = (c.astype(np.float64) ** 2).sum(1)[None, :]
    d = g.shape[1]
    return 4 * d * EPS32 * (gn + cn + 2 * np.sqrt(gn * cn))


@pytest.mark.parametrize("mode", ["dot", "dist"])
def test_pairwise_block(mode):
    rng = np.random.default_rng(3)
    g = rng.normal(0, 1, (40, 64)).astype(np.float32)
    c = np.concatenate([g[:8], rng.normal(0, 1, (12, 64))]).astype(
        np.float32)                     # shared rows: zero distances
    want = np.asarray(JR.pairwise_block(jnp.asarray(g), jnp.asarray(c),
                                        mode))
    got = TR.pairwise_block(_t(g), _t(c), mode).numpy()
    if mode == "dot":
        _close(got, want, rtol=1e-5, atol=1e-5)
    else:
        diff = np.abs(got.astype(np.float64) ** 2
                      - want.astype(np.float64) ** 2)
        assert np.all(diff <= _sq_bound(g, c))


@pytest.mark.parametrize("name", NAMES)
def test_matrix_block(name):
    jr, tr = RULES[name]
    rng = np.random.default_rng(4)
    if jr.is_bitmap:
        c = rng.integers(0, 2 ** 32, (12, 9), dtype=np.uint32)
        got = TR.matrix_block(None, _t(c), tr)
        np.testing.assert_array_equal(_np(got, True),
                                      np.asarray(JR.matrix_block(
                                          None, jnp.asarray(c), jr)))
        return
    g = rng.normal(0, 1, (30, 16)).astype(np.float32)
    c = rng.normal(0, 1, (12, 16)).astype(np.float32)
    want = np.asarray(JR.matrix_block(jnp.asarray(g), jnp.asarray(c), jr))
    got = TR.matrix_block(_t(g), _t(c), tr).numpy()
    if jr.pairwise == "dist":
        diff = np.abs(got.astype(np.float64) ** 2
                      - want.astype(np.float64) ** 2)
        assert np.all(diff <= _sq_bound(g, c))
    else:
        _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_pairwise_col_and_update_row(name):
    jr, tr = RULES[name]
    rng = np.random.default_rng(6)
    if jr.is_bitmap:
        row = rng.integers(0, 2 ** 32, 9, dtype=np.uint32)
        pay = rng.integers(0, 2 ** 32, 9, dtype=np.uint32)
        np.testing.assert_array_equal(
            _np(TR.pairwise_col(None, _t(pay), tr), True),
            np.asarray(JR.pairwise_col(None, jnp.asarray(pay), jr)))
        np.testing.assert_array_equal(
            _np(TR.update_row(None, _t(row), _t(pay), tr), True),
            np.asarray(JR.update_row(None, jnp.asarray(row),
                                     jnp.asarray(pay), jr)))
        return
    g = rng.normal(0, 1, (30, 16)).astype(np.float32)
    p = g[4]                                      # a member: distance 0
    row = rng.uniform(0, 2, 30).astype(np.float32)
    want = JR.pairwise_col(jnp.asarray(g), jnp.asarray(p), jr)
    got = TR.pairwise_col(_t(g), _t(p), tr)
    _close(got, want, rtol=1e-5, atol=1e-6)
    if jr.pairwise == "dist":
        assert float(got[4]) == 0.0 == float(want[4])
    want = JR.update_row(jnp.asarray(g), jnp.asarray(row), jnp.asarray(p),
                         jr)
    got = TR.update_row(_t(g), _t(row), _t(p), tr)
    _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_empty_row(name):
    jr, tr = RULES[name]
    if jr.is_bitmap:
        got = TR.empty_row(None, None, tr, words=7)
        want = JR.empty_row(None, None, jr, words=7)
        np.testing.assert_array_equal(_np(got, True), np.asarray(want))
        return
    rng = np.random.default_rng(7)
    g = rng.normal(0, 1, (20, 8)).astype(np.float32)
    valid = rng.random(20) > 0.3
    want = JR.empty_row(jnp.asarray(g), jnp.asarray(valid), jr)
    got = TR.empty_row(_t(g), _t(valid), tr)
    _close(got, want, rtol=1e-6, atol=0)


def test_popcount_matches_population_count():
    rng = np.random.default_rng(8)
    words = np.concatenate([
        np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32),
        rng.integers(0, 2 ** 32, 500, dtype=np.uint32)])
    want = np.asarray(jax.lax.population_count(jnp.asarray(words)))
    got = TR.popcount(_t(words)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
