"""The port's kernel modules against the reference.

CPU part: each plain version — the path a CPU tensor takes through the
kernel wrapper — against `repro.kernels.ref` / `repro.kernels.ops` on the
'ref' backend, on inputs made with numpy from a seed. Fed the same
matrix (or integer features, whose matrices are exact in both), bests
must be equal; rows and gains agree within f32 rtol 1e-5 (reductions sum
in another order than XLA). Where the two packages build a matrix
independently from real features, 'dist' entries are compared in
squared form against the rounding bound of the expansion (F0), and loop
results under kernels/parity.py's tie-aware rule with the measured
entry differences.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JRef
from repro.kernels import rules as JR
from repro.data.synthetic import gen_images
from repro_torch.kernels import counters, ops
from repro_torch.kernels import greedy_loop as TL
from repro_torch.kernels import pairwise as TP
from repro_torch.kernels import parity
from repro_torch.kernels import rules as TR

FEATURE_RULES = {
    "kmedoid": (JR.DIST_MIN, TR.DIST_MIN),
    "facility": (JR.DOT_MAX, TR.DOT_MAX),
    "satcover": (JR.sat_sum(2.0), TR.sat_sum(2.0)),
    "graphcut": (JR.graph_cut(0.5), TR.graph_cut(0.5)),
    "mmr": (JR.mmr(0.3, 2.0), TR.mmr(0.3, 2.0)),
}
ALL_RULES = dict(FEATURE_RULES, coverage=(JR.BITS_OR, TR.BITS_OR))


def _t(x):
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def _pools(b=3, n=40, c=24, d=32, seed=0):
    x = gen_images(b * (n + c), d, classes=6, seed=seed)
    g = x[:b * n].reshape(b, n, d)
    cd = x[b * n:].reshape(b, c, d)
    return g, cd


def _start_row(jr, g, valid):
    return np.asarray(JR.empty_row(jnp.asarray(g), jnp.asarray(valid), jr))


# ---------------------------------------------------------------------------
# CPU: plain versions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dot", "dist"])
def test_pairwise_plain_matches_reference(mode):
    g, cd = _pools()
    got = TP.pairwise(_t(g), _t(cd), mode).numpy()
    for i in range(g.shape[0]):
        want = np.asarray(JRef.pairwise(
            jnp.asarray(g[i]), jnp.asarray(cd[i]),
            JR.DIST_MIN if mode == "dist" else JR.DOT_MAX))
        if mode == "dot":
            _close(got[i], want)
        else:
            bound = parity.sq_dist_bound(_t(g[i]), _t(cd[i])).numpy()
            diff = np.abs(got[i].astype(np.float64) ** 2
                          - want.astype(np.float64) ** 2)
            assert np.all(diff <= bound)


@pytest.mark.parametrize("kq", [None, 3])
@pytest.mark.parametrize("name", sorted(ALL_RULES))
def test_greedy_loop_plain_matches_reference(name, kq):
    """Fed the reference's own matrix, the streaming loop's plain version
    selects the same elements with the same gains and final rows."""
    jr, tr = ALL_RULES[name]
    rng = np.random.default_rng(1)
    k = 6
    if jr.is_bitmap:
        bits = rng.integers(0, 2 ** 32, (2, 20, 9), dtype=np.uint32)
        bits &= rng.integers(0, 2 ** 32, (2, 20, 9), dtype=np.uint32)
        mats = [np.asarray(JRef.pairwise(None, jnp.asarray(b), jr))
                for b in bits]
        rows = [np.zeros(9, np.uint32)] * 2
    else:
        g, cd = _pools(b=2, seed=1)
        mats = [np.asarray(JRef.pairwise(jnp.asarray(g[i]),
                                         jnp.asarray(cd[i]), jr))
                for i in range(2)]
        rows = [_start_row(jr, g[i], np.arange(g.shape[1]) % 9 != 0)
                for i in range(2)]
    mask = (rng.random((2, mats[0].shape[1])) > 0.2).astype(np.float32)
    got = TL.greedy_loop(_t(np.stack(mats)), _t(np.stack(rows)),
                         _t(mask), k, tr) if kq is None else \
        TL.greedy_loop_plain(_t(np.stack(mats)), _t(np.stack(rows)),
                             _t(mask), k, tr, kq=kq)
    for i in range(2):
        want = JRef.greedy_loop(jnp.asarray(mats[i]), jnp.asarray(rows[i]),
                                jnp.asarray(mask[i]), k, jr,
                                kq=None if kq is None else jnp.int32(kq))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        _close(got[2][i], want[2])
        if jr.is_bitmap:
            np.testing.assert_array_equal(got[0][i].numpy(),
                                          np.asarray(want[0]))
        else:
            _close(got[0][i], want[0])


def _reference_resident_matrix(g, cd, jr, cache_dtype):
    """The matrix the reference's resident tier runs over on 'ref'."""
    mat = JRef.pairwise(jnp.asarray(g), jnp.asarray(cd), jr)
    if cache_dtype == "int8":
        mat = JR.dequant(*JR.quantize_rows(mat))
    elif cache_dtype == "bfloat16":
        mat = mat.astype(jnp.bfloat16).astype(jnp.float32)
    return np.asarray(mat)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_greedy_loop_resident_plain_matches_reference(name, cache_dtype):
    """The resident loop's plain version with a ctl operand against the
    reference's resident tier on its 'ref' backend, one greedy at a time
    with per-greedy kq.

    The two packages build the matrix independently (torch.matmul vs
    XLA), so entries differ by rounding — up to ~3e-4 for 'dist', whose
    square root amplifies the expansion's rounding near zero (F0), and by
    whole bf16/int8 steps where a rounding boundary falls between the
    two f32 values. The data holds exact mathematical ties (two mutually
    closest elements score each other symmetrically), which rounding
    then decides. So the comparison is the stated one of
    kernels/parity.py with the measured entry differences ΔM: equal
    selections, except at a genuine tie; gains within the reordering
    bound plus the chosen column's Σ_i ΔM[i, c] and the summed row error;
    rows within the ΔM of their folded winners."""
    jr, tr = FEATURE_RULES[name]
    g, cd = _pools(b=3, n=24, c=24, d=16, seed=2)
    g = cd.copy()                                  # the node shape: ground = pool
    valid = np.ones((3, 24), bool)
    valid[1, ::5] = False
    rows = np.stack([_start_row(jr, g[i], valid[i]) for i in range(3)])
    kqs = [6, 2, 4]
    ctl = torch.tensor([[kq, 24, 24] for kq in kqs], dtype=torch.int32)
    got = TL.greedy_loop_resident(_t(g), _t(cd), _t(rows),
                                  _t(valid.astype(np.float32)), ctl, 6, tr,
                                  cache_dtype=cache_dtype)
    mats = TL.resident_matrix(_t(g), _t(cd), tr, ctl, cache_dtype).numpy()
    want = [JO.greedy_loop_resident(
        jnp.asarray(g[i]), jnp.asarray(cd[i]), jnp.asarray(rows[i]),
        jnp.asarray(valid[i]), 6, jr, backend="ref",
        cache_dtype=cache_dtype, kq=kqs[i]) for i in range(3)]
    entry_diff = np.abs(mats - np.stack([_reference_resident_matrix(
        g[i], cd[i], jr, cache_dtype) for i in range(3)]))
    want = tuple(torch.as_tensor(np.stack([np.asarray(w[j]) for w in want]))
                 for j in range(3))
    parity.compare_loops(got, want, tr, entry_diff=_t(entry_diff))


EXACT_RULES = {
    "facility": (JR.DOT_MAX, TR.DOT_MAX),
    "satcover": (JR.sat_sum(2.0), TR.sat_sum(2.0)),
    "graphcut": (JR.graph_cut(0.5), TR.graph_cut(0.5)),
    "mmr": (JR.mmr(0.5, 2.0), TR.mmr(0.5, 2.0)),
}


@pytest.mark.parametrize("name", sorted(EXACT_RULES))
def test_greedy_loop_resident_plain_exact_on_integer_features(name):
    """On small-integer features every 'dot' entry is an exact integer in
    both packages, and with caps of 2 and λ of 0.5 every gain part is a
    multiple of 1/8, so gains are exact whatever the summation order:
    the resident loop's selections, kq budgets included, must be EQUAL
    step for step. ('dist' is left out: its square roots make the gain
    sums order-dependent.)"""
    jr, tr = EXACT_RULES[name]
    rng = np.random.default_rng(9)
    cd = rng.integers(-3, 4, (3, 20, 8)).astype(np.float32)
    g = cd.copy()
    valid = np.ones((3, 20), bool)
    valid[2, ::4] = False
    rows = np.stack([_start_row(jr, g[i], valid[i]) for i in range(3)])
    kqs = [7, 3, 0]
    ctl = torch.tensor([[kq, 20, 20] for kq in kqs], dtype=torch.int32)
    got = TL.greedy_loop_resident(_t(g), _t(cd), _t(rows),
                                  _t(valid.astype(np.float32)), ctl, 7, tr)
    for i in range(3):
        want = JO.greedy_loop_resident(
            jnp.asarray(g[i]), jnp.asarray(cd[i]), jnp.asarray(rows[i]),
            jnp.asarray(valid[i]), 7, jr, backend="ref", kq=kqs[i])
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        _close(got[2][i], want[2])
        _close(got[0][i], want[0])


def test_resident_coverage_plain_matches_reference():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2 ** 32, (2, 16, 5), dtype=np.uint32)
    bits &= rng.integers(0, 2 ** 32, (2, 16, 5), dtype=np.uint32)
    valid = np.ones((2, 16), bool)
    ctl = torch.tensor([[5, 5, 16], [3, 5, 16]], dtype=torch.int32)
    got = TL.greedy_loop_resident(None, _t(bits), torch.zeros(2, 5,
                                                              dtype=torch.int64),
                                  _t(valid.astype(np.float32)), ctl, 5,
                                  TR.BITS_OR)
    for i, kq in enumerate((5, 3)):
        want = JO.greedy_loop_resident(None, jnp.asarray(bits[i]),
                                       jnp.zeros(5, jnp.uint32),
                                       jnp.asarray(valid[i]), 5, JR.BITS_OR,
                                       backend="ref", kq=kq)
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0][i].numpy().astype(np.uint32),
                                      np.asarray(want[0]))


@pytest.mark.parametrize("name", ["kmedoid", "facility", "coverage"])
def test_apply_column_and_masked_col_reduce(name):
    jr, tr = ALL_RULES[name]
    rng = np.random.default_rng(4)
    if jr.is_bitmap:
        mat = rng.integers(0, 2 ** 32, (9, 12), dtype=np.uint32)
        row = rng.integers(0, 2 ** 32, 9, dtype=np.uint32)
    else:
        mat = np.abs(rng.normal(0, 1, (20, 12))).astype(np.float32)
        row = rng.uniform(0, 2, 20).astype(np.float32)
    valid = rng.random(12) > 0.4
    for idx in (-1, 5):
        want = JO.apply_column(jnp.asarray(mat), jnp.asarray(row),
                               jnp.int32(idx), jr)
        got = ops.apply_column(_t(mat)[None], _t(row)[None],
                               torch.tensor([idx]), tr)[0]
        np.testing.assert_array_equal(
            got.numpy().astype(np.asarray(want).dtype), np.asarray(want))
    want = JO.masked_col_reduce(jnp.asarray(mat), jnp.asarray(valid),
                                jnp.asarray(row), jr)
    got = ops.masked_col_reduce(_t(mat)[None], _t(valid)[None],
                                _t(row)[None], tr)[0]
    np.testing.assert_array_equal(
        got.numpy().astype(np.asarray(want).dtype), np.asarray(want))


def test_cpu_path_counts_calls_not_launches():
    counters.reset()
    g, cd = _pools(b=2)
    TP.pairwise(_t(g), _t(cd), "dist")
    snap = counters.snapshot()["pairwise"]
    assert snap == {"calls": 1, "launches": 0}


def test_unported_kernels_raise_on_cuda_tensors_only():
    """fused_step/gains run plainly on the CPU; the CUDA check is the
    tensor's device, so a CPU call never raises."""
    mat = torch.rand(1, 6, 4)
    row = torch.rand(1, 6)
    mask = torch.ones(1, 4)
    out = ops.fused_step(mat, row, mask, torch.tensor([-1]), TR.DOT_MAX)
    assert out[0].shape == (1, 6)
