"""The rules that hold a kernel against its plain version
(src/repro_torch/kernels/parity.py), on the CPU: they must pass what
differs only by f32 rounding and fail what computes something else —
TF32-rounded products, a dropped slice of features, a gain moved beyond
its entry bound."""
import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import gen_images
from repro_torch.kernels import greedy_loop as TL
from repro_torch.kernels import pairwise as TP
from repro_torch.kernels import parity
from repro_torch.kernels import rules as TR


def _features(n=192, d=2048, seed=0):
    x = torch.as_tensor(gen_images(2 * n, d, classes=6, seed=seed))
    return x[:n].unsqueeze(0).contiguous(), x[n:].unsqueeze(0).contiguous()


def _tf32(x):
    """Round f32 to TF32's 10-bit mantissa (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("mode", ["dot", "dist"])
def test_pairwise_rule_passes_a_reordered_f32_build(mode):
    g, c = _features()
    perm = torch.randperm(g.shape[-1], generator=torch.Generator()
                          .manual_seed(1))
    plain = TP.pairwise_plain(g, c, mode)
    other = TP.pairwise_plain(g[..., perm].contiguous(),
                              c[..., perm].contiguous(), mode)
    stats = parity.compare_pairwise(other, plain, g, c, mode)
    assert stats["rms_ratio"] <= parity.PAIRWISE_RMS_RATIO


@pytest.mark.parametrize("mode", ["dot", "dist"])
def test_pairwise_rule_rejects_tf32_products(mode):
    g, c = _features()
    plain = TP.pairwise_plain(g, c, mode)
    # TF32 rounds the product's inputs; norms and the sum stay f32
    cross = torch.matmul(_tf32(g), _tf32(c).transpose(-1, -2))
    gn = (g * g).sum(-1, keepdim=True)
    cn = (c * c).sum(-1).unsqueeze(-2)
    tf32 = cross if mode == "dot" else torch.sqrt(
        torch.clamp(gn + cn - 2 * cross, min=0.0))
    stats = parity.pairwise_stats(tf32, plain,
                                  parity.exact_matrix(g, c, mode), mode)
    assert not parity.pairwise_holds(stats), stats
    with pytest.raises(AssertionError):
        parity.compare_pairwise(tf32, plain, g, c, mode)


@pytest.mark.parametrize("mode", ["dot", "dist"])
def test_pairwise_rule_rejects_a_dropped_feature_slice(mode):
    g, c = _features()
    plain = TP.pairwise_plain(g, c, mode)
    keep = torch.ones(g.shape[-1], dtype=torch.bool)
    keep[512:528] = False
    short = TP.pairwise_plain(g[..., keep].contiguous(),
                              c[..., keep].contiguous(), mode)
    with pytest.raises(AssertionError):
        parity.compare_pairwise(short, plain, g, c, mode)


def test_pairwise_rule_accepts_exact_integer_builds():
    rng = np.random.default_rng(2)
    g = torch.as_tensor(rng.integers(-3, 4, (1, 40, 64)).astype(np.float32))
    c = torch.as_tensor(rng.integers(-3, 4, (1, 30, 64)).astype(np.float32))
    for mode in ("dot", "dist"):
        plain = TP.pairwise_plain(g, c, mode)
        stats = parity.compare_pairwise(plain.clone(), plain, g, c, mode)
        assert stats["rms_ratio"] <= 1.0 and stats["max_ratio"] <= 1.0
        # integer products are exact; 'dist' keeps √'s rounding
        assert (stats["rms"] == 0.0) == (mode == "dot")


def _loop_inputs(rule, b=2, n=60, d=16, seed=3):
    x = torch.as_tensor(gen_images(b * n, d, classes=5, seed=seed))
    pools = x.reshape(b, n, d)
    valid = torch.ones(b, n, dtype=torch.bool)
    return pools, TR.empty_row(pools, valid, rule), torch.ones(b, n)


@pytest.mark.parametrize("name", ["kmedoid", "mmr"])
def test_loop_rule_bounds_gains_by_the_entry_differences(name):
    """Two greedies over matrices that differ entry by entry pass with the
    measured ΔM, and a gain moved by more than its column's bound fails."""
    rule = {"kmedoid": TR.DIST_MIN, "mmr": TR.mmr(0.3, 2.0)}[name]
    pools, row, mask = _loop_inputs(rule)
    mat = TL.resident_matrix(pools, pools, rule)
    noise = torch.rand(mat.shape, generator=torch.Generator()
                       .manual_seed(4)) * 1e-6
    other = mat + noise
    plain = TL.greedy_loop_plain(mat, row, mask, 8, rule)
    kern = TL.greedy_loop_plain(other, row, mask, 8, rule)
    res = parity.compare_loops(kern, plain, rule, entry_diff=noise)
    assert res["max_gain_tol"] <= 2 * 60 * 8 * 1e-6 + 1e-3
    rows, bests, gains = kern
    moved = gains.clone()
    moved[0, 2] += 10 * res["max_gain_tol"]
    with pytest.raises(AssertionError):
        parity.compare_loops((rows, bests, moved), plain, rule,
                             entry_diff=noise)


def test_loop_rule_without_entry_differences_is_strict():
    rule = TR.DIST_MIN
    pools, row, mask = _loop_inputs(rule)
    mat = TL.resident_matrix(pools, pools, rule)
    plain = TL.greedy_loop_plain(mat, row, mask, 8, rule)
    rows, bests, gains = plain
    moved = gains.clone()
    moved[1, 0] *= 1 + 1e-3
    with pytest.raises(AssertionError):
        parity.compare_loops((rows, bests, moved), plain, rule)
    assert parity.compare_loops(plain, plain, rule)["ties"] == 0
