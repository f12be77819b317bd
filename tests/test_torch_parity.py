"""The rules that hold a kernel against its plain version
(src/repro_torch/kernels/parity.py), on the CPU: they must pass what
differs only by f32 rounding and fail what computes something else —
TF32-rounded products, a dropped slice of features, a gain moved beyond
its entry bound, a fused step's moved row entry or a pick that is no
tie."""
import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import gen_images
from repro_torch.kernels import fused_step as TF
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


def _gains_inputs(rule, b=2, n=160, c=24, d=1024, seed=5):
    """Pools, a live state row (three elements folded in) and candidates
    drawn from the pools."""
    x = torch.as_tensor(gen_images(b * n, d, classes=5, seed=seed))
    g = x.reshape(b, n, d)
    row = TR.empty_row(g, torch.ones(b, n, dtype=torch.bool), rule)
    for j in (3, 50, 111):
        row = TR.update_row(g, row, g[:, j], rule)
    cands = g[:, ::n // c][:, :c].contiguous()
    cand_valid = torch.arange(c).expand(b, c) % 6 != 2
    return g, row, cands, cand_valid


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_gains_rule_passes_a_reordered_f32_build(name):
    rule = {"kmedoid": TR.DIST_MIN, "facility": TR.DOT_MAX}[name]
    g, row, cands, cv = _gains_inputs(rule)
    perm = torch.randperm(g.shape[-1], generator=torch.Generator()
                          .manual_seed(2))
    plain = TP.gains_plain(g, row, cands, cv, rule)
    other = TP.gains_plain(g[..., perm].contiguous(), row,
                           cands[..., perm].contiguous(), cv, rule)
    stats = parity.compare_gains(other, plain, g, row, cands, rule)
    assert stats["rms_ratio"] <= parity.PAIRWISE_RMS_RATIO


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_gains_rule_rejects_tf32_products(name):
    """The plain gains with TF32-rounded matrix products (the matrix's
    inputs rounded to 10 mantissa bits, norms and sums in f32) fail."""
    rule = {"kmedoid": TR.DIST_MIN, "facility": TR.DOT_MAX}[name]
    g, row, cands, cv = _gains_inputs(rule)
    plain = TP.gains_plain(g, row, cands, cv, rule)
    cross = torch.matmul(_tf32(g), _tf32(cands).transpose(-1, -2))
    if rule.pairwise == "dist":
        gn = (g * g).sum(-1, keepdim=True)
        cn = (cands * cands).sum(-1).unsqueeze(-2)
        cross = torch.sqrt(torch.clamp(gn + cn - 2 * cross, min=0.0))
    raw = TR.gain_part(row.unsqueeze(-1), cross, rule).sum(-2)
    tf32 = torch.where(cv, raw, torch.full_like(raw, float("-inf")))
    with pytest.raises(AssertionError):
        parity.compare_gains(tf32, plain, g, row, cands, rule)


def test_gains_rule_needs_the_same_invalid_candidates():
    g, row, cands, cv = _gains_inputs(TR.DOT_MAX)
    plain = TP.gains_plain(g, row, cands, cv, TR.DOT_MAX)
    other = plain.clone()
    other[0, 2] = 1.0                      # an invalid candidate scored
    with pytest.raises(AssertionError):
        parity.compare_gains(other, plain, g, row, cands, TR.DOT_MAX)


def test_step_rule_holds_rows_gains_and_picks():
    """A fused step passes against itself; a moved row entry, a gain
    moved beyond the reordering bound, or a pick that is no tie fail;
    a pick at an exact tie passes and is counted."""
    rule = TR.DOT_MAX
    pools, row, _ = _loop_inputs(rule)
    mat = TL.resident_matrix(pools, pools, rule)
    mask = torch.ones(mat.shape[0], mat.shape[-1])
    prev = torch.tensor([4, -1])
    plain = TF.fused_step_plain(mat, row, mask, prev, rule)
    assert parity.compare_steps(plain, plain, mat, mask, rule)["ties"] == 0
    rows, best, gain = plain
    bad_rows = rows.clone()
    bad_rows[0, 7] = torch.nextafter(bad_rows[0, 7], torch.tensor(9.0))
    with pytest.raises(AssertionError):
        parity.compare_steps((bad_rows, best, gain), plain, mat, mask, rule)
    with pytest.raises(AssertionError):
        parity.compare_steps((rows, best, gain * (1 + 1e-3)), plain, mat,
                             mask, rule)
    raw = TR.gain_part(rows.unsqueeze(-1), mat, rule).sum(-2)
    worst = raw.argmin(-1)
    with pytest.raises(AssertionError):
        parity.compare_steps((rows, worst, gain), plain, mat, mask, rule)
    # an exact duplicate column is an exact tie
    dup = mat.clone()
    dup[0, :, 9] = dup[0, :, int(best[0])]
    twin = TF.fused_step_plain(dup, row, mask, prev, rule)
    other = twin[1].clone()
    other[0] = 9 if int(twin[1][0]) != 9 else int(best[0])
    res = parity.compare_steps((twin[0], other, twin[2]), twin, dup, mask,
                               rule)
    assert res["ties"] == 1


def _bitmap_loop_outputs(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (2, 40, 9), dtype=np.uint32)
    a &= rng.integers(0, 2 ** 32, (2, 40, 9), dtype=np.uint32)
    a[:, ::3, 0] |= np.uint32(2 ** 31)
    mat = TR.to_words(a).transpose(-1, -2)
    row = torch.zeros(2, 9, dtype=TR.WORD_DTYPE)
    mask = torch.ones(2, 40)
    mask[1, 5:] = 0.0           # greedy 1 runs out: −inf gains, bests −1
    return TL.greedy_loop_plain(mat, row, mask, 8, TR.BITS_OR)


@pytest.mark.parametrize("fault", ["none", "gain", "inf", "word", "best"])
def test_exact_rule_measures_and_rejects_any_difference(fault):
    """compare_exact passes only bit-equal outputs and reports what it
    measured: 0 error and 0 differing entries when equal; any moved bit
    of a row word, a best, or a gain (by 1, or −inf for a finite gain)
    fails it."""
    plain = _bitmap_loop_outputs()
    rows, bests, gains = (t.clone() for t in plain)
    assert bool(torch.isinf(gains[1]).any())
    if fault == "none":
        out = parity.compare_exact((rows, bests, gains), plain)
        assert out["differing"] == 0 and out["max_abs_err"] == 0.0
        assert out["entries"] == sum(t.numel() for t in plain)
        assert out["accepted"] == int((plain[1] >= 0).sum()) > 0
        return
    if fault == "gain":
        gains[0, 2] += 1.0
    elif fault == "inf":
        gains[0, 1] = -np.inf
    elif fault == "word":
        rows[1, 0] ^= torch.tensor(-2 ** 31, dtype=TR.WORD_DTYPE)
    else:
        bests[0, 3] = -1
    with pytest.raises(AssertionError, match="1 entries differ"):
        parity.compare_exact((rows, bests, gains), plain)
