"""Each CUDA kernel of the port against its plain PyTorch version, on
the card (marker `cuda`; skipped where torch.cuda.is_available() is
False). Imports nothing of JAX, so it runs on a machine with a GPU and no
JAX:  PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda

Each wrapper must launch its kernel (one counted launch), agree with its
plain version under kernels/parity.py's stated tolerances (the bitmap
rule's kernels bit for bit), and raise — never fall back — on what its
kernel does not take. The bf16/int8 cache variants are held bit for bit
to the f32 kernel on the dequantized cache (pairwise[bf16] to the f32
output rounded; the chunked int8 build to quantize_rows on the CPU; the
resident scratch to round_resident of the f32 build), and to their plain
versions under the same rules as the f32 kernels. The stream filter is
held by parity.compare_stream (bitmaps bit for bit), its int8-ground
variant and the int8-ground gains bit for bit to the f32 kernels on the
dequantized ground.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import gen_images
from repro_torch.kernels import counters, ops, plans
from repro_torch.kernels import fused_step as TF
from repro_torch.kernels import greedy_loop as TL
from repro_torch.kernels import pairwise as TP
from repro_torch.kernels import parity
from repro_torch.kernels import ref as TRef
from repro_torch.kernels import rules as TR
from repro_torch.kernels import stream_filter as TS
from repro_torch.runtime import flags

FEATURE_RULES = {
    "kmedoid": TR.DIST_MIN,
    "facility": TR.DOT_MAX,
    "satcover": TR.sat_sum(2.0),
    "graphcut": TR.graph_cut(0.5),
    "mmr": TR.mmr(0.3, 2.0),
}


# the kernel-vs-plain tests run every feature rule and the bitmap rule
KERNEL_RULES = dict(FEATURE_RULES, coverage=TR.BITS_OR)


def _words(shape, seed, device):
    """Sparse random 32-bit words (each bit set with probability 1/8, so
    integer gains tie often), every 7th word with bit 31 set, as int32."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    for _ in range(2):
        a &= rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    a.reshape(-1)[::7] |= np.uint32(2 ** 31)
    return TR.to_words(a).to(device)


def _pools(b=3, n=40, c=24, d=32, seed=0):
    x = gen_images(b * (n + c), d, classes=6, seed=seed)
    return x[:b * n].reshape(b, n, d), x[b * n:].reshape(b, c, d)


# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False on this machine")
    return torch.device("cuda")


def _dev_pools(cuda, b, n, c, d, seed):
    g, cd = _pools(b=b, n=n, c=c, d=d, seed=seed)
    return torch.as_tensor(g).to(cuda), torch.as_tensor(cd).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dot", "dist"])
@pytest.mark.parametrize("shape", [(2, 130, 70, 96), (1, 7, 5, 3)])
def test_cuda_pairwise_kernel_matches_plain(cuda, mode, shape):
    b, n, c, d = shape
    g, cd = _dev_pools(cuda, b, n, c, d, seed=5)
    counters.reset()
    got = TP.pairwise(g, cd, mode)
    assert counters.snapshot()["pairwise"]["launches"] == 1
    want = TP.pairwise_plain(g, cd, mode)
    parity.compare_pairwise(got, want, g, cd, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dot", "dist"])
@pytest.mark.parametrize("shape", [(2, 130, 257, 50), (1, 1, 129, 3),
                                   (2, 257, 130, 96)])
def test_cuda_pairwise_tile_edges(cuda, mode, shape, out_dtype):
    """The 128×128 tile at shapes straddling it: ragged rows and columns,
    and D not a multiple of 4 (the kernel's scalar loads), both stores,
    under the float64 ratio rule against the plain version."""
    b, n, c, d = shape
    g, cd = _dev_pools(cuda, b, n, c, d, seed=21)
    counters.reset()
    got = TP.pairwise(g, cd, mode, out_dtype=out_dtype)
    name = "pairwise" if out_dtype == torch.float32 else "pairwise[bf16]"
    assert counters.snapshot()[name]["launches"] == 1
    want = TP.pairwise_plain(g, cd, mode).to(out_dtype)
    parity.compare_pairwise(got.float(), want.float(), g, cd, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dot", "dist"])
def test_cuda_pairwise_equals_the_resident_build(cuda, mode):
    """Every entry of the pairwise kernel is the resident kernel's build
    (pairwise_tile.cuh's tile) bit for bit, at a shape straddling both
    tiles with scalar loads; one tensor passed as both operands (its
    norms computed once) gives the bits of two equal tensors."""
    b, n, c, d = 2, 130, 257, 50
    g, cd = _dev_pools(cuda, b, n, c, d, seed=22)
    tr = TR.DIST_MIN if mode == "dist" else TR.DOT_MAX
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    ctl = torch.tensor([[4, n, c]] * b, dtype=torch.int32, device=cuda)
    built = torch.empty(b, n, c, device=cuda)
    TL.greedy_loop_resident(g, cd, row, torch.ones(b, c, device=cuda), ctl,
                            4, tr, scratch=built)
    assert torch.equal(TP.pairwise(g, cd, mode), built)
    sq = cd[:, :n].contiguous()
    assert torch.equal(TP.pairwise(sq, sq, mode),
                       TP.pairwise(sq, sq.clone(), mode))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_RULES))
def test_cuda_greedy_loop_kernel_matches_plain(cuda, name):
    tr = KERNEL_RULES[name]
    if tr.is_bitmap:      # 3 greedies × 300 candidates × 45 words, exact
        mat = _words((3, 300, 45), 6, cuda).transpose(-1, -2)
        row = _words((3, 45), 16, cuda)
        mask = (torch.arange(300, device=cuda) % 11 != 3).float().expand(
            3, 300).contiguous()
        counters.reset()
        got = TL.greedy_loop_bits(mat, row, mask, 12, tr, block_c=16)
        assert counters.snapshot()["greedy_loop[coverage]"]["launches"] == 1
        want = TL.greedy_loop_plain(mat, row, mask, 12, tr)
        assert parity.compare_exact(got, want)["accepted"] > 0
        return
    g, cd = _dev_pools(cuda, 3, 300, 90, 32, seed=6)
    mat = TP.pairwise_plain(g, cd, tr.pairwise).contiguous()
    valid = torch.ones(3, 300, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    mask = torch.ones(3, 90, device=cuda)
    counters.reset()
    got = TL.greedy_loop(mat, row, mask, 12, tr, block_n=64)
    assert counters.snapshot()["greedy_loop"]["launches"] == 1
    want = TL.greedy_loop_plain(mat, row, mask, 12, tr)
    parity.compare_loops(got, want, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_RULES))
def test_cuda_resident_kernel_matches_plain(cuda, name):
    tr = KERNEL_RULES[name]
    ctl = torch.tensor([[10, 100, 100], [4, 100, 100]] * 2,
                       dtype=torch.int32, device=cuda)
    if tr.is_bitmap:      # 4 nodes × 100 candidates × 70 words, exact
        cd = _words((4, 100, 70), 7, cuda)
        row = torch.zeros(4, 70, dtype=TR.WORD_DTYPE, device=cuda)
        mask = torch.ones(4, 100, device=cuda)
        want = TL.greedy_loop_resident_plain(None, cd, row, mask, ctl, 10, tr)
        counters.reset()
        got = TL.greedy_loop_resident(None, cd, row, mask, ctl, 10, tr)
        snap = counters.snapshot()
        assert snap["greedy_loop_resident[coverage]"]["launches"] == 1
        assert parity.compare_exact(got, want)["accepted"] > 0
        # a node over several blocks (the default; 3 candidates a block,
        # fewer than its warps) and in one block
        for block_c in (3, 100):
            parity.compare_exact(TL.greedy_loop_resident_bits(
                cd, row, mask, ctl, 10, tr, block_c=block_c), want)
        return
    _, cd = _dev_pools(cuda, 4, 1, 100, 48, seed=7)
    g = cd.clone()
    valid = torch.ones(4, 100, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    mask = torch.ones(4, 100, device=cuda)
    built = torch.empty(4, 100, 100, device=cuda)
    counters.reset()
    got = TL.greedy_loop_resident(g, cd, row, mask, ctl, 10, tr,
                                  scratch=built)
    assert counters.snapshot()["greedy_loop_resident"]["launches"] == 1
    # the resident build is the pairwise kernel's tile code
    assert torch.equal(built, TP.pairwise(g, cd, tr.pairwise))
    want = TL.greedy_loop_resident_plain(g, cd, row, mask, ctl, 10, tr)
    parity.compare_loops(got, want, tr, entry_diff=(
        built - TL.resident_matrix(g, cd, tr)).abs())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_RULES))
@pytest.mark.parametrize("shape", [(3, 300, 130, 8), (2, 7, 5, 1)])
def test_cuda_fused_step_kernel_matches_plain(cuda, name, shape):
    """Fed the plain matrix: rows equal bit for bit, the gain within the
    reordering bound, the pick equal except at a rounding tie — over a
    random mask, for a first step (prev −1) and a later one. The bitmap
    rule (n words, c candidates, block_n candidates per block): every
    output equal bit for bit."""
    tr = KERNEL_RULES[name]
    b, n, c, block_n = shape
    if tr.is_bitmap:
        _fused_step_bits(cuda, tr, b, n, c, block_n)
        return
    g, cd = _dev_pools(cuda, b, n, c, 24, seed=8)
    mat = TP.pairwise_plain(g, cd, tr.pairwise).contiguous()
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(3)
    mask = (torch.rand(b, c, generator=gen, device=cuda) > 0.3).float()
    for prev in (torch.full((b,), -1, device=cuda),
                 torch.randint(0, c, (b,), generator=gen, device=cuda)):
        counters.reset()
        got = TF.fused_step(mat, row, mask, prev, tr, block_n=block_n)
        assert counters.snapshot()["fused_step"]["launches"] == 1
        want = TF.fused_step_plain(mat, row, mask, prev, tr)
        parity.compare_steps(got, want, mat, mask, tr)
    # every candidate masked: first index, −inf, as the plain version
    got = TF.fused_step(mat, row, torch.zeros_like(mask), prev, tr)
    assert bool((got[1] == 0).all()) and bool(torch.isinf(got[2]).all())


def _fused_step_bits(cuda, tr, b, w, c, block_c):
    mat = _words((b, c, w), 8, cuda).transpose(-1, -2)
    row = _words((b, w), 18, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    mask = (torch.rand(b, c, generator=gen, device=cuda) > 0.3).float()
    for prev in (torch.full((b,), -1, device=cuda),
                 torch.randint(0, c, (b,), generator=gen, device=cuda)):
        counters.reset()
        got = TF.fused_step_bits(mat, row, mask, prev, tr, block_c=block_c)
        assert counters.snapshot()["fused_step[coverage]"]["launches"] == 1
        parity.compare_exact(got, TF.fused_step_plain(mat, row, mask, prev,
                                                      tr))
    # every candidate masked: first index, −inf, as the plain version
    zero = torch.zeros_like(mask)
    parity.compare_exact(TF.fused_step_bits(mat, row, zero, prev, tr),
                         TF.fused_step_plain(mat, row, zero, prev, tr))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_RULES))
@pytest.mark.parametrize("shape", [(2, 150, 72, 200), (1, 5, 3, 7)])
def test_cuda_gains_kernel_matches_plain(cuda, name, shape):
    """Gain sums held to a float64 build under the pairwise ratio rule,
    −inf at the invalid candidates, on a live state row. The bitmap rule
    (d words, no ground): equal bit for bit."""
    tr = KERNEL_RULES[name]
    b, n, c, d = shape
    cand_valid = torch.arange(c, device=cuda).expand(b, c) % 5 != 1
    if tr.is_bitmap:
        cd = _words((b, c, d), 9, cuda)
        row = _words((b, d), 19, cuda)
        counters.reset()
        got = TP.gains(None, row, cd, cand_valid, tr)
        assert counters.snapshot()["gains[coverage]"]["launches"] == 1
        parity.compare_exact(got, TP.gains_plain(None, row, cd, cand_valid,
                                                 tr))
        return
    g, cd = _dev_pools(cuda, b, n, c, d, seed=9)
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr)
    for j in range(min(3, n)):
        row = TR.update_row(g, row, g[:, j], tr)
    row = row.contiguous()
    counters.reset()
    got = TP.gains(g, row, cd, cand_valid, tr)
    assert counters.snapshot()["gains"]["launches"] == 1
    want = TP.gains_plain(g, row, cd, cand_valid, tr)
    parity.compare_gains(got, want, g, row, cd, tr)


STORED = ["bfloat16", "int8"]


# the redesigned step kernels: gains on 64-row tiles of the candidate
# width that pads C least (C = 1 and 128: one and two 64-wide tiles; 65
# and 72: one 80-wide; 129: two 80-wide), fused_step in 16-byte loads
# over clusters
GAINS_SHAPES = [(2, 150, c, d) for c in (1, 65, 72, 128, 129)
                for d in (520, 517)]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "int8"])
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
@pytest.mark.parametrize("shape", GAINS_SHAPES)
def test_cuda_gains_equals_the_64x64_build(cuda, shape, name, storage):
    """The gains kernel at ragged C (one or two 64- or 80-wide tiles), N
    off the 64-row grid and D = 520 or off the 16-byte
    grid, f32 and int8 ground: the ground's norms passed (as the step
    engine passes them) give the bits of the norms computed per call, and
    both equal the 64x64-tile build (its norms inline) bit for bit. Held
    to the plain version by the float64 rule where it has gains enough
    to be a statistic (C ≥ 65: 2·C of them; at C = 1 two gains make its
    RMS and max ratios noise, and the bits are the 64x64 build's, which
    test_cuda_gains_kernel_matches_plain and chip_smoke.py hold)."""
    tr = FEATURE_RULES[name]
    b, n, c, d = shape
    g, cd = _dev_pools(cuda, b, n, c, d, seed=21)
    kw, deq = {}, g
    if storage == "int8":
        q, scale = ops.quantize_ground(g)
        kw, g, deq = {"gscale": scale}, q, TR.dequant(q, scale).contiguous()
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(deq, valid, tr)
    for j in range(3):
        row = TR.update_row(deq, row, deq[:, 11 * j], tr)
    row = row.contiguous()
    cv = torch.arange(c, device=cuda).expand(b, c) % 5 != 1
    tag = "[int8]" if storage == "int8" else ""
    counters.reset()
    got = TP.gains(g, row, cd, cv, tr, **kw)
    snap = counters.snapshot()
    assert snap["gains" + tag]["launches"] == 1
    assert snap["gains_norms"]["launches"] == (tr.pairwise == "dist")
    gnorm = TP.ground_norms(g, kw.get("gscale"))
    parity.compare_exact(got, TP.gains(g, row, cd, cv, tr, gnorm=gnorm, **kw),
                         "gains, gnorm passed")
    parity.compare_exact(got, TP.gains(g, row, cd, cv, tr, reference=True,
                                       **kw), "gains vs the 64x64 build")
    if c > 1:
        parity.compare_gains(got, TP.gains_plain(g, row, cd, cv, tr,
                                                 kw.get("gscale")),
                             deq, row, cd, tr)


@pytest.mark.cuda
def test_cuda_gains_norms_are_the_rows_float64_chain(cuda):
    """ground_norms: the float64 sum of squares of each (dequantized) row
    cast once to f32 — the chain in ascending order, so within one f32
    rounding of the float64 value; the int8 rows' norms are the
    dequantized rows'."""
    g, _ = _dev_pools(cuda, 2, 70, 1, 517, seed=22)
    want = g.double().square().sum(-1)
    got = TP.ground_norms(g)
    assert torch.allclose(got.double(), want, rtol=2 * 2 ** -24, atol=0)
    q, scale = ops.quantize_ground(g)
    deq = TR.dequant(q, scale)
    assert torch.equal(TP.ground_norms(q, scale), TP.ground_norms(
        deq.contiguous()))
    with pytest.raises(ValueError):
        TP.ground_norms(q)


# (B, N, C). The cluster each storage's kernel picks (f32 / bf16 / int8;
# csrc/fused_step.cu:rt_fused_cluster, the smallest of 1..8 leaving a lane
# group one chunk of 32 rows): (1, 300, 131) 2 / 1 / 1; (3, 77, 160) and
# (1, 5, 3) 1; (2, 1000, 257) 4 / 2 / 1; (1, 2000, 20) 8 / 4 / 2. The
# last shape's partials fit no cluster: the global tier.
FUSED_SHAPES = [(1, 300, 131), (3, 77, 160), (2, 1000, 257), (1, 2000, 20),
                (1, 5, 3), (1, 100_000, 5)]


def _misaligned(t):
    """A contiguous copy of t whose first byte lies off the 16-byte grid."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32"] + STORED)
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_cuda_fused_step_equals_the_earlier_design(cuda, shape, name, dtype):
    """fused_step over two steps, at B = 1 and ragged N, at odd C (rows
    off the 16-byte grid: the shuffled loads) and C a multiple of 16 (the
    aligned loads), over f32, bf16 and int8 caches, on clusters of 1, 2,
    4 and 8 blocks a span and on the global tier: bit for bit the
    earlier design (row blocks summed by one last block), also over a
    matrix whose base is off the 16-byte grid (scalar loads), and held
    to the plain version by compare_steps."""
    tr = FEATURE_RULES[name]
    b, n, c = shape
    g, cd = _dev_pools(cuda, b, n, c, 24, seed=23)
    m32 = TP.pairwise_plain(g, cd, tr.pairwise).contiguous()
    mat, scale = ((m32, None) if dtype == "float32"
                  else _stored(m32, dtype))
    logical = TR.logical(mat, scale).contiguous()
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(5)
    mask = (torch.rand(b, c, generator=gen, device=cuda) > 0.3).float()
    prev = torch.full((b,), -1, device=cuda)
    tag = {"float32": "", "bfloat16": "[bf16]", "int8": "[int8]"}[dtype]
    odd = _misaligned(mat)
    assert odd.data_ptr() % 16 != 0
    assert plans.fused_cluster_fits(dtype, n, plans.FUSED_BLOCK_N) == (
        n < 100_000)
    for _ in range(2):
        counters.reset()
        got = TF.fused_step(mat, row, mask, prev, tr, scale=scale)
        assert counters.snapshot()["fused_step" + tag]["launches"] == 1
        want = TF.fused_step(mat, row, mask, prev, tr, scale=scale,
                             reference=True)
        parity.compare_exact(got, want, "fused_step vs the earlier design")
        parity.compare_exact(TF.fused_step(odd, row, mask, prev, tr,
                                           scale=scale), want,
                             "fused_step, base off the 16-byte grid")
        plain = TF.fused_step_plain(mat, row, mask, prev, tr, scale=scale)
        parity.compare_steps(got, plain, logical, mask, tr)
        row, prev = plain[0], plain[1]
        mask = mask.scatter(1, prev[:, None], 0.0)


def _stored(mat, dtype):
    """An f32 (B, N, C) matrix in `dtype` storage → (matrix, scale)."""
    if dtype == "int8":
        return TR.quantize_rows(mat)
    return mat.to(torch.bfloat16), None


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dot", "dist"])
@pytest.mark.parametrize("shape", [(2, 130, 70, 96), (1, 7, 5, 3)])
def test_cuda_pairwise_bf16_kernel(cuda, mode, shape):
    """The bf16 output is the f32 kernel's output rounded to nearest even,
    bit for bit, and holds to the plain version (rounded alike) under the
    float64 ratio rule."""
    b, n, c, d = shape
    g, cd = _dev_pools(cuda, b, n, c, d, seed=15)
    counters.reset()
    got = TP.pairwise(g, cd, mode, out_dtype=torch.bfloat16)
    assert counters.snapshot()["pairwise[bf16]"]["launches"] == 1
    parity.compare_exact(got, TP.pairwise(g, cd, mode).to(torch.bfloat16))
    want = TP.pairwise_plain(g, cd, mode).to(torch.bfloat16)
    parity.compare_pairwise(got.float(), want.float(), g, cd, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_cuda_int8_cache_built_in_chunks(cuda, name, monkeypatch):
    """ops.pairwise_matrix to int8 on the card, two greedies a chunk,
    equals quantize_rows of the whole f32 kernel output on the CPU (IEEE
    divisions on both), q and scales bit for bit."""
    tr = FEATURE_RULES[name]
    g, cd = _dev_pools(cuda, 5, 70, 45, 24, seed=16)
    monkeypatch.setattr(plans, "QUANT_CHUNK_BYTES", 2 * 4 * 70 * 45)
    counters.reset()
    got = ops.pairwise_matrix(g, cd, tr, dtype="int8")
    assert counters.snapshot()["pairwise"]["launches"] == 3
    q, scale = TR.quantize_rows(TP.pairwise(g, cd, tr.pairwise).cpu())
    parity.compare_exact((got.q, got.scale), (q, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", STORED)
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_cuda_fused_step_quant_kernel(cuda, name, dtype):
    """fused_step over a bf16/int8 cache: bit for bit the f32 kernel over
    the dequantized cache, two steps; held to the plain version as the
    f32 kernel is."""
    tr = FEATURE_RULES[name]
    g, cd = _dev_pools(cuda, 3, 300, 130, 24, seed=17)
    mat, scale = _stored(TP.pairwise_plain(g, cd, tr.pairwise), dtype)
    logical = TR.logical(mat, scale).contiguous()
    valid = torch.ones(3, 300, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(4)
    mask = (torch.rand(3, 130, generator=gen, device=cuda) > 0.3).float()
    tag = "[bf16]" if dtype == "bfloat16" else "[int8]"
    for prev in (torch.full((3,), -1, device=cuda),
                 torch.randint(0, 130, (3,), generator=gen, device=cuda)):
        counters.reset()
        got = TF.fused_step(mat, row, mask, prev, tr, block_n=8, scale=scale)
        assert counters.snapshot()["fused_step" + tag]["launches"] == 1
        parity.compare_exact(got, TF.fused_step(logical, row, mask, prev, tr,
                                                block_n=8))
        want = TF.fused_step_plain(mat, row, mask, prev, tr, scale=scale)
        parity.compare_steps(got, want, logical, mask, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", STORED)
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_cuda_greedy_loop_quant_kernel(cuda, name, dtype):
    """The streaming loop over a bf16/int8 cache: bit for bit the f32
    kernel over the dequantized cache; held to the plain version."""
    tr = FEATURE_RULES[name]
    g, cd = _dev_pools(cuda, 3, 300, 90, 32, seed=18)
    mat, scale = _stored(TP.pairwise_plain(g, cd, tr.pairwise), dtype)
    valid = torch.ones(3, 300, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    mask = torch.ones(3, 90, device=cuda)
    counters.reset()
    got = TL.greedy_loop(mat, row, mask, 12, tr, block_n=64, scale=scale)
    tag = "[bf16]" if dtype == "bfloat16" else "[int8]"
    assert counters.snapshot()["greedy_loop" + tag]["launches"] == 1
    parity.compare_exact(got, TL.greedy_loop(
        TR.logical(mat, scale).contiguous(), row, mask, 12, tr, block_n=64))
    parity.compare_loops(got, TL.greedy_loop_plain(mat, row, mask, 12, tr,
                                                   scale=scale), tr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", STORED)
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_cuda_resident_quant_kernel(cuda, name, dtype):
    """The resident loop under a bf16/int8 plan, two of its four nodes
    with logical extents short of the shapes: the scratch it runs over is
    round_resident of its f32 build (the pairwise kernel's) bit for bit;
    its outputs hold to the plain version with the measured entry
    differences."""
    tr = FEATURE_RULES[name]
    ctl = torch.tensor([[10, 100, 100], [4, 90, 95], [10, 100, 100],
                        [6, 97, 80]], dtype=torch.int32, device=cuda)
    _, cd = _dev_pools(cuda, 4, 1, 100, 48, seed=19)
    g = cd.clone()
    valid = torch.ones(4, 100, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    mask = torch.ones(4, 100, device=cuda)
    built = torch.empty(4, 100, 100, device=cuda)
    counters.reset()
    got = TL.greedy_loop_resident(g, cd, row, mask, ctl, 10, tr,
                                  cache_dtype=dtype, scratch=built)
    tag = "[bf16]" if dtype == "bfloat16" else "[int8]"
    assert counters.snapshot()["greedy_loop_resident" + tag]["launches"] == 1
    parity.compare_exact(built, TL.round_resident(
        TP.pairwise(g, cd, tr.pairwise), dtype, ctl))
    want = TL.greedy_loop_resident_plain(g, cd, row, mask, ctl, 10, tr,
                                         cache_dtype=dtype)
    parity.compare_loops(got, want, tr, entry_diff=(
        built - TL.resident_matrix(g, cd, tr, ctl, dtype)).abs())


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda, monkeypatch):
    """The per-step gains over int8-quantized ground features
    (REPRO_TORCH_FUSED_CACHE_DTYPE=int8) launch the int8 gains kernel
    (they raised before it existed); what still has no CUDA path raises
    rather than run a plain version on the card: a fold the kernels do
    not know and a stream over bf16 ground features. A stream whose
    level state does not fit a block's shared memory runs the kernel's
    global-memory tier (one launch), equal to the shared-memory tier."""
    feats = torch.rand(1, 8, 4, device=cuda)
    cv = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    monkeypatch.setenv("REPRO_TORCH_FUSED_CACHE_DTYPE", "int8")
    counters.reset()
    ops.gains(feats, torch.zeros(1, 8, device=cuda), feats, cv, TR.DOT_MAX)
    snap = counters.snapshot()
    assert snap["gains[int8]"]["launches"] == 1
    assert snap.get("gains", {"launches": 0})["launches"] == 0
    odd = TR.KernelRule("odd", "dot", "median", "float32", 0.0)
    with pytest.raises(NotImplementedError):
        TP.gains(feats, torch.zeros(1, 8, device=cuda), feats, cv, odd)
    st = _stream_state(cuda, TR.DOT_MAX, 1, 8, 8)
    with pytest.raises(NotImplementedError):
        TS.stream_filter(feats[0].to(torch.bfloat16), feats[:, :3], *st,
                         cv[:, :3], 2, EPS_LOG, TR.DOT_MAX)
    args = (feats[0], feats[0, :3], *st, cv[0, :3], 2, EPS_LOG, TR.DOT_MAX)
    want = ops.stream_filter(*args)
    monkeypatch.setattr(plans, "STREAM_SMEM_BYTES", 64)
    counters.reset()
    got = ops.stream_filter(*args)
    # the forced int8 rung quantizes the stream's ground too
    assert counters.snapshot()["stream_filter[int8]"]["launches"] == 1
    parity.compare_exact(got, want, "stream_filter, global tier")


# ---------------------------------------------------------------------------
# the stream filter (B6) and the int8-ground gains (B2q)
# ---------------------------------------------------------------------------

EPS_LOG = math.log1p(0.1)


def _stream_state(cuda, tr, g, l, n, row0=None, cost=False):
    """Empty stacked sieve state (rows, row0, values, counts, expos, m
    [, spent]) for the kernel wrapper's canonical shapes."""
    if row0 is None:
        row0 = (torch.zeros(n, dtype=TR.WORD_DTYPE, device=cuda)
                if tr.is_bitmap else torch.zeros(n, device=cuda))
    st = (row0.expand(g, l, n).contiguous(), row0,
          torch.zeros(g, l, device=cuda),
          torch.zeros(g, l, dtype=torch.int32, device=cuda),
          torch.arange(l, dtype=torch.int32, device=cuda).expand(
              g, l).contiguous(),
          torch.zeros(g, device=cuda))
    return st + (torch.zeros(g, l, device=cuda),) if cost else st


def _stream_batches(cuda, a, b, d, n_batches, seed, words=False):
    """Arrival batches (A, B, d) growing in scale (the window slides),
    ~85% valid, with costs uniform(0.5, 2)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        if words:
            x = _words((a, b, d), seed + i, cuda)
        else:
            x = torch.as_tensor((0.5 + i) * rng.normal(size=(a, b, d))
                                .astype(np.float32), device=cuda)
        valid = torch.as_tensor(rng.random((a, b)) > 0.15, device=cuda)
        costs = torch.as_tensor(rng.uniform(0.5, 2.0, (a, b)).astype(
            np.float32), device=cuda)
        out.append((x, valid, costs))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("lanes", [(1, 1), (3, 1), (2, 2)])
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_cuda_stream_filter_matches_plain(cuda, name, lanes, cost):
    """B6 over feature rules, three chained batches fed the plain
    version's state on both sides: the slab by the float64 pairwise
    rule, the decisions by parity.compare_stream; one launch a batch for
    all G sieves (A = 1: shared arrivals, A = G: one batch a sieve)."""
    tr = FEATURE_RULES[name]
    g, a = lanes
    n, b, d, k = 150, 70, 40, 5
    l = 32
    ground = torch.as_tensor(np.random.default_rng(1).normal(
        size=(n, d)).astype(np.float32), device=cuda)
    valid_g = torch.ones(1, n, dtype=torch.bool, device=cuda)
    row0 = TR.empty_row(ground[None], valid_g, tr)[0].contiguous()
    st = _stream_state(cuda, tr, g, l, n, row0, cost)
    ties = 0
    for x, valid, costs in _stream_batches(cuda, a, b, d, 3, 2):
        kw = dict(costs=costs, spent=st[6], budget=6.0) if cost else {}
        mat_k = torch.empty(a, b, n, device=cuda)
        counters.reset()
        got = TS.stream_filter(ground, x, *st[:6], valid, k, EPS_LOG, tr,
                               scratch=mat_k, **kw)
        assert counters.snapshot()["stream_filter"]["launches"] == 1
        want = TS.stream_filter_plain(ground, x, *st[:6], valid, k,
                                      EPS_LOG, tr, **kw)
        mat_p = TRef.pairwise(ground, x, tr)
        parity.compare_pairwise(mat_k.transpose(1, 2), mat_p,
                                ground.expand(a, n, d), x, tr.pairwise)
        res = parity.compare_stream(
            got, want, mat_k, mat_p, st[:6] + ((st[6],) if cost else
                                               (None,)),
            valid, k, EPS_LOG, tr, costs=costs if cost else None,
            budget=6.0 if cost else None)
        ties += res["ties"] + res["window_ties"]
        st = tuple(want[i] for i in (0,)) + (row0,) + tuple(
            want[i] for i in (1, 2, 4, 5)) + ((want[7],) if cost else ())
    assert int(st[3].sum()) > 0 or ties


@pytest.mark.cuda
@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("lanes", [(1, 1), (3, 1), (2, 2)])
@pytest.mark.parametrize("variant", ["kmedoid", "facility", "kmedoid[int8]",
                                     "coverage"])
def test_cuda_stream_filter_global_tier(cuda, variant, lanes, cost,
                                        monkeypatch):
    """The global-memory tier (forced by squeezing STREAM_SMEM_BYTES)
    equals the shared-memory tier bit for bit, every output and the
    slab, over three chained batches: f32 and int8 ground, bitmaps, one
    sieve and several, with and without costs; one launch a call."""
    g, a = lanes
    bits = variant == "coverage"
    tr = KERNEL_RULES[variant.split("[")[0]]
    if bits:
        n, b, d, k, l = 45, 64, 45, 6, 24
        ground, gkw, st = None, {}, _stream_state(cuda, tr, g, l, n,
                                                  cost=cost)
    else:
        n, b, d, k, l = 150, 70, 40, 5, 32
        ground = torch.as_tensor(np.random.default_rng(8).normal(
            size=(n, d)).astype(np.float32), device=cuda)
        row0 = TR.empty_row(ground[None], torch.ones(
            1, n, dtype=torch.bool, device=cuda), tr)[0].contiguous()
        st = _stream_state(cuda, tr, g, l, n, row0, cost)
        gkw = {}
        if variant.endswith("[int8]"):
            ground, scale = ops.quantize_ground(ground)
            gkw = {"gscale": scale.reshape(-1)}
    tag = "stream_filter" + ("[coverage]" if bits else (
        "[int8]" if gkw else ""))
    for x, valid, costs in _stream_batches(cuda, a, b, d, 3, 9, words=bits):
        kw = dict(costs=costs, spent=st[6], budget=6.0) if cost else {}
        kw.update(gkw)
        slabs = [] if bits else [torch.empty(a, b, n, device=cuda)
                                 for _ in range(2)]
        outs = []
        counters.reset()
        for tier, smem in (("kernel", plans.STREAM_SMEM_BYTES), ("global",
                                                                 64)):
            monkeypatch.setattr(plans, "STREAM_SMEM_BYTES", smem)
            assert plans.stream_tier(n, b, tr) == tier
            if not bits:
                kw["scratch"] = slabs[len(outs)]
            outs.append(TS.stream_filter(ground, x, *st[:6], valid, k,
                                         EPS_LOG, tr, **kw))
            monkeypatch.undo()
        assert counters.snapshot()[tag]["launches"] == 2
        shared, glob = outs
        parity.compare_exact(glob + tuple(slabs[1:]),
                             shared + tuple(slabs[:1]),
                             f"{tag}, global vs shared-memory tier")
        st = (shared[0], st[1], shared[1], shared[2], shared[4],
              shared[5]) + ((shared[7],) if cost else ())
    assert int(st[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_cuda_stream_filter_int8_ground(cuda, name, cost):
    """B6 over an int8 ground: every output and the slab equal bit for
    bit to the f32 kernel on the dequantized ground."""
    tr = FEATURE_RULES[name]
    n, b, d, k, l, g = 130, 70, 40, 5, 32, 2
    ground = torch.as_tensor(np.random.default_rng(3).normal(
        size=(n, d)).astype(np.float32), device=cuda)
    q, scale = ops.quantize_ground(ground)
    deq = TR.dequant(q, scale).contiguous()
    row0 = TR.empty_row(ground[None], torch.ones(1, n, dtype=torch.bool,
                                                 device=cuda), tr)[0]
    st = _stream_state(cuda, tr, g, l, n, row0.contiguous(), cost)
    for x, valid, costs in _stream_batches(cuda, 1, b, d, 3, 4):
        kw = dict(costs=costs, spent=st[6], budget=6.0) if cost else {}
        mq, mf = (torch.empty(1, b, n, device=cuda) for _ in range(2))
        counters.reset()
        got = TS.stream_filter(q, x, *st[:6], valid, k, EPS_LOG, tr,
                               gscale=scale.reshape(-1), scratch=mq, **kw)
        assert counters.snapshot()["stream_filter[int8]"]["launches"] == 1
        f32 = TS.stream_filter(deq, x, *st[:6], valid, k, EPS_LOG, tr,
                               scratch=mf, **kw)
        parity.compare_exact(got + (mq,), f32 + (mf,),
                             "stream_filter[int8] vs the f32 kernel")
        st = (f32[0], st[1], f32[1], f32[2], f32[4], f32[5]) + (
            (f32[7],) if cost else ())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_cuda_stream_ground_norms_go_with_the_stored_ground(cuda, name,
                                                            monkeypatch):
    """Under the int8 rung an f32 ground goes through ops.stream_ground:
    its norms are the int8 rows' (ground_norms of the stored ground), the
    filter given the triple equals, bit for bit, the filter quantizing
    the f32 ground itself, and the f32 rows' norms beside that f32
    ground raise instead of reaching the slab."""
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    tr = FEATURE_RULES[name]
    n, b, d, k, l, g = 130, 70, 40, 5, 32, 2
    ground = torch.as_tensor(np.random.default_rng(5).normal(
        size=(n, d)).astype(np.float32), device=cuda)
    stored, gscale, gnorm = ops.stream_ground(ground, "int8", tr)
    assert stored.dtype == torch.int8
    if tr.pairwise == "dist":
        assert torch.equal(gnorm, TS.ground_norms(stored, gscale))
    else:
        assert gnorm is None
    row0 = TR.empty_row(ground[None], torch.ones(1, n, dtype=torch.bool,
                                                 device=cuda), tr)[0]
    st = _stream_state(cuda, tr, g, l, n, row0.contiguous())
    for x, valid, _ in _stream_batches(cuda, 1, b, d, 3, 6):
        want = ops.stream_filter(ground, x, *st[:6], valid, k, EPS_LOG, tr)
        got = ops.stream_filter(stored, x, *st[:6], valid, k, EPS_LOG, tr,
                                gscale=gscale, gnorm=gnorm)
        parity.compare_exact(got, want, "stream_ground's triple vs the "
                             "filter's own quantizing")
        with pytest.raises(ValueError, match="gnorm"):
            ops.stream_filter(ground, x, *st[:6], valid, k, EPS_LOG, tr,
                              gnorm=TS.ground_norms(ground))
        st = (want[0], st[1], want[1], want[2], want[4], want[5])
    assert int(st[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("lanes", [(1, 1), (5, 1), (4, 4)])
def test_cuda_stream_filter_bits_matches_plain(cuda, lanes, cost):
    """B6 over bitmaps: every output equal bit for bit to the plain
    version, chained over three batches, one launch a batch."""
    tr = TR.BITS_OR
    g, a = lanes
    w, b, k, l = 45, 64, 6, 24
    st = _stream_state(cuda, tr, g, l, w, cost=cost)
    for x, valid, costs in _stream_batches(cuda, a, b, w, 3, 7, words=True):
        kw = dict(costs=costs, spent=st[6], budget=5.0) if cost else {}
        counters.reset()
        got = TS.stream_filter(None, x, *st[:6], valid, k, EPS_LOG, tr, **kw)
        assert counters.snapshot()["stream_filter[coverage]"][
            "launches"] == 1
        want = TS.stream_filter_plain(None, x, *st[:6], valid, k, EPS_LOG,
                                      tr, **kw)
        parity.compare_exact(got, want, "stream_filter[coverage]")
        st = (want[0], st[1], want[1], want[2], want[4], want[5]) + (
            (want[7],) if cost else ())
    assert int(st[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "int8"])
@pytest.mark.parametrize("name", ["kmedoid", "facility", "satcover"])
@pytest.mark.parametrize("shape", [(1, 70, 150, 40), (2, 130, 257, 50),
                                   (1, 5, 3, 7), (1, 129, 300, 520)])
def test_cuda_stream_slab_equals_the_64x64_build(cuda, shape, name,
                                                 storage):
    """The stream filter's slab on the 128x128 tile equals the 64x64
    tile's build (FOLD: 256 features a partial) bit for bit, every entry
    and every singleton partial, for f32 and int8 ground, at ragged N,
    B and D (D = 520 folds twice and leaves a tail); the norms come from
    the once-per-evaluation-set pass."""
    a, b, n, d = shape
    tr = FEATURE_RULES[name]
    rng = np.random.default_rng(31)
    ground = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                             device=cuda)
    x = torch.as_tensor(rng.normal(size=(a, b, d)).astype(np.float32),
                        device=cuda)
    row0 = TR.empty_row(ground[None], torch.ones(1, n, dtype=torch.bool,
                                                 device=cuda), tr)[0]
    row0 = row0.contiguous()
    gscale = None
    if storage == "int8":
        ground, scale = ops.quantize_ground(ground)
        gscale = scale.reshape(-1).contiguous()
    gnorm = (TS.ground_norms(ground, gscale) if tr.pairwise == "dist"
             else None)
    got = TS.stream_slab(ground, x, row0, tr, gscale=gscale, gnorm=gnorm)
    want = TS.stream_slab(ground, x, row0, tr, gscale=gscale,
                          reference=True)
    # the float64 partials compared as their 64-bit words
    parity.compare_exact((got[0], got[1].view(torch.int64)),
                         (want[0], want[1].view(torch.int64)),
                         "stream slab vs the 64x64 build")
    # the filter's own slab is the same build
    st = _stream_state(cuda, tr, a, 8, n, row0)
    mat = torch.empty(a, b, n, device=cuda)
    valid = torch.ones(a, b, dtype=torch.bool, device=cuda)
    TS.stream_filter(ground, x, *st, valid, 3, EPS_LOG, tr, gscale=gscale,
                     scratch=mat)
    parity.compare_exact(mat, want[0], "stream_filter's slab")


@pytest.mark.cuda
@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("lanes", [(1, 1), (3, 1), (2, 2)])
@pytest.mark.parametrize("variant", ["kmedoid", "facility", "kmedoid[int8]",
                                     "mmr"])
def test_cuda_stream_decisions_on_both_tiers(cuda, variant, lanes, cost,
                                             monkeypatch):
    """The feature decisions give the same bits on the shared-memory tier
    (a cluster of 8 blocks a level, a chunk of the row each) and on the
    device-memory tier (forced by squeezing the byte gate), every output,
    over three chained batches (ragged N, so the chunks end unevenly and
    the scalar path runs; N = 256 for the 16-byte one); and hold to the
    plain version by parity.compare_stream."""
    g, a = lanes
    tr = FEATURE_RULES[variant.split("[")[0]]
    k, l = 5, 32
    for n in (150, 203, 256):
        b, d = 70, 40
        ground = torch.as_tensor(np.random.default_rng(n).normal(
            size=(n, d)).astype(np.float32), device=cuda)
        row0 = TR.empty_row(ground[None], torch.ones(
            1, n, dtype=torch.bool, device=cuda), tr)[0].contiguous()
        gkw = {}
        g_in = ground
        if variant.endswith("[int8]"):
            ground, scale = ops.quantize_ground(ground)
            gkw = {"gscale": scale.reshape(-1).contiguous()}
            g_in = TR.dequant(ground, scale).contiguous()
        st = _stream_state(cuda, tr, g, l, n, row0, cost)
        for x, valid, costs in _stream_batches(cuda, a, b, d, 3, n):
            kw = dict(costs=costs, spent=st[6], budget=6.0) if cost else {}
            assert plans.stream_tier(n, b, tr) == "kernel"
            mat_k = torch.empty(a, b, n, device=cuda)
            got = TS.stream_filter(ground, x, *st[:6], valid, k, EPS_LOG,
                                   tr, scratch=mat_k, **kw, **gkw)
            monkeypatch.setattr(plans, "STREAM_SMEM_BYTES", 64)
            assert plans.stream_tier(n, b, tr) == "global"
            off_chip = TS.stream_filter(ground, x, *st[:6], valid, k,
                                        EPS_LOG, tr, **kw, **gkw)
            monkeypatch.undo()
            parity.compare_exact(off_chip, got, "decisions, device-memory "
                                 "tier vs the cluster's shared memory")
            want = TS.stream_filter_plain(g_in, x, *st[:6], valid, k,
                                          EPS_LOG, tr, **kw)
            parity.compare_stream(
                got, want, mat_k, TRef.pairwise(g_in, x, tr),
                st[:6] + ((st[6],) if cost else (None,)), valid, k,
                EPS_LOG, tr, costs=costs if cost else None,
                budget=6.0 if cost else None)
            st = (want[0], st[1], want[1], want[2], want[4], want[5]) + (
                (want[7],) if cost else ())
        assert int(st[3].sum()) > 0


def _sets(a, b, words, items, seed, cuda):
    """(a, b, words) bitmaps of random sets of ~`items` items each (a
    kosarak-like sparse stream: a set touches ~items of its words)."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((a * b, words), np.uint32)
    for i in range(a * b):
        its = rng.choice(words * 32, size=rng.integers(1, 2 * items),
                         replace=False)
        np.bitwise_or.at(bits[i], its // 32,
                         (np.uint32(1) << (its % 32).astype(np.uint32)))
    return TR.to_words(bits.reshape(a, b, words)).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("lanes", [(1, 1), (5, 1), (4, 4)])
@pytest.mark.parametrize("words", [1_290, 8_192])
def test_cuda_stream_filter_bits_sparse_sets(cuda, words, lanes, cost,
                                            monkeypatch):
    """B6 over bitmaps at kosarak-like (1,290 words, sets of ~15 items)
    and wider (8,192 words) shapes: one sieve, a window's 5 checkpoints
    and 4 continuous lanes, with and without costs, every output bit for
    bit equal to the plain version over three chained batches, on the
    shared-memory tier and, forced, the device-memory tier."""
    tr = TR.BITS_OR
    g, a = lanes
    b, k, l = 256 // a, 16, 24
    st = _stream_state(cuda, tr, g, l, words, cost=cost)
    rng = np.random.default_rng(words + g)
    admitted = 0
    for i in range(3):
        x = _sets(a, b, words, 15, 100 * i + g, cuda)
        valid = torch.as_tensor(rng.random((a, b)) > 0.1, device=cuda)
        costs = torch.as_tensor(rng.uniform(0.5, 2.0, (a, b)).astype(
            np.float32), device=cuda)
        kw = dict(costs=costs, spent=st[6], budget=8.0) if cost else {}
        want = TS.stream_filter_plain(None, x, *st[:6], valid, k, EPS_LOG,
                                      tr, **kw)
        assert plans.stream_tier(words, b, tr) == "kernel"
        counters.reset()
        got = TS.stream_filter(None, x, *st[:6], valid, k, EPS_LOG, tr, **kw)
        assert counters.snapshot()["stream_filter[coverage]"][
            "launches"] == 1
        parity.compare_exact(got, want, "stream_filter[coverage]")
        monkeypatch.setattr(plans, "STREAM_SMEM_BYTES", 64)
        glob = TS.stream_filter(None, x, *st[:6], valid, k, EPS_LOG, tr,
                                **kw)
        monkeypatch.undo()
        parity.compare_exact(glob, want, "stream_filter[coverage], global")
        admitted += int(want[3].sum())
        st = (want[0], st[1], want[1], want[2], want[4], want[5]) + (
            (want[7],) if cost else ())
    assert admitted > 0


@pytest.mark.cuda
@pytest.mark.parametrize("a", [1, 3])
def test_cuda_scatter_slots_matches_plain(cuda, a):
    """The slot update writes what the reference's one-hot formula
    gives, in place."""
    g, l, b, k, d = 3, 8, 20, 4, 9
    gen = torch.Generator(device=cuda).manual_seed(5)
    ids = torch.randint(0, 99, (g, l, k), generator=gen, device=cuda)
    pay = torch.rand(g, l, k, d, generator=gen, device=cuda)
    counts = torch.randint(0, k + 1, (g, l), generator=gen, device=cuda,
                           dtype=torch.int32)
    expired = torch.rand(g, l, generator=gen, device=cuda) < 0.3
    admits = torch.rand(g, l, b, generator=gen, device=cuda) < 0.1
    # never more admits than free slots, as the kernel guarantees
    free = torch.where(expired, k, k - counts).unsqueeze(-1)
    admits &= torch.cumsum(admits.int(), -1) <= free
    bids = torch.randint(0, 99, (a, b), generator=gen, device=cuda)
    bpay = torch.rand(a, b, d, generator=gen, device=cuda)
    want = TS.scatter_slots_plain(ids, pay, counts, expired, admits, bids,
                                  bpay, k)
    counters.reset()
    got = TS.scatter_slots(ids.clone(), pay.clone(), counts, expired,
                           admits, bids, bpay, k)
    assert counters.snapshot()["scatter_slots"]["launches"] == 1
    parity.compare_exact(got, want, "scatter_slots")


@pytest.mark.cuda
def test_cuda_window_is_one_launch_per_batch(cuda):
    """A sliding window of 5 checkpoints over a coverage stream: one
    stream-filter launch a batch for all checkpoints and levels; its
    query equals the CPU path's."""
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import gen_stream
    from repro_torch.streaming import SieveStreamer, SlidingSieve
    st = gen_stream("kcover", 256, universe=384, batch=16, seed=2)
    out = {}
    for dev in ("cuda", "cpu"):
        obj = make_objective("kcover", universe=384, device=dev)
        win = SlidingSieve(SieveStreamer(obj, 6), 64, 16)
        ws = win.init()
        counters.reset()
        for ids, pay, valid in st:
            ws = win.process_batch(ws, ids, pay, valid)
        snap = counters.snapshot()["stream_filter[coverage]"]
        out[dev] = win.query(ws).map(lambda t: t.cpu())
        if dev == "cuda":
            assert snap["launches"] == 256 // 16 == snap["calls"]
    assert torch.equal(out["cuda"].ids, out["cpu"].ids)
    assert torch.equal(out["cuda"].value, out["cpu"].value)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
@pytest.mark.parametrize("shape", [(2, 150, 72, 200), (1, 5, 3, 7)])
def test_cuda_gains_int8_ground(cuda, name, shape):
    """B2q: the gains kernel over an int8 ground equals the f32 kernel on
    the dequantized ground bit for bit, and holds to the plain version
    by the float64 ratio rule."""
    tr = FEATURE_RULES[name]
    b, n, c, d = shape
    g, cd = _dev_pools(cuda, b, n, c, d, seed=11)
    q, scale = ops.quantize_ground(g)
    deq = TR.dequant(q, scale).contiguous()
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(deq, valid, tr)
    for j in range(min(3, n)):
        row = TR.update_row(deq, row, deq[:, j], tr)
    row = row.contiguous()
    cv = torch.arange(c, device=cuda).expand(b, c) % 5 != 1
    counters.reset()
    got = TP.gains(q, row, cd, cv, tr, gscale=scale)
    assert counters.snapshot()["gains[int8]"]["launches"] == 1
    parity.compare_exact(got, TP.gains(deq, row, cd, cv, tr),
                         "gains[int8] vs the f32 kernel")
    parity.compare_gains(got, TP.gains_plain(q, row, cd, cv, tr, scale),
                         deq, row, cd, tr)
