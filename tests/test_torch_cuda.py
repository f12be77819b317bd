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
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as model_registry
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
def test_cuda_bitmap_loop_takes_a_stacked_union(cuda):
    """A stacked level's union of candidate words (gather_groups: one
    union shared by its 8 lanes through a stride-0 view) goes through
    ops.greedy_loop's kernel and gives the bits of the plain version on
    the same words stored contiguously."""
    from repro_torch.core.greedyml import gather_groups
    union = gather_groups(_words((8, 30, 45), 7, cuda), (8,), 0)
    assert not union.is_contiguous()
    row = _words((8, 45), 17, cuda)
    mask = torch.ones(8, 240, device=cuda)
    counters.reset()
    got = ops.greedy_loop(union.mT, row, mask, 12, TR.BITS_OR)
    assert counters.snapshot()["greedy_loop[coverage]"]["launches"] == 1
    want = TL.greedy_loop_plain(union.contiguous().mT, row, mask, 12,
                                TR.BITS_OR)
    assert parity.compare_exact(got, want)["accepted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_RULES))
def test_cuda_resident_kernel_matches_plain(cuda, name, monkeypatch):
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
        # the device-memory tier, forced through the plan
        monkeypatch.setattr(plans, "RESIDENT_BITS_SMEM_BYTES", 64)
        parity.compare_exact(TL.greedy_loop_resident(
            None, cd, row, mask, ctl, 10, tr), want)
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


def _bits_node_case(cuda, b, c, w, k, kqs, seed, zero=False):
    """b nodes of c candidate words × w, a random covered row, a random
    mask with 70% of it set, kq cycling through `kqs` by node; `zero`:
    all-zero words and node 0 wholly masked."""
    cd = _words((b, c, w), seed, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mask = (torch.rand(b, c, generator=gen, device=cuda) < 0.7).float()
    if zero:
        cd.zero_()
        mask[0] = 0.0
    ctl = torch.tensor([[kqs[i % len(kqs)], w, c] for i in range(b)],
                       dtype=torch.int32, device=cuda)
    return cd, _words((b, w), seed + 1, cuda), mask, ctl, k


# (b nodes, c candidates, w words, k, kq by node, ...): C and W off the
# cluster's multiples, freezes at k, k/2 and 0; fewer candidates than a
# warp's groups of 4 (16 threads a candidate); 8 threads a candidate,
# one lane a warp pushing its groups of 4; several rounds of candidates
# a step on chip (256 threads) and on the device tier (512); all-zero
# words with one node wholly masked (nothing accepted); kdom's node (on
# 16 blocks); more nodes than the old cooperative kernel could hold at
# once (1,200 × 8 blocks of 8 candidates, against the card's ≈ 1,056)
RESIDENT_BITS_CASES = {
    "eight_threads": lambda cuda: _bits_node_case(cuda, 3, 24, 50, 8,
                                                  (8, 4, 0), 36),
    "rounds": lambda cuda: _bits_node_case(cuda, 2, 300, 40, 10,
                                           (10, 5), 37),
    "device_rounds": lambda cuda: _bits_node_case(cuda, 2, 601, 33, 10,
                                                  (10, 0), 38),
    "ragged": lambda cuda: _bits_node_case(cuda, 5, 100, 70, 10,
                                           (10, 5, 0), 31),
    "few_candidates": lambda cuda: _bits_node_case(cuda, 4, 13, 45, 9,
                                                   (9, 4), 35),
    "nothing_accepted": lambda cuda: _bits_node_case(cuda, 3, 40, 19, 6,
                                                     (6,), 32, zero=True),
    "kdom_node": lambda cuda: _bits_node_case(cuda, 3, 256, 2_048, 12,
                                              (12, 6), 33),
    "many_nodes": lambda cuda: _bits_node_case(cuda, 1_200, 64, 33, 6,
                                               (6, 3, 0), 34),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RESIDENT_BITS_CASES))
def test_cuda_resident_bits_matches_plain_on_both_tiers(cuda, case,
                                                        monkeypatch):
    """The bitmap resident loop's cluster kernel equals its plain version
    bit for bit on the tier the plan picks and on the device-memory tier
    forced through the plan."""
    cd, row, mask, ctl, k = RESIDENT_BITS_CASES[case](cuda)
    b, c, w = cd.shape
    rule = TR.BITS_OR
    want = TL.greedy_loop_resident_plain(None, cd, row, mask, ctl, k, rule)
    counters.reset()
    got = TL.greedy_loop_resident_bits(cd, row, mask, ctl, k, rule)
    assert counters.snapshot()["greedy_loop_resident[coverage]"][
        "launches"] == 1
    res = parity.compare_exact(got, want)
    assert (res["accepted"] == 0) == (case == "nothing_accepted")
    assert TL.resident_bits_plan(w, c) == (
        ("chip", 16) if case == "kdom_node" else ("chip", 8))
    monkeypatch.setattr(plans, "RESIDENT_BITS_SMEM_BYTES", 64)
    assert TL.resident_bits_plan(w, c) == ("device", 8)
    parity.compare_exact(TL.greedy_loop_resident_bits(
        cd, row, mask, ctl, k, rule), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan", [
    ((128, 1_290), ("chip", 8)),      # kcover's and the dispatcher's nodes
    ((256, 2_048), ("chip", 16)),     # kdom's
    ((1_000, 2_048), ("device", 8)),  # past 16 blocks' shared memory
])
def test_cuda_resident_bits_plan(cuda, shape, plan):
    """The tier and cluster the bitmap resident loop's plan promises at
    the coverage trees' node shapes (test_torch_plans.py::
    test_resident_bits_plan: all admitted by the resident gate)."""
    c, w = shape
    assert TL.resident_bits_plan(w, c) == plan


@pytest.mark.cuda
def test_cuda_resident_bits_plan_follows_the_byte_gate(cuda, monkeypatch):
    """kcover's node on 8 blocks needs 94,896 bytes a block: 162 words of
    each of 128 candidates in rows of 168 (41 16-byte vectors, padded to
    8 modulo 32 at 2 threads a candidate), the (2, 8, 128) partials and
    their two barriers, the covered slice in 41 vectors and 4 mask
    words. One byte less in the gate sends it to 16 blocks, and a gate
    below any slice to the device-memory tier."""
    need = 4 * (128 * 168 + 2 * 8 * 128 + 4 + 164 + 4)
    assert need == 94_896
    monkeypatch.setattr(plans, "RESIDENT_BITS_SMEM_BYTES", need)
    assert TL.resident_bits_plan(1_290, 128) == ("chip", 8)
    monkeypatch.setattr(plans, "RESIDENT_BITS_SMEM_BYTES", need - 1)
    assert TL.resident_bits_plan(1_290, 128) == ("chip", 16)
    monkeypatch.setattr(plans, "RESIDENT_BITS_SMEM_BYTES", 64)
    assert TL.resident_bits_plan(1_290, 128) == ("device", 8)


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


# (B, N, C, block_n): ragged N, C off every load grid (131, 37, 261) and
# on it (90 off the 16-byte one, 200), B = 1, 3 and 8 (more blocks a
# greedy than a thread-block cluster holds, each greedy's own barrier)
# and B = 40, 64 (a few blocks a greedy)
LOOP_SHAPES = [(1, 600, 301, 32), (3, 257, 90, 16), (8, 100, 200, 32),
               (40, 70, 37, 32), (64, 300, 260, 32)]


def _loop_inputs(cuda, tr, b, n, c, dtype, seed):
    g, cd = _dev_pools(cuda, b, n, c, 24, seed=seed)
    mat = TP.pairwise_plain(g, cd, tr.pairwise).contiguous()
    mat, scale = (mat, None) if dtype == "float32" else _stored(mat, dtype)
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    rng = np.random.default_rng(seed)
    mask = torch.as_tensor(rng.random((b, c)) > 0.1, device=cuda).float()
    return mat, scale, row, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32"] + STORED)
@pytest.mark.parametrize("name", ["kmedoid", "facility"])
@pytest.mark.parametrize("shape", LOOP_SHAPES)
def test_cuda_greedy_loop_equals_fused_steps(cuda, shape, name, dtype):
    """The streaming loop gives the bits of k fused_step launches over the
    same cache with the same block_n, the winner passed on as prev and
    taken out of the mask: every storage, rows on and off the grid of
    the loop's loads, one greedy over more blocks than a cluster holds."""
    b, n, c, ch = shape
    tr = FEATURE_RULES[name]
    mat, scale, row, mask = _loop_inputs(cuda, tr, b, n, c, dtype, 31)
    if b == 1:
        assert TL.loop_plan(mat, ch)["blocks"] > 16
    k = 9
    counters.reset()
    got = TL.greedy_loop(mat, row, mask, k, tr, block_n=ch, scale=scale)
    tag = {"float32": "", "bfloat16": "[bf16]", "int8": "[int8]"}[dtype]
    assert counters.snapshot()["greedy_loop" + tag]["launches"] == 1
    res = parity.compare_exact(got, TL.fused_steps(
        mat, row, mask, k, tr, block_n=ch, scale=scale),
        f"greedy_loop{tag} vs {k} fused_step launches")
    assert res["accepted"] > 0


def _resident_inputs(cuda, tr, nodes, n, d, seed):
    _, cd = _dev_pools(cuda, nodes, 1, n, d, seed=seed)
    g = cd.clone()
    valid = torch.ones(nodes, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    rng = np.random.default_rng(seed)
    mask = torch.as_tensor(rng.random((nodes, n)) > 0.1, device=cuda).float()
    return g, cd, row, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32"] + STORED)
@pytest.mark.parametrize("name", ["kmedoid", "facility"])
@pytest.mark.parametrize("nodes,n", [(1, 100), (3, 130), (8, 100),
                                     (16, 60), (1, 1600)])
def test_cuda_resident_equals_loop_over_its_matrix(cuda, nodes, n, name,
                                                   dtype):
    """The resident loop gives the bits of the streaming loop over the
    matrix it ran over (its f32 values, `scratch`), node by node: steps
    past kq frozen (bests -1, gains 0), int8/bf16 logical extents short
    of the shape; 1,600 rows a node pass a cluster's shared memory (the
    device tier)."""
    tr = FEATURE_RULES[name]
    g, cd, row, mask = _resident_inputs(cuda, tr, nodes, n, 16, 41 + nodes)
    k = 12
    kq = [k if i % 3 else 5 for i in range(nodes)]
    ctl = torch.tensor([[kq[i], n - (i % 2) * 7, n - (i % 3) * 5]
                        for i in range(nodes)], dtype=torch.int32,
                       device=cuda)
    assert TL.resident_tier(n, n, dtype) == ("device" if n > 1000
                                             else "chip")
    built = torch.empty(nodes, n, n, device=cuda)
    rows, bests, gains = TL.greedy_loop_resident(
        g, cd, row, mask, ctl, k, tr, cache_dtype=dtype, scratch=built)
    parity.compare_exact(built, TL.round_resident(
        TP.pairwise(g, cd, tr.pairwise), dtype, ctl))
    for i in range(nodes):
        want = TL.greedy_loop(built[i:i + 1].contiguous(), row[i:i + 1],
                              mask[i:i + 1], kq[i], tr)
        parity.compare_exact(
            (rows[i:i + 1], bests[i:i + 1, :kq[i]], gains[i:i + 1, :kq[i]]),
            want, f"resident node {i} vs greedy_loop over its matrix")
        assert bool((bests[i, kq[i]:] == -1).all())
        assert bool((gains[i, kq[i]:] == 0).all())


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


# ---------------------------------------------------------------------------
# distributed GreedyML on the card: gloo ranks sharing it, NCCL at world 1
# ---------------------------------------------------------------------------


def _dist_cuda_rank(rank, x, k, radices):
    """A rank of the card's gloo group: its block of x through
    greedyml_distributed and randgreedi_distributed, on cuda:0."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import (greedyml_distributed,
                                           randgreedi_distributed)
    from repro_torch.launch.mesh import local_block, make_tree_mesh
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = make_tree_mesh(radices, device=dev)
    assert mesh.stage_on_host
    obj = make_objective("kcover", universe=x.shape[1] * 32, device=dev)
    n = x.shape[0]
    ids = local_block(torch.arange(n, device=dev), mesh)
    pay = local_block(x, mesh)
    val = torch.ones(pay.shape[0], dtype=torch.bool, device=dev)
    counters.reset()
    out = {}
    for algo, fn in (("greedyml", greedyml_distributed),
                     ("randgreedi", randgreedi_distributed)):
        sol = fn(obj, ids, pay, val, k, mesh)
        out[algo] = (sol.ids.cpu(), sol.valid.cpu(), float(sol.value))
    out["launches"] = {n_: c["launches"] for n_, c in
                       counters.snapshot().items() if c["launches"]}
    return out


def _stacked_kcover_root(x, k, radices):
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import (LevelDispatcher, root_solution,
                                           shard_lanes)
    obj = make_objective("kcover", universe=x.shape[1] * 32,
                         device=x.device)
    disp = LevelDispatcher(obj, k, radices)
    n = x.shape[0]
    sols = disp.leaves(*shard_lanes(
        torch.arange(n, device=x.device), x,
        torch.ones(n, dtype=torch.bool, device=x.device), disp.lanes))
    for lvl in range(disp.num_levels):
        sols = disp.level(sols, lvl)
    return root_solution(sols)


@pytest.mark.cuda
def test_cuda_gloo_ranks_on_the_card_equal_stacked_lanes(cuda, tmp_path):
    """2 spawned gloo ranks on the one card (collectives staged through
    the host): greedyml_distributed and randgreedi_distributed equal the
    stacked LevelDispatcher(mesh=None) bit for bit, and each rank
    launched the bitmap loops on the card."""
    from repro_torch.kernels import build
    from repro_torch.launch.spawn import run_ranks
    for name in build.SOURCES:                  # built before the spawn
        build.load(name)
    x = _words((512, 24), seed=3, device=cuda)
    results = run_ranks(_dist_cuda_rank, 2, args=(x, 8, (2,)),
                        timeout=300, workdir=str(tmp_path))
    want = _stacked_kcover_root(x, 8, (2,))
    for res in results:
        for algo in ("greedyml", "randgreedi"):
            ids, valid, value = res[algo]
            assert torch.equal(ids, want.ids.cpu()), (algo, ids, want.ids)
            assert torch.equal(valid, want.valid.cpu())
            assert value == float(want.value)
        assert sum(res["launches"].values()) >= 4, res["launches"]


@pytest.mark.cuda
def test_cuda_nccl_world_of_one_equals_stacked_lanes(cuda):
    """NCCL at world size 1 in this process (a HashStore): the tree's
    collectives run on the card, and the root equals
    LevelDispatcher(mesh=None, radices=(1,)) bit for bit."""
    import torch.distributed as dist
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import greedyml_distributed
    from repro_torch.launch.mesh import make_tree_mesh
    if not dist.is_nccl_available():
        pytest.skip("this torch build has no NCCL")
    x = _words((300, 20), seed=5, device=cuda)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = make_tree_mesh((1,))
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        obj = make_objective("kcover", universe=640, device=cuda)
        n = x.shape[0]
        sol = greedyml_distributed(
            obj, torch.arange(n, device=cuda), x,
            torch.ones(n, dtype=torch.bool, device=cuda), 8, mesh)
    finally:
        dist.destroy_process_group()
    want = _stacked_kcover_root(x, 8, (1,))
    assert torch.equal(sol.ids, want.ids)
    assert torch.equal(sol.valid, want.valid)
    assert float(sol.value) == float(want.value)


# ---------------------------------------------------------------------------
# the sharded leaf tier and the lazy engine's DenseMedoid on the card
# ---------------------------------------------------------------------------


def _int_pool(n, d, seed):
    return np.random.default_rng(seed).integers(-3, 4, (n, d)).astype(
        np.float32)


def _sharded_leaves(x, name, k, radices, shard, dev, tile_c=0):
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import LevelDispatcher, shard_lanes
    obj = make_objective(name, device=dev)
    disp = LevelDispatcher(obj, k, radices, shard=shard, tile_c=tile_c)
    t = torch.as_tensor(x).to(dev)
    n = t.shape[0]
    sols = disp.leaves(*shard_lanes(
        torch.arange(n, device=dev), t,
        torch.ones(n, dtype=torch.bool, device=dev), disp.lanes))
    return obj, sols


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["auto", "int8"])
@pytest.mark.parametrize("name,data", [("facility", "int"),
                                       ("kmedoid", "int"),
                                       ("kmedoid", "images")])
def test_cuda_sharded_leaves_match_cpu(cuda, monkeypatch, name, data, rung):
    """LevelDispatcher((2,), shard=2) stacked on the card against the same
    stacked lanes on the CPU (plain gains): ids and valid equal but at a
    float64-proven tie, evals equal, values within 1e-5 (small-integer
    facility bit for bit); k · n_s / tile_c gains launches for all 4
    lanes (gains[int8] under the forced rung), + 1 gains_norms for
    'dist'."""
    if rung != "auto":
        monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, rung)
    x = (_int_pool(256, 48, 3) if data == "int"
         else gen_images(256, 48, classes=6, seed=3))
    k, tile = 6, 16
    counters.reset()
    obj, got = _sharded_leaves(x, name, k, (2,), 2, cuda, tile_c=tile)
    launched = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    gains = "gains[int8]" if rung == "int8" else "gains"
    assert launched == {gains: k * (256 // 4) // tile,
                        **({"gains_norms": 1} if name == "kmedoid"
                           else {})}, launched
    _, want = _sharded_leaves(x, name, k, (2,), 2, "cpu", tile_c=tile)
    got = got.map(lambda t: t.cpu())
    pools = torch.as_tensor(x).reshape(2, 128, -1)
    for lane in range(4):
        m = lane // 2
        w, g = want.map(lambda t: t[lane]), got.map(lambda t: t[lane])
        if name == "facility":
            for f in ("ids", "valid", "value", "evals"):
                assert torch.equal(getattr(g, f), getattr(w, f)), (lane, f)
            continue
        if torch.equal(g.ids, w.ids):
            assert torch.equal(g.valid, w.valid)
            assert int(g.evals) == int(w.evals)
            assert abs(float(g.value) - float(w.value)) <= 1e-5
        else:
            assert parity.selection_tie(
                pools[m], torch.ones(128, dtype=torch.bool),
                torch.arange(m * 128, (m + 1) * 128), w.ids, g.ids,
                obj.rule), (lane, w.ids, g.ids)


def _shard_cuda_rank(rank, x, k):
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels.shard_gains import shard_greedy_distributed
    from repro_torch.launch.mesh import make_tree_mesh
    torch.cuda.set_device(x.device)
    mesh = make_tree_mesh((), shard=2, device=x.device)
    obj = make_objective("kmedoid", device=x.device)
    n = x.shape[0]
    counters.reset()
    sol = shard_greedy_distributed(
        obj, torch.arange(n, device=x.device), x,
        torch.ones(n, dtype=torch.bool, device=x.device), k, mesh, tile_c=32)
    return {"sol": [t.cpu() for t in (sol.ids, sol.payloads, sol.valid,
                                      sol.value, sol.evals)],
            "launches": {n: c["launches"] for n, c in
                         counters.snapshot().items() if c["launches"]}}


@pytest.mark.cuda
def test_cuda_shard_ranks_on_the_card_equal_stacked_lanes(cuda, tmp_path):
    """2 spawned gloo ranks sharing the card as one machine's shard lanes:
    shard_greedy_distributed equals shard_greedy_sim on the card bit for
    bit, with the stacked launches on each rank."""
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import build
    from repro_torch.kernels.shard_gains import shard_greedy_sim
    from repro_torch.launch.spawn import run_ranks
    for name in build.SOURCES:                  # built before the spawn
        build.load(name)
    x = torch.as_tensor(gen_images(300, 40, classes=6, seed=9)).to(cuda)
    results = run_ranks(_shard_cuda_rank, 2, args=(x, 7), timeout=300,
                        workdir=str(tmp_path))
    counters.reset()
    want = shard_greedy_sim(make_objective("kmedoid", device=cuda),
                            torch.arange(300, device=cuda), x,
                            torch.ones(300, dtype=torch.bool, device=cuda),
                            7, lanes=2, tile_c=32)
    stacked = {n: c["launches"] for n, c in counters.snapshot().items()
               if c["launches"]}
    assert stacked == {"gains": 7 * 5, "gains_norms": 1}, stacked
    for res in results:
        for got, w in zip(res["sol"], (want.ids, want.payloads, want.valid,
                                       want.value, want.evals)):
            assert torch.equal(got, w.cpu())
        assert res["launches"] == stacked


@pytest.mark.cuda
def test_cuda_dense_medoid_matches_cpu(cuda):
    """The lazy engine's DenseMedoid on the card against the CPU on
    small-integer data: the same selections, per-node evals and comm;
    values within 1e-5."""
    from repro_torch.core.simulate import (DenseMedoid, run_greedy_lazy,
                                           run_tree_lazy)
    from repro_torch.core.tree import AccumulationTree
    x = _int_pool(512, 96, 4)
    st = DenseMedoid(x, np.arange(0, 512, 3), device=cuda)
    assert st.ground.is_cuda and st.mind.is_cuda
    tree = AccumulationTree(8, 2)
    for kw in ({}, {"augment": 24}):
        card = run_tree_lazy("kmedoid", x, 10, tree, seed=2, device=cuda,
                             **kw)
        cpu = run_tree_lazy("kmedoid", x, 10, tree, seed=2, device="cpu",
                            **kw)
        assert list(card.ids) == list(cpu.ids)
        assert card.per_node_evals == cpu.per_node_evals
        assert card.comm_elements == cpu.comm_elements
        assert abs(card.value - cpu.value) <= 1e-5 * max(1.0, cpu.value)
    card = run_greedy_lazy("kmedoid", x, 12, device=cuda)
    cpu = run_greedy_lazy("kmedoid", x, 12, device="cpu")
    assert list(card.ids) == list(cpu.ids)
    assert card.evals_total == cpu.evals_total


# ---------------------------------------------------------------------------
# fault tolerance and serving on the card
# ---------------------------------------------------------------------------


def _cover_data(n=256, universe=512, seed=2):
    from repro_torch.data.synthetic import gen_kcover, pack_bitmaps
    sets = gen_kcover(n, universe, seed=seed)
    return np.arange(n), pack_bitmaps(sets, universe), np.ones(n, bool)


@pytest.mark.cuda
def test_cuda_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import manager
    from repro_torch.core.greedyml import empty_lane_solutions
    sol = empty_lane_solutions(4, 3, torch.zeros(1, 5, device=cuda))
    sol.ids.copy_(torch.arange(12, device=cuda).reshape(4, 3))
    sol.payloads.normal_()
    manager.save(str(tmp_path), 1, sol)
    want = sol.map(lambda x: x.clone())
    sol.ids.fill_(-9)                # the checkpoint holds a copy
    back, _ = manager.restore(str(tmp_path), empty_lane_solutions(
        4, 3, torch.zeros(1, 5, device=cuda)))
    for f in ("ids", "payloads", "valid", "value", "evals"):
        got = getattr(back, f)
        assert got.device.type == "cuda", f
        assert torch.equal(got, getattr(want, f)), f


@pytest.mark.cuda
def test_cuda_supervised_tree_equals_the_dispatcher(cuda, tmp_path):
    """A supervised stacked kcover tree on the card, clean and with a
    transient failure at level 2, equals the unsupervised dispatcher's
    root bit for bit; its leaves and levels launch the loop kernels."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import (LevelDispatcher, root_solution,
                                           shard_lanes)
    from repro_torch.runtime.supervisor import (LaneFailureInjector,
                                                SelectionSupervisor)
    ids, pay, valid = _cover_data()
    obj = make_objective("kcover", universe=512, device=cuda)
    disp = LevelDispatcher(obj, 8, (2, 2, 2))
    state = disp.leaves(*shard_lanes(
        torch.as_tensor(ids), TR.to_words(pay), torch.as_tensor(valid), 8))
    for lvl in range(3):
        state = disp.level(state, lvl)
    want = root_solution(state)
    for sub, inj in (("clean", None),
                     ("replay", LaneFailureInjector(fail_at=((2, 5),)))):
        counters.reset()
        sup = SelectionSupervisor(ckpt_dir=str(tmp_path / sub),
                                  injector=inj)
        sol, info = sup.select(obj, ids, pay, valid, 8, lanes=8,
                               branching=2)
        for f in ("ids", "payloads", "valid", "value", "evals"):
            assert torch.equal(getattr(sol, f), getattr(want, f)), (sub, f)
        snap = counters.snapshot()
        assert snap["greedy_loop_resident[coverage]"]["launches"] >= 3
        assert all(e["wall_s"] > 0 for e in info["events"]
                   if e["kind"] == "dispatch")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["facility", "kmedoid", "kcover"])
def test_cuda_serving_batch_is_one_resident_dispatch(cuda, name):
    """An admitted batch of heterogeneous pools and k is ONE resident
    dispatch on the card (the launch counters' delta), and every query
    equals its solo greedy(engine="mega") run bit for bit."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedy import greedy
    from repro_torch.data.synthetic import gen_kcover, pack_bitmaps
    from repro_torch.serving import Query, QueryEngine
    queries = []
    for s, (n, k) in enumerate([(90, 5), (128, 12), (110, 8), (70, 3)]):
        if name == "kcover":
            pay = pack_bitmaps(gen_kcover(n, 600, seed=s), 600)
            queries.append(Query(name, k, np.arange(n), pay,
                                 np.ones(n, bool), universe=600))
        else:
            pay = gen_images(n, 48, classes=5, seed=s)
            queries.append(Query(name, k, np.arange(n), pay,
                                 np.arange(n) % 9 != 0))
    eng = QueryEngine(device=cuda)
    qids = [eng.submit(q) for q in queries]
    counters.reset()
    res = eng.drain()
    counter = ("greedy_loop_resident[coverage]" if name == "kcover"
               else "greedy_loop_resident")
    assert counters.counter(counter).launches == 1
    assert [b["dispatches"] for b in eng.metrics.batches] == [1]
    for q in qids:
        r, qq = res[q], queries[q]
        assert r.batched and r.batch_size == 4
        obj = make_objective(name, universe=qq.universe, device=cuda)
        want = greedy(obj, qq.ids, qq.payloads, qq.valid, qq.k,
                      engine="mega")
        for f in ("ids", "payloads", "valid", "value", "evals"):
            assert torch.equal(getattr(r.solution, f), getattr(want, f)), f


@pytest.mark.cuda
def test_cuda_autotune_smoke_grid_writes_a_card_entry(cuda, tmp_path,
                                                      monkeypatch):
    """autotune.tune at the --smoke grid (facility, n = 192, d = 32,
    k = 6, f32 and int8, one rep) on the card: the entry is keyed to
    'cuda' and carries the port's budget snapshot, its dispatches are
    CUDA launches (launch counters), and a greedy under the written
    cache selects the static plan's ids."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedy import greedy
    from repro_torch.launch import autotune
    out = tmp_path / "plans.json"
    counters.reset()
    entries = autotune.tune(["facility"], [(192, 32, 6)], device=cuda,
                            reps=1, dtypes=("float32", "int8"),
                            blocks_per_tier=1, out=str(out), verbose=False)
    (key, e), = entries.items()
    assert key == plans.autotune_key(TR.DOT_MAX, 192, 192, 32, "cuda")
    assert e["budgets"] == plans.budget_snapshot()
    assert set(e["budgets"]) == {"fused_cache_mb", "fused_vmem_mb",
                                 "resident_l2_mb"}
    assert e["dispatches"] >= 1 and e["static_dispatches"] >= 1
    launched = sum(c["launches"] for c in counters.snapshot().values())
    assert launched > 0
    ids, pay, valid = autotune._pool("facility", 192, 32, device=cuda)
    obj = make_objective("facility", device=cuda)
    static = plans.fused_plan(192, 192, d=32, rule=TR.DOT_MAX)
    with plans.plan_override(static):
        want = greedy(obj, ids, pay, valid, 6)
        n_static = autotune._dispatches(obj, ids, pay, valid, 6, static)
    assert n_static == e["static_dispatches"]
    monkeypatch.setenv(flags.AUTOTUNE_CACHE_ENV, str(out))
    p = plans.select_engine(TR.DOT_MAX, 192, 192, 32, device="cuda")
    assert ((p.tier or "step"), p.dtype) == (e["tier"], e["dtype"])
    got = greedy(obj, ids, pay, valid, 6)
    assert torch.equal(got.ids, want.ids)


# ---------------------------------------------------------------------------
# stacked lanes against one-lane slices (a stacked lane computes what a
# rank computes of its one lane, bit for bit), and the model
# zoo's serving path on the card (chip_smoke's model phases, smoke size)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["facility", "kmedoid", "satcover"])
def test_cuda_stacked_lane_values_equal_one_lane_slices(cuda, name):
    """A lane's value, its replayed value and its node greedy's value
    are the same bits stacked 4 lanes deep as alone in a (1, …) batch —
    what a rank computes of its one lane — at an N off every vector
    width."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedy import greedy_batch, replay_value
    obj = make_objective(name, device=cuda)
    lanes, n, d, k = 4, 4_099, 24, 8
    g = torch.Generator(device=cuda).manual_seed(5)
    ground = torch.randn((lanes, n, d), generator=g, device=cuda)
    gvalid = torch.rand((lanes, n), generator=g, device=cuda) < 0.9
    pay = ground[:, :k * 8:8]
    valid = torch.ones((lanes, k), dtype=torch.bool, device=cuda)
    stacked = replay_value(obj, pay, valid, ground, gvalid)
    for i in range(lanes):
        one = replay_value(obj, pay[i:i + 1].clone(), valid[i:i + 1].clone(),
                           ground[i:i + 1].clone(), gvalid[i:i + 1].clone())
        assert torch.equal(stacked[i:i + 1], one), (name, i)
    ids = torch.arange(n, device=cuda).expand(lanes, n).contiguous()
    same = ground[:1].expand(lanes, n, d).contiguous()
    sv = gvalid[:1].expand(lanes, n).contiguous()
    four = greedy_batch(obj, ids, same, sv, k)
    one = greedy_batch(obj, ids[:1].clone(), same[:1].clone(),
                       sv[:1].clone(), k)
    for i in range(lanes):
        assert torch.equal(four.ids[i], one.ids[0])
        assert torch.equal(four.value[i], one.value[0]), (name, i)


def _model_parts(arch, seed=0, b=2, s=32):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    cfg = model_registry.smoke_config(arch)
    params, _ = T.init_params(torch.Generator().manual_seed(seed), cfg)
    batch = api.synth_batch(torch.Generator().manual_seed(seed + 1), cfg,
                            ShapeConfig("p", "prefill", s, b))
    return cfg, params, batch


def _greedy_logits(params, batch, cfg, n_decode, max_len):
    from repro_torch.models import transformer as T
    with torch.inference_mode():
        fwd, _ = T.forward(params, batch, cfg)
        pre, cache = T.prefill(params, batch, cfg, max_len=max_len)
        tok, steps = pre.argmax(-1)[:, None], []
        for _ in range(n_decode):
            lg, cache = T.decode_step(params, cache, tok, cfg)
            steps.append(lg)
            tok = lg.argmax(-1)[:, None]
    return fwd, pre, torch.stack(steps, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(model_registry.ARCHS))
def test_cuda_model_matches_cpu_and_its_own_forward(cuda, arch):
    """chip_smoke's model_parity at one arch: forward, prefill and 8
    greedy decode steps on the card against the CPU (1e-4 max abs, the
    same greedy tokens); prefill(S) + decode(token S) against
    the forward over S + 1 tokens within 1e-3."""
    from repro_torch.models import transformer as T
    assert torch.get_float32_matmul_precision() == "highest"
    cfg, params, batch = _model_parts(arch)
    s = batch["tokens"].shape[1]
    cpu = _greedy_logits(params, batch, cfg, 8, s + 9)
    gp = params.to(cuda)
    gb = {k: v.to(cuda) for k, v in batch.items()}
    gpu = _greedy_logits(gp, gb, cfg, 8, s + 9)
    for g, c in zip(gpu, cpu):
        assert float((g.cpu() - c).abs().max()) <= 1e-4
    assert torch.equal(gpu[2].argmax(-1).cpu(), cpu[2].argmax(-1))
    extra = torch.randint(0, cfg.vocab_size, (2, 1), device=cuda,
                          generator=torch.Generator(device=cuda)
                          .manual_seed(7))
    full = dict(gb, tokens=torch.cat([gb["tokens"], extra], 1))
    with torch.inference_mode():
        lf, _ = T.forward(gp, full, cfg)
        lp, cache = T.prefill(gp, gb, cfg, max_len=s + 4)
        ld, _ = T.decode_step(gp, cache, extra, cfg)
    assert float((lp - lf[:, s - 1]).abs().max()) < 1e-3
    assert float((ld - lf[:, s]).abs().max()) < 1e-3


@pytest.mark.cuda
def test_cuda_swa_ring_decodes_past_the_window(cuda):
    from repro_torch.models import transformer as T
    cfg, params, _ = _model_parts("h2o-danube-3-4b")
    assert cfg.sliding_window == 16
    params = params.to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 30), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    with torch.inference_mode():
        full, _ = T.forward(params, {"tokens": toks}, cfg)
        _, cache = T.prefill(params, {"tokens": toks[:, :24]}, cfg,
                             max_len=30)
        for t in range(24, 30):
            lg, cache = T.decode_step(params, cache, toks[:, t:t + 1], cfg)
            assert float((lg - full[:, t]).abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-1.3b",
                                  "qwen3-moe-30b-a3b"])
def test_cuda_serve_main_passes_the_teacher_forced_check(cuda, arch):
    """chip_smoke's serve_* phases at the smoke size: serve.main on the
    card, then a forward over prompt + generation picks every decoded
    token but where its top-2 logits lie within 0.05."""
    from repro_torch.launch import serve
    run = serve.main(["--arch", arch, "--smoke", "--prompt-len", "64",
                      "--gen", "8", "--batch", "4", "--warmup", "1"])
    assert run["device"] == "cuda" and run["tokens"].is_cuda
    assert run["prefill_ms"] > 0 and run["decode_ms"] > 0
    check = serve.teacher_forced(run)
    assert check["positions"] == 32
    assert check["mismatches"] == check["within_margin"], check
    assert bool(torch.isfinite(run["logits"]).all())


@pytest.mark.cuda
def test_cuda_serve_cli_smoke(cuda):
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--smoke", "--prompt-len", "32", "--gen", "8",
         "--batch", "2"], cwd=root, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr
    assert "prefill 2×32" in out.stdout and "tok/s" in out.stdout


def _train_cpu64(start, cfg, ocfg, shape, batch):
    """One step of the port on the CPU in float64 (every model, optimizer
    and step module's F32 patched) from the numpy state `start`: the
    yardstick for float32 rounding."""
    from repro_torch import convert
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models import layers, mamba, moe, transformer
    from repro_torch.optim import adafactor, adamw, compress, schedule
    mods = (layers, mamba, moe, transformer, steps, adamw, adafactor,
            compress, schedule)
    saved = [m.F32 for m in mods]
    for m in mods:
        m.F32 = torch.float64
    try:
        cfg64 = cfg.replace(dtype="float64")
        state = convert.train_state_to_torch(start, cfg64, ocfg, "cpu")
        fn = steps.make_train_step(cfg64, ocfg, TrainConfig(), shape, None)
        state, _ = fn(state, {k: v.double() if v.is_floating_point() else v
                              for k, v in batch.items()})
        return convert.train_state_to_numpy(state, cfg64, ocfg)
    finally:
        for m, f in zip(mods, saved):
            m.F32 = f


@pytest.mark.cuda
@pytest.mark.parametrize("arch,name", [("smollm-135m", "adamw"),
                                       ("smollm-135m", "adafactor"),
                                       ("qwen3-moe-30b-a3b", "adamw")])
def test_cuda_train_step_matches_cpu(cuda, arch, name):
    """chip_smoke's train_parity at one arch: one state on the CPU and
    its copy on the card, 2 train steps (lr 3e-3 past a 2-step warm-up)
    on the same batches, each started on both from the CPU's state.
    Every optimizer-state leaf within 1e-4 of its
    own largest entry on the CPU (`optim/parity.moments_error`), the
    losses within 1e-4. AdamW's parameters within one f32 spacing plus
    1e-4 of the change their own moments imply
    (`optim/parity.update_error`); Adafactor's, whose update needs the
    gradient the state does not keep, within 1e-4 of the CPU's largest
    change, else with an RMS error against the CPU's
    float64 steps at most 2.5× the CPU float32 steps' own."""
    from repro_torch import convert
    from repro_torch.configs.base import (OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import parity
    cfg = model_registry.smoke_config(arch)
    ocfg = OptimConfig(name=name, lr=3e-3, warmup_steps=2, total_steps=10)
    shape = ShapeConfig("t", "train", 32, 2)
    cpu, _ = steps.concrete_state(torch.Generator().manual_seed(0), cfg,
                                  ocfg, device="cpu")
    fn = steps.make_train_step(cfg, ocfg, TrainConfig(), shape, None)
    for s in range(2):
        batch = api.synth_batch(torch.Generator().manual_seed(1 + s), cfg,
                                shape)
        start = convert.train_state_to_numpy(cpu, cfg, ocfg)
        card = convert.train_state_to_torch(start, cfg, ocfg, cuda)
        before = parity.flatten(start)
        cpu, mc = fn(cpu, batch)
        card, mg = fn(card, {k: v.to(cuda) for k, v in batch.items()})
        got = parity.flatten(convert.train_state_to_numpy(card, cfg, ocfg))
        want = parity.flatten(convert.train_state_to_numpy(cpu, cfg, ocfg))
        err, leaf = parity.moments_error(got, want)
        assert err <= 1e-4, (s, leaf, err)
        if name == "adamw":
            err, leaf = parity.update_error(before, got, ocfg,
                                            float(mc["lr"]))
            assert err <= 1e-4, (s, leaf, err)
        else:
            ref64 = parity.flatten(_train_cpu64(start, cfg, ocfg, shape,
                                                batch))
            for k, w in want.items():
                if not k.startswith("params/") or not w.size:
                    continue
                scale = float(np.abs(w - before[k]).max())
                if float(np.abs(got[k] - w).max()) <= 1e-4 * scale:
                    continue
                rms_card = float(np.sqrt(np.mean((got[k] - ref64[k]) ** 2)))
                rms_cpu = float(np.sqrt(np.mean((w - ref64[k]) ** 2)))
                assert rms_card <= 2.5 * rms_cpu, (s, k, rms_card, rms_cpu)
        assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * max(
            1.0, abs(float(mc["loss"])))


@pytest.mark.cuda
def test_cuda_train_cli_resumes_bit_for_bit(cuda, tmp_path):
    """The train CLI at the smoke size on the card: a run that fails at
    step 15 and resumes from step 10 ends with the same step-30
    checkpoint, bit for bit, as one that never failed."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "smollm-135m", "--smoke", "--steps", "30", "--ckpt-every", "10",
            "--data-selection", "greedyml:facility", "--selection-k", "64",
            "--corpus-docs", "128"]
    arrays = {}
    for name, extra in (("failed", ["--fail-at", "15"]), ("clean", [])):
        out = subprocess.run(argv + extra + ["--ckpt-dir",
                                             str(tmp_path / name)],
                             cwd=root, capture_output=True, text=True,
                             timeout=600, env=env)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "done at step 30" in out.stdout
        with np.load(tmp_path / name / "step_00000030" / "arrays.npz") as z:
            arrays[name] = {k: z[k] for k in z.files}
    assert sorted(arrays["failed"]) == sorted(arrays["clean"])
    for k, v in arrays["clean"].items():
        assert arrays["failed"][k].tobytes() == v.tobytes(), k
