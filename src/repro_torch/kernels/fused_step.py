"""One fused greedy step over cached matrices: CUDA kernel, wrapper and
plain version (answers `src/repro/kernels/fused_step.py:fused_step_pallas`).

(B, N, C) cached matrices, (B, N) state rows, (B, C) 0/1 masks and (B,)
previous winners → (new rows (B, N), best (B,) int64, raw gain (B,) f32):
fold the previous winner's column into the row (the deferred update),
sum the rule's gain parts over the rows, take the masked first-argmax.
One launch serves every greedy of a level. The kernel is
csrc/fused_step.cu for the feature rules' caches in their storage — f32,
bf16 or int8 with (B, 1, N) row scales (`_kernel_quant`), counted as
`fused_step`, `fused_step[bf16]`, `fused_step[int8]`: spans of 128
columns read in 16-byte loads, a span's chunks of `block_n` rows over a
thread-block cluster whose blocks add each column's chunk partials in
chunk order, the greedy's last block picking among the blocks' winners.
Each variant widens an entry to the f32 value rules.dequant gives and
runs the f32 arithmetic, so it equals the f32 kernel on the dequantized
cache bit for bit. Past 16 chunks a block of a cluster of 8 (4,096 rows
in chunks of 32; `plans.fused_tier`), where a span's partials would
crowd the shared memory or fit no cluster, the step runs the global
tier: the same span pass with its chunk partials in device memory, a
span's last block summing them in chunk order and the greedy's last
span picking among the spans' winners — the same sums, the same bits.
``reference=True`` runs the earlier design (row blocks, one last block a
greedy summing their partials: a test's yardstick, not counted);
`earlier_design_split` times its two phases on the card. For the bitmap rule
csrc/fused_step.cu:rt_fused_step_bits: its (B, W, C) matrix is the
transposed view of the candidates' (B, C, W) int32 words, which the
kernel reads in place (P blocks of `block_c` candidates per greedy,
counted as `fused_step[coverage]`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counters, plans, ref
from repro_torch.kernels import rules as R
from repro_torch.kernels.pairwise import (FOLDS, bits_cost,
                                          check_feature_rule, check_operand,
                                          check_storage, check_words,
                                          steps_cost, storage_counters)
from repro_torch.kernels.plans import (BITS_BLOCK_C, FUSED_BLOCK_N,
                                       FUSED_CLUSTER_MAX, FUSED_SPAN)
from repro_torch.kernels.rules import WORD_DTYPE, KernelRule

F32 = torch.float32

COUNTERS = storage_counters("fused_step")
BITS_COUNTER = counters.counter("fused_step[coverage]")

# the tiers of csrc/fused_step.cu:rt_fused_step (RT_TIER_*)
TIERS = {"cluster": 0, "global": 1, "earlier": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def fused_step_plain(mat, row, mask, prev, rule: KernelRule, scale=None):
    """The plain PyTorch version (kernels/ref.py:fused_step) over the
    cache's f32 values (`scale`: an int8 cache's row scales); the CPU
    path, and the kernel's yardstick of correctness on the card."""
    return ref.fused_step(R.logical(mat, scale), row, mask, prev, rule)


@functools.cache
def _lib():
    lib = build.load("fused_step")
    lib.rt_fused_step.restype = _I
    lib.rt_fused_step.argtypes = [_P] * 12 + [_I] * 8 + [_F, _F, _F, _P]
    lib.rt_fused_step_bits.restype = _I
    lib.rt_fused_step_bits.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    return lib


def _step_out(row, mask) -> float:
    """A step's bytes besides the operands: the row written, and a
    greedy's prev read, best and gain written."""
    return 4.0 * row.numel() + 20.0 * (mask.numel()
                                       // max(1, mask.shape[-1]))


@counters.wrapper
def fused_step(mat, row, mask, prev, rule: KernelRule,
               block_n: int = FUSED_BLOCK_N, scale=None,
               reference: bool = False):
    """mat (B, N, C) f32, bf16 or int8 (with `scale`, its (B, 1, N) f32
    row scales), row (B, N), mask (B, C) 0/1 f32, prev (B,) int. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (contiguous; gains summed over chunks of `block_n` rows) on the tier
    `plans.fused_tier` picks, or raise. ``reference`` runs the earlier
    design, which every tier equals bit for bit, whatever the shape (a
    test's yardstick, not counted). The bitmap rule goes to
    `fused_step_bits`."""
    if rule.is_bitmap:
        return fused_step_bits(mat, row, mask, prev, rule)
    counter = COUNTERS.get(mat.dtype, COUNTERS[F32])
    if not reference:
        # the row out, prev in, best and gain out
        counter.declare(*steps_cost(mat, scale, row, mask,
                                    _step_out(row, mask)))
    if not mat.is_cuda:
        return fused_step_plain(mat, row, mask, prev, rule, scale)
    dtype = str(mat.dtype).removeprefix("torch.")
    ch = max(1, int(block_n))
    tier = ("earlier" if reference
            else plans.fused_tier(dtype, mat.shape[-2], ch))
    out = _launch(mat, row, mask, prev, rule, ch, scale, tier)
    if not reference:
        counter.launches += 1
    return out


def earlier_design_split(mat, row, mask, prev, rule: KernelRule,
                         block_n: int = FUSED_BLOCK_N, scale=None) -> dict:
    """One step of the earlier design (not counted), its two phases on
    the card's clock (%globaltimer, ns): `row_pass_ms` from the first
    row block's start to the last block's start of the sum, `sum_ms`
    that last block's sum of the (P, C) partials alone. Greedy 0's."""
    stamps = torch.full((mat.shape[0], 3), -1, dtype=torch.int64,
                        device=mat.device)   # u64 ~0: the min's start
    _launch(mat, row, mask, prev, rule, max(1, int(block_n)), scale,
            "earlier", stamps=stamps)
    t0, t1, t2 = stamps[0].tolist()
    return {"row_pass_ms": (t1 - t0) / 1e6, "sum_ms": (t2 - t1) / 1e6}


def _launch(mat, row, mask, prev, rule, ch, scale, tier, stamps=None):
    """One rt_fused_step launch on `tier` (TIERS) over CUDA tensors."""
    check_feature_rule(rule, "fused_step")
    if mat.dim() != 3:
        raise ValueError("fused_step kernel takes (B, N, C) matrices")
    b, n, c = mat.shape
    dev = mat.device
    prev = torch.as_tensor(prev, device=dev).to(torch.int64).expand(b)
    prev = prev.contiguous()
    storage = check_storage(mat, scale, (b, n, c), "fused_step", dev)
    check_operand(row, (b, n), F32, "row", dev)
    check_operand(mask, (b, c), F32, "mask", dev)
    if c == 0:
        raise ValueError("fused_step kernel needs at least one candidate")
    if max(b, n, c) >= 2 ** 31:
        raise ValueError("fused_step extents must fit int32")
    row_out = torch.empty((b, n), dtype=F32, device=dev)
    best = torch.empty((b,), dtype=torch.int64, device=dev)
    gain = torch.empty((b,), dtype=F32, device=dev)
    if b == 0:
        return row_out, best, gain
    dtype = str(mat.dtype).removeprefix("torch.")
    partials = pairs = None
    chunks = 0
    spans = -(-c // FUSED_SPAN)
    if tier == "cluster":   # each block's (gain, column)
        pairs = build.scratch(dev, 2 * b * spans * FUSED_CLUSTER_MAX)
        arrivals = build.arrivals(dev, b)
    elif tier == "global":  # chunk partials, each span's (gain, column)
        shape, n_pairs, n_arrivals = plans.fused_global_scratch(b, n, c, ch)
        partials = torch.empty(shape, dtype=F32, device=dev)
        pairs = build.scratch(dev, n_pairs)
        arrivals = build.arrivals(dev, n_arrivals)
        chunks = plans.fused_global_chunks(dtype, ch)
    else:                   # the earlier design's (B, P, C) partials
        partials = torch.empty((b, max(1, -(-n // ch)), c), dtype=F32,
                               device=dev)
        arrivals = build.arrivals(dev, b)
    lib = _lib()
    err = lib.rt_fused_step(
        mat.data_ptr(), None if scale is None else scale.data_ptr(),
        row.data_ptr(), mask.data_ptr(), prev.data_ptr(), row_out.data_ptr(),
        best.data_ptr(), gain.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if pairs is None else pairs.data_ptr(), arrivals.data_ptr(),
        None if stamps is None else stamps.data_ptr(),
        b, n, c, ch, TIERS[tier], chunks, storage, FOLDS[rule.fold],
        rule.cap, rule.lam, 1.0 - rule.lam,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "fused_step kernel")
    return row_out, best, gain


@counters.wrapper
def fused_step_bits(mat, row, mask, prev, rule: KernelRule,
                    block_c: int = BITS_BLOCK_C):
    """The bitmap rule's step: mat (B, W, C) is the transposed view of
    contiguous (B, C, W) int32 candidate words (never copied), row (B, W)
    int32, mask (B, C) 0/1 f32, prev (B,) int. CPU tensors take the plain
    version; CUDA tensors launch the kernel (`block_c` candidates per
    block) or raise."""
    BITS_COUNTER.declare(*bits_cost(mat.transpose(-1, -2), row, mask,
                                    _step_out(row, mask)))
    if not mat.is_cuda:
        return fused_step_plain(mat, row, mask, prev, rule)
    if mat.dim() != 3:
        raise ValueError("fused_step kernel takes (B, W, C) matrices")
    cands = mat.transpose(-1, -2)
    b, c, w = cands.shape
    dev = mat.device
    prev = torch.as_tensor(prev, device=dev).to(torch.int64).expand(b)
    prev = prev.contiguous()
    check_operand(cands, (b, c, w), WORD_DTYPE, "candidate words", dev)
    check_operand(row, (b, w), WORD_DTYPE, "row", dev)
    check_operand(mask, (b, c), F32, "mask", dev)
    check_words(w, "fused_step")
    if c == 0:
        raise ValueError("fused_step kernel needs at least one candidate")
    cb = max(1, int(block_c))
    p = -(-c // cb)
    row_out = torch.empty((b, w), dtype=WORD_DTYPE, device=dev)
    best = torch.empty((b,), dtype=torch.int32, device=dev)
    gain = torch.empty((b,), dtype=F32, device=dev)
    if b == 0:
        return row_out, best.long(), gain
    pval = torch.empty((b, p), dtype=F32, device=dev)
    pidx = torch.empty((b, p), dtype=torch.int32, device=dev)
    arrivals = build.arrivals(dev, b)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_fused_step_bits(
        cands.data_ptr(), row.data_ptr(), mask.data_ptr(), prev.data_ptr(),
        row_out.data_ptr(), best.data_ptr(), gain.data_ptr(),
        pval.data_ptr(), pidx.data_ptr(), arrivals.data_ptr(), b, c, w, p,
        cb, stream)
    build.check(lib, err, "bitmap fused_step kernel")
    BITS_COUNTER.launches += 1
    return row_out, best.long(), gain
