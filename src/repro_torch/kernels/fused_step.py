"""One fused greedy step over cached matrices: CUDA kernel, wrapper and
plain version (answers `src/repro/kernels/fused_step.py:fused_step_pallas`).

(B, N, C) cached matrices, (B, N) state rows, (B, C) 0/1 masks and (B,)
previous winners → (new rows (B, N), best (B,) int64, raw gain (B,) f32):
fold the previous winner's column into the row (the deferred update),
sum the rule's gain parts over the rows, take the masked first-argmax.
One launch serves every greedy of a level. The kernel is
csrc/fused_step.cu (P row blocks per greedy, partials reduced in block
order by each greedy's last block to finish) for the feature rules'
caches in their storage — f32, bf16 or int8 with (B, 1, N) row scales
(`_kernel_quant`), counted as `fused_step`, `fused_step[bf16]`,
`fused_step[int8]`; each variant widens an entry to the f32 value
rules.dequant gives and runs the f32 arithmetic, so it equals the f32
kernel on the dequantized cache bit for bit — and
csrc/fused_step.cu:rt_fused_step_bits for the bitmap rule: its
(B, W, C) matrix is the transposed view of the candidates' (B, C, W)
int32 words, which the kernel reads in place (P blocks of `block_c`
candidates per greedy, counted as `fused_step[coverage]`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters, ref
from repro_torch.kernels import rules as R
from repro_torch.kernels.pairwise import (FOLDS, check_feature_rule,
                                          check_operand, check_storage,
                                          check_words, storage_counters)
from repro_torch.kernels.plans import BITS_BLOCK_C, FUSED_BLOCK_N
from repro_torch.kernels.rules import WORD_DTYPE, KernelRule

F32 = torch.float32

COUNTERS = storage_counters("fused_step")
BITS_COUNTER = counters.counter("fused_step[coverage]")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def fused_step_plain(mat, row, mask, prev, rule: KernelRule, scale=None):
    """The plain PyTorch version (kernels/ref.py:fused_step) over the
    cache's f32 values (`scale`: an int8 cache's row scales); the CPU
    path, and the kernel's yardstick of correctness on the card."""
    return ref.fused_step(R.logical(mat, scale), row, mask, prev, rule)


def _lib():
    lib = build.load("fused_step")
    lib.rt_fused_step.restype = _I
    lib.rt_fused_step.argtypes = [_P] * 10 + [_I] * 7 + [_F, _F, _F, _P]
    lib.rt_fused_step_bits.restype = _I
    lib.rt_fused_step_bits.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    return lib


def fused_step(mat, row, mask, prev, rule: KernelRule,
               block_n: int = FUSED_BLOCK_N, scale=None):
    """mat (B, N, C) f32, bf16 or int8 (with `scale`, its (B, 1, N) f32
    row scales), row (B, N), mask (B, C) 0/1 f32, prev (B,) int. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (contiguous; `block_n` ground rows per block) or raise. The bitmap
    rule goes to `fused_step_bits`."""
    if rule.is_bitmap:
        return fused_step_bits(mat, row, mask, prev, rule)
    counter = COUNTERS.get(mat.dtype, COUNTERS[F32])
    counter.calls += 1
    if not mat.is_cuda:
        return fused_step_plain(mat, row, mask, prev, rule, scale)
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
    r = max(1, int(block_n))
    p = max(1, -(-n // r))
    row_out = torch.empty((b, n), dtype=F32, device=dev)
    best = torch.empty((b,), dtype=torch.int32, device=dev)
    gain = torch.empty((b,), dtype=F32, device=dev)
    if b == 0:
        return row_out, best.long(), gain
    partials = torch.empty((b, p, c), dtype=F32, device=dev)
    arrivals = build.arrivals(dev, b)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_fused_step(
        mat.data_ptr(), None if scale is None else scale.data_ptr(),
        row.data_ptr(), mask.data_ptr(), prev.data_ptr(),
        row_out.data_ptr(), best.data_ptr(), gain.data_ptr(),
        partials.data_ptr(), arrivals.data_ptr(), b, n, c, p, r, storage,
        FOLDS[rule.fold], rule.cap, rule.lam, 1.0 - rule.lam, stream)
    build.check(lib, err, "fused_step kernel")
    counter.launches += 1
    return row_out, best.long(), gain


def fused_step_bits(mat, row, mask, prev, rule: KernelRule,
                    block_c: int = BITS_BLOCK_C):
    """The bitmap rule's step: mat (B, W, C) is the transposed view of
    contiguous (B, C, W) int32 candidate words (never copied), row (B, W)
    int32, mask (B, C) 0/1 f32, prev (B,) int. CPU tensors take the plain
    version; CUDA tensors launch the kernel (`block_c` candidates per
    block) or raise."""
    BITS_COUNTER.calls += 1
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
