"""Whole-greedy loop kernels: wrappers and plain versions (answers
`src/repro/kernels/greedy_loop.py`).

Two tiers, each ONE dispatch for every greedy of a level (the resident
tier's is two CUDA launches: the build, the steps):

  greedy_loop           streaming tier (csrc/greedy_loop.cu): all k steps
                        over cached (B, N, C) matrices in device memory;
                        a greedy's blocks split its rows into chunks of
                        `block_n` and its columns into 128-wide spans,
                        and wait only for each other (a cooperative
                        launch, a barrier per greedy). It gives the bits
                        of k fused_step launches with the same
                        `block_n`.
  greedy_loop_resident  resident tier (csrc/greedy_loop_resident.cu):
                        builds each (N, C) matrix over the whole card,
                        then runs all k steps on a cluster of 8 blocks a
                        node holding the matrix in its storage dtype;
                        ``ctl`` (B, 3) int32 = [kq, logical_n,
                        logical_c], steps ≥ kq freeze. It gives the bits
                        of `greedy_loop` over the matrix it ran over.

Outputs follow kernels/ref.py:greedy_loop: final rows (B, N), bests
(B, k) int64 with −1 for rejected steps, raw gains (B, k) f32. The
streaming kernel reads a feature rule's cache in its storage — f32,
bf16 or int8 with (B, 1, N) row scales (`_stream_kernel_quant`),
counted as `greedy_loop`, `greedy_loop[bf16]`, `greedy_loop[int8]` —
widening each entry to rules.dequant's f32 value, so a variant equals
the f32 kernel on the dequantized cache bit for bit. The resident
kernel rounds its f32 build to the plan's storage (bf16, or int8 by
rules.quantize_rows; `greedy_loop_resident[bf16]`/`[int8]`), as
`resident_matrix` does, and keeps it in that dtype. The bitmap tiers
read the candidates' (B, C, W) int32 words in place (the reference's
matrix is their transpose, so the resident tier has nothing to build):
`greedy_loop_bits` (`greedy_loop[coverage]`) launches
csrc/greedy_loop.cu:rt_greedy_loop_bits, a cooperative launch whose
blocks split each greedy's candidates; `greedy_loop_resident_bits`
(`greedy_loop_resident[coverage]`) launches
csrc/greedy_loop_resident.cu:rt_resident_bits_kernel, a thread-block
cluster a node splitting its words (`resident_bits_plan`), under
``ctl``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, counters, plans, ref
from repro_torch.kernels import rules as R
from repro_torch.kernels.pairwise import (DTYPES, FOLDS, MODES,
                                          STORAGES, check_feature_rule,
                                          check_operand, check_storage,
                                          check_words, storage_counters)
from repro_torch.kernels.plans import BITS_LOOP_BLOCK_C, FUSED_BLOCK_N
from repro_torch.kernels.rules import WORD_DTYPE, KernelRule

F32 = torch.float32

STREAM_COUNTERS = storage_counters("greedy_loop")
RESIDENT_COUNTERS = storage_counters("greedy_loop_resident")
STREAM_BITS_COUNTER = counters.counter("greedy_loop[coverage]")
RESIDENT_BITS_COUNTER = counters.counter("greedy_loop_resident[coverage]")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def greedy_loop_plain(mat, row, mask, k: int, rule: KernelRule, kq=None,
                      scale=None):
    """The streaming loop in plain PyTorch (kernels/ref.py:greedy_loop)
    over the cache's f32 values (`scale`: an int8 cache's row scales)."""
    return ref.greedy_loop(R.logical(mat, scale), row, mask, k, rule, kq=kq)


def resident_matrix(ground, cands, rule: KernelRule, ctl=None,
                    cache_dtype: str = "float32"):
    """The matrix a resident greedy runs over: the rule's pairwise build,
    rounded to the plan's storage dtype inside the logical extents
    (ctl[..., 1:3]) as the reference's resident kernel does."""
    mat = ref.pairwise(ground, cands, rule)
    if rule.is_bitmap:
        return mat
    return round_resident(mat, cache_dtype, ctl)


def round_resident(mat, cache_dtype: str, ctl=None):
    """An f32 (…, N, C) build rounded as the resident tier rounds it:
    entries outside the logical extents ctl[..., 1:3] zeroed, the rest
    stored as `cache_dtype` and read back as f32 (unchanged for f32)."""
    if cache_dtype not in ("int8", "bfloat16"):
        return mat
    n, c = mat.shape[-2:]
    if ctl is not None:
        ln = ctl[..., 1].reshape(ctl.shape[:-1] + (1, 1))
        lc = ctl[..., 2].reshape(ctl.shape[:-1] + (1, 1))
        rows = torch.arange(n, device=mat.device).reshape(n, 1)
        cols = torch.arange(c, device=mat.device).reshape(1, c)
        mat = torch.where((rows < ln) & (cols < lc), mat,
                          torch.zeros_like(mat))
    if cache_dtype == "int8":
        return R.dequant(*R.quantize_rows(mat))
    return mat.to(torch.bfloat16).to(F32)


def greedy_loop_resident_plain(ground, cands, row, mask, ctl, k: int,
                               rule: KernelRule,
                               cache_dtype: str = "float32"):
    """The resident loop in plain PyTorch: build the matrix, then the
    streaming oracle with the per-greedy step budget kq = ctl[..., 0]."""
    mat = resident_matrix(ground, cands, rule, ctl, cache_dtype)
    return ref.greedy_loop(mat, row, mask, k, rule, kq=ctl[..., 0])


def fused_steps(mat, row, mask, k: int, rule: KernelRule,
                block_n: int = FUSED_BLOCK_N, scale=None):
    """k fused_step launches over the cache with each step's winner passed
    on as prev and taken out of the mask, then one more launch for the
    final fold: the streaming loop's yardstick of bits (with the same
    `block_n` the loop gives these bits). Feature rules; returns as
    `greedy_loop`."""
    from repro_torch.kernels import fused_step as F
    b = mat.shape[0]
    idx = torch.arange(b, device=mat.device)
    prev = torch.full((b,), -1, dtype=torch.int64, device=mat.device)
    mask = mask.clone()
    bests, gains = [], []
    for _ in range(k):
        row, best, gain = F.fused_step(mat, row, mask, prev, rule,
                                       block_n=block_n, scale=scale)
        accept = torch.isfinite(gain) & (gain > 0)
        prev = torch.where(accept, best, -1)
        mask[idx[accept], best[accept]] = 0.0
        bests.append(prev)
        gains.append(gain)
    if k:
        row = F.fused_step(mat, row, mask, prev, rule, block_n=block_n,
                           scale=scale)[0]
    empty = torch.empty((b, 0), device=mat.device)
    return (row, torch.stack(bests, 1) if k else empty.long(),
            torch.stack(gains, 1) if k else empty)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _stream_lib():
    lib = build.load("greedy_loop")
    lib.rt_greedy_loop_plan.restype = _I
    lib.rt_greedy_loop_plan.argtypes = [_I, _P] + [_I] * 4 + [_P]
    lib.rt_greedy_loop_bits_occupancy.restype = _I
    lib.rt_greedy_loop_bits_occupancy.argtypes = [_I, ctypes.POINTER(_I),
                                                  ctypes.POINTER(_I)]
    lib.rt_greedy_loop.restype = _I
    lib.rt_greedy_loop.argtypes = ([_P] * 11 + [_I] * 5 + [_P] + [_I] * 2
                                   + [_F, _F, _F, _P])
    lib.rt_greedy_loop_bits.restype = _I
    lib.rt_greedy_loop_bits.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    return lib


def _resident_lib():
    lib = build.load("greedy_loop_resident")
    lib.rt_greedy_loop_resident_plan.restype = _I
    lib.rt_greedy_loop_resident_plan.argtypes = [_I] * 4 + [_P]
    lib.rt_greedy_loop_resident.restype = _I
    lib.rt_greedy_loop_resident.argtypes = ([_P] * 11 + [_I] * 9
                                            + [_F, _F, _F, _P])
    lib.rt_greedy_loop_resident_bits_plan.restype = _I
    lib.rt_greedy_loop_resident_bits_plan.argtypes = [_I, _I,
                                                      ctypes.c_longlong, _P]
    lib.rt_greedy_loop_resident_bits.restype = _I
    lib.rt_greedy_loop_resident_bits.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    return lib


def _co_resident(lib, occupancy, smem: int, *lead) -> int:
    """Blocks the card holds at once at `smem` bytes of dynamic shared
    memory (raises when the kernel cannot launch at all); `lead`: the
    occupancy query's arguments before the bytes."""
    bps, sms = _I(), _I()
    build.check(lib, occupancy(*lead, smem, ctypes.byref(bps),
                               ctypes.byref(sms)), "occupancy query")
    return bps.value * sms.value


def _plan(lib, mat, ch: int, storage: int):
    """rt_greedy_loop_plan's (blocks a greedy, the spans' columns) for the
    (B, N, C) CUDA cache `mat` in chunks of `ch` rows."""
    b, n, c = mat.shape
    plan = (_I * 2)()
    build.check(lib, lib.rt_greedy_loop_plan(storage, mat.data_ptr(), b, n,
                                             c, ch, plan),
                "greedy_loop plan")
    return plan


def loop_plan(mat, block_n: int = FUSED_BLOCK_N) -> dict:
    """How the streaming loop splits each greedy of the (B, N, C) CUDA
    cache `mat` (f32, bf16 or int8) in chunks of `block_n` rows: {'blocks'
    a greedy} (csrc/greedy_loop.cu:rt_greedy_loop_plan)."""
    plan = _plan(_stream_lib(), mat, max(1, int(block_n)),
                 STORAGES.get(mat.dtype, STORAGES[F32]))
    return {"blocks": plan[0]}


def greedy_loop(mat, row, mask, k: int, rule: KernelRule,
                block_n: int = FUSED_BLOCK_N, scale=None):
    """STREAMING tier over cached matrices. mat (B, N, C) f32, bf16 or
    int8 (with `scale`, its (B, 1, N) f32 row scales), row (B, N), mask
    (B, C) 0/1 f32, `block_n` the ground rows a chunk of the gain sum (as
    fused_step's: the loop gives the bits of k fused_step launches with
    the same block_n). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. The bitmap rule goes to
    `greedy_loop_bits`."""
    if rule.is_bitmap:
        return greedy_loop_bits(mat, row, mask, k, rule)
    counter = STREAM_COUNTERS.get(mat.dtype, STREAM_COUNTERS[F32])
    counter.calls += 1
    if not mat.is_cuda:
        return greedy_loop_plain(mat, row, mask, k, rule, scale=scale)
    check_feature_rule(rule, "greedy_loop")
    if mat.dim() != 3:
        raise ValueError("greedy_loop kernel takes (B, N, C) matrices")
    b, n, c = mat.shape
    dev = mat.device
    storage = check_storage(mat, scale, (b, n, c), "greedy_loop", dev)
    check_operand(row, (b, n), F32, "row", dev)
    check_operand(mask, (b, c), F32, "mask", dev)
    row_out = torch.empty((b, n), dtype=F32, device=dev)
    bests = torch.empty((b, k), dtype=torch.int32, device=dev)
    gains = torch.empty((b, k), dtype=F32, device=dev)
    if b == 0:
        return row_out, bests.long(), gains
    ch = max(1, int(block_n))
    lib = _stream_lib()
    plan = _plan(lib, mat, ch, storage)
    # the chunk partials (plans.loop_scratch_bytes), the blocks' pairs,
    # the barrier counters
    partials = torch.empty((b, -(-n // ch), plan[1]), dtype=F32, device=dev)
    pval = torch.empty((b, plan[0]), dtype=F32, device=dev)
    pidx = torch.empty((b, plan[0]), dtype=torch.int32, device=dev)
    bar = torch.zeros((b,), dtype=torch.int32, device=dev)
    err = lib.rt_greedy_loop(
        mat.data_ptr(), None if scale is None else scale.data_ptr(),
        row.data_ptr(), mask.data_ptr(), row_out.data_ptr(),
        bests.data_ptr(), gains.data_ptr(), partials.data_ptr(),
        pval.data_ptr(), pidx.data_ptr(), bar.data_ptr(), b, n, c, k, ch, plan,
        storage, FOLDS[rule.fold], rule.cap, rule.lam, 1.0 - rule.lam,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "greedy_loop kernel")
    counter.launches += 1
    return row_out, bests.long(), gains


def greedy_loop_resident(ground, cands, row, mask, ctl, k: int,
                         rule: KernelRule, cache_dtype: str = "float32",
                         scratch=None, block_n: int = FUSED_BLOCK_N):
    """RESIDENT tier: ground (B, N, D), cands (B, C, D), row (B, N),
    mask (B, C) 0/1 f32, ctl (B, 3) int32, `cache_dtype` the plan's
    storage ('float32' | 'bfloat16' | 'int8'), whose rounding the matrix
    gets inside the logical extents ctl[:, 1:3]; gains summed in chunks
    of `block_n` rows (the loop gives the bits of `greedy_loop` over the
    matrix it ran over). CPU tensors take the plain version; CUDA tensors
    launch the kernels (one counted dispatch) or raise. `scratch`, a
    (B, N, C) f32 tensor, receives the f32 values of the matrices the
    loop runs over (for checks; by default the wrapper allocates it)."""
    if rule.is_bitmap:
        if scratch is not None:
            raise ValueError("the bitmap resident loop builds no matrix")
        return greedy_loop_resident_bits(cands, row, mask, ctl, k, rule)
    if cache_dtype not in DTYPES:
        raise ValueError(f"unknown cache dtype {cache_dtype!r}")
    counter = RESIDENT_COUNTERS[DTYPES[cache_dtype]]
    counter.calls += 1
    if not cands.is_cuda:
        if scratch is not None:
            scratch.copy_(resident_matrix(ground, cands, rule, ctl,
                                          cache_dtype))
        return greedy_loop_resident_plain(ground, cands, row, mask, ctl, k,
                                          rule, cache_dtype)
    check_feature_rule(rule, "greedy_loop_resident")
    if ground.dim() != 3 or cands.dim() != 3:
        raise ValueError("resident kernel takes (B, N, D) and (B, C, D)")
    b, n, d = ground.shape
    c = cands.shape[1]
    dev = cands.device
    check_operand(ground, (b, n, d), F32, "ground", dev)
    check_operand(cands, (b, c, d), F32, "cands", dev)
    check_operand(row, (b, n), F32, "row", dev)
    check_operand(mask, (b, c), F32, "mask", dev)
    check_operand(ctl, (b, 3), torch.int32, "ctl", dev)
    row_out = torch.empty((b, n), dtype=F32, device=dev)
    bests = torch.empty((b, k), dtype=torch.int32, device=dev)
    gains = torch.empty((b, k), dtype=F32, device=dev)
    if b == 0:
        return row_out, bests.long(), gains
    ch = max(1, int(block_n))
    storage = STORAGES[DTYPES[cache_dtype]]
    lib = _resident_lib()
    plan = (_I * 2)()       # on chip?, the stored rows' padded width
    build.check(lib, lib.rt_greedy_loop_resident_plan(storage, n, c, ch,
                                                      plan),
                "greedy_loop_resident plan")
    if scratch is None:
        scratch = torch.empty((b, n, c), dtype=F32, device=dev)
    check_operand(scratch, (b, n, c), F32, "scratch", dev)
    typed = partials = None
    if not plan[0]:                 # the device tier's copy and partials
        typed = torch.empty((b, n, plan[1]), dtype=DTYPES[cache_dtype],
                            device=dev)
        partials = torch.empty((b, 2, -(-n // ch), plan[1]), dtype=F32,
                               device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = lib.rt_greedy_loop_resident(
        ground.data_ptr(), cands.data_ptr(), row.data_ptr(), mask.data_ptr(),
        ctl.data_ptr(), scratch.data_ptr(), ptr(typed), ptr(partials),
        row_out.data_ptr(), bests.data_ptr(),
        gains.data_ptr(), b, n, c, d, k, ch, MODES[rule.pairwise], storage,
        FOLDS[rule.fold], rule.cap, rule.lam, 1.0 - rule.lam,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "greedy_loop_resident kernel")
    counter.launches += 1
    return row_out, bests.long(), gains


def resident_tier(n: int, c: int, cache_dtype: str = "float32",
                  block_n: int = FUSED_BLOCK_N) -> str:
    """Where the resident loop's steps keep a node's (n, c) matrix in
    `cache_dtype`: 'chip' (its cluster's shared memory) or 'device' (a
    device-memory copy; csrc/greedy_loop_resident.cu)."""
    plan = (_I * 2)()
    lib = _resident_lib()
    build.check(lib, lib.rt_greedy_loop_resident_plan(
        STORAGES[DTYPES[cache_dtype]], n, c, max(1, int(block_n)), plan),
        "greedy_loop_resident plan")
    return "chip" if plan[0] else "device"


def resident_bits_plan(w: int, c: int) -> Tuple[str, int]:
    """(tier, cluster) of the bitmap resident loop over nodes of c
    candidates × w words (csrc/greedy_loop_resident.cu:
    rt_greedy_loop_resident_bits_plan): ('chip', R) for the smallest
    cluster of 8 or 16 blocks whose shared memory, each block within
    `plans.RESIDENT_BITS_SMEM_BYTES` (read at call time), holds the
    node's words — kcover's 128 × 1,290 on 8 blocks, kdom's 256 × 2,048
    on 16 — else ('device', 8): the same steps read the words from
    device memory. Both tiers give the same bits."""
    plan = (_I * 2)()
    lib = _resident_lib()
    build.check(lib, lib.rt_greedy_loop_resident_bits_plan(
        c, w, plans.RESIDENT_BITS_SMEM_BYTES, plan),
        "greedy_loop_resident[coverage] plan")
    return ("chip" if plan[0] else "device"), plan[1]


def bits_blocks_per_greedy(lib, b: int, c: int, w: int,
                           block_c: int = BITS_LOOP_BLOCK_C):
    """(P, CB): blocks per greedy and candidates per block of the bitmap
    loop. Starts from ⌈c / block_c⌉ blocks and gives each
    block more candidates while the card cannot hold all b·P blocks at
    once; raises when even one block per greedy does not fit."""
    p = max(1, -(-c // max(1, block_c)))
    while True:
        cb = max(1, -(-c // p))
        cap = _co_resident(lib, lib.rt_greedy_loop_bits_occupancy,
                           4 * (w + cb))
        if b * p <= cap:
            return p, cb
        if p == 1:
            raise RuntimeError(
                f"bitmap streaming loop: {b} greedies × 1 block exceed the "
                f"{cap} blocks the card holds at once")
        p = max(1, min(p - 1, cap // b))


def greedy_loop_bits(mat, row, mask, k: int, rule: KernelRule,
                     block_c: int = BITS_LOOP_BLOCK_C):
    """The bitmap rule's STREAMING tier: mat (B, W, C) is the transposed
    view of contiguous (B, C, W) int32 candidate words (never copied),
    row (B, W) int32, mask (B, C) 0/1 f32, `block_c` the target
    candidates per block. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    STREAM_BITS_COUNTER.calls += 1
    if not mat.is_cuda:
        return greedy_loop_plain(mat, row, mask, k, rule)
    if mat.dim() != 3:
        raise ValueError("greedy_loop kernel takes (B, W, C) matrices")
    cands = mat.transpose(-1, -2)
    b, c, w = cands.shape
    dev = cands.device
    row_out, bests, gains = _bits_operands(cands, row, mask, k,
                                           "greedy_loop")
    if b == 0:
        return row_out, bests.long(), gains
    lib = _stream_lib()
    p, cb = bits_blocks_per_greedy(lib, b, c, w, block_c)
    pval = torch.empty((2, b, p), dtype=F32, device=dev)
    pidx = torch.empty((2, b, p), dtype=torch.int32, device=dev)
    err = lib.rt_greedy_loop_bits(
        cands.data_ptr(), row.data_ptr(), mask.data_ptr(),
        row_out.data_ptr(), bests.data_ptr(), gains.data_ptr(),
        pval.data_ptr(), pidx.data_ptr(), b, c, w, k, p, cb,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "bitmap greedy_loop kernel")
    STREAM_BITS_COUNTER.launches += 1
    return row_out, bests.long(), gains


def _bits_operands(cands, row, mask, k: int, what: str):
    """Check a bitmap loop's operands — cands (B, C, W) int32 words, row
    (B, W) int32, mask (B, C) 0/1 f32 on one CUDA device — and allocate
    its outputs: row_out (B, W), bests (B, k) int32, gains (B, k) f32."""
    b, c, w = cands.shape
    dev = cands.device
    check_operand(cands, (b, c, w), WORD_DTYPE, "candidate words", dev)
    check_operand(row, (b, w), WORD_DTYPE, "row", dev)
    check_operand(mask, (b, c), F32, "mask", dev)
    check_words(w, what)
    return (torch.empty((b, w), dtype=WORD_DTYPE, device=dev),
            torch.empty((b, k), dtype=torch.int32, device=dev),
            torch.empty((b, k), dtype=F32, device=dev))


def greedy_loop_resident_bits(cands, row, mask, ctl, k: int,
                              rule: KernelRule):
    """The bitmap rule's RESIDENT tier: cands (B, C, W) int32 words, read
    in place (the reference's on-chip matrix is their transpose), row
    (B, W) int32, mask (B, C) 0/1 f32, ctl (B, 3) int32 (steps ≥ kq =
    ctl[:, 0] freeze). CPU tensors take the plain version; CUDA tensors
    launch csrc/greedy_loop_resident.cu's cluster kernel or raise: a
    cluster a node on the tier and cluster size `resident_bits_plan`
    picks."""
    RESIDENT_BITS_COUNTER.calls += 1
    if not cands.is_cuda:
        return greedy_loop_resident_plain(None, cands, row, mask, ctl, k,
                                          rule)
    if cands.dim() != 3:
        raise ValueError("bitmap resident kernel takes (B, C, W) words")
    b, c, w = cands.shape
    dev = cands.device
    row_out, bests, gains = _bits_operands(cands, row, mask, k,
                                           "greedy_loop_resident")
    check_operand(ctl, (b, 3), torch.int32, "ctl", dev)
    if b == 0:
        return row_out, bests.long(), gains
    tier, cluster = resident_bits_plan(w, c)
    partials = (None if tier == "chip" else   # (…, c rounded up to 4)
                torch.empty((b, 2, cluster, (c + 3) & ~3),
                            dtype=torch.int32, device=dev))
    lib = _resident_lib()
    err = lib.rt_greedy_loop_resident_bits(
        cands.data_ptr(), row.data_ptr(), mask.data_ptr(), ctl.data_ptr(),
        row_out.data_ptr(), bests.data_ptr(), gains.data_ptr(),
        None if partials is None else partials.data_ptr(), b, c, w, k,
        cluster, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "greedy_loop_resident[coverage] kernel")
    RESIDENT_BITS_COUNTER.launches += 1
    return row_out, bests.long(), gains
