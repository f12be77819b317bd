"""Kernel dispatch, rule-dispatched (answers `src/repro/kernels/ops.py`).

Every function takes a leading batch dimension B: the greedies of one
tree level, served by one kernel launch. Whether a kernel or its plain
version runs follows the tensors' device — CPU tensors take the plain
PyTorch path, CUDA tensors launch the hand-written kernel or raise; there
is no backend switch that could put a plain version on the card.

  pairwise_matrix       cached (B, N, C) matrix → kernels/pairwise.py
  gains                 step engine's gains     → kernels/pairwise.py
  fused_step            fused engine's step     → kernels/fused_step.py
  greedy_loop           streaming tier          → kernels/greedy_loop.py
  greedy_loop_resident  resident tier           → kernels/greedy_loop.py
  apply_column          final-winner flush      (plain torch, O(N))
  masked_col_reduce     batched replay fold     (plain torch)

A feature rule's cache is stored as the plan says (plans.py's storage
ladder): f32, bf16, or int8 as a `QuantMatrix` of per-row-scaled
entries. The kernels take each storage as it is — on the card nothing
here widens a bf16/int8 cache into an f32 copy, which would take the
memory the ladder stepped down to save — and an int8 cache is built in
chunks of greedies (`pairwise_matrix`). The int8-quantized GROUND of the
per-step gains still has no CUDA path and raises there. A bitmap
"matrix" is the transposed VIEW of the candidates' (B, C, W) words, and
the bitmap kernels read those words in place: nothing here makes it
contiguous (at the kcover leaf that would copy 5.1 GB a step).

The CUDA kernels mask their ragged edges, so nothing is padded to TPU
tiles here. Launch counts live in kernels/counters.py.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import fused_step as fused_k
from repro_torch.kernels import greedy_loop as loop_k
from repro_torch.kernels import pairwise as pairwise_k
from repro_torch.kernels import ref
from repro_torch.kernels import rules as R
from repro_torch.kernels.plans import (EnginePlan, fused_block_n,
                                       loop_block_n, quant_chunk)
from repro_torch.kernels.rules import KernelRule
from repro_torch.runtime import flags

F32 = torch.float32


@dataclasses.dataclass
class QuantMatrix:
    """int8-quantized cached matrix: `q` (…, N, C) int8 + `scale`
    (…, 1, N) f32 per-row scales (rules.quantize_rows)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def is_cuda(self) -> bool:
        return self.q.is_cuda


def _dequant_mat(mat):
    """Logical f32 view of a cached matrix (QuantMatrix or bf16 → f32;
    f32 and bitmap words pass through)."""
    if isinstance(mat, QuantMatrix):
        return R.logical(mat.q, mat.scale)
    return R.logical(mat)


def _storage(mat):
    """(stored matrix, its int8 row scales or None, dtype name)."""
    if isinstance(mat, QuantMatrix):
        return mat.q, mat.scale, "int8"
    return mat, None, ("bfloat16" if mat.dtype == torch.bfloat16
                       else "float32")


def _cast_row(row, rule: KernelRule):
    return row.to(rule.dtype).contiguous()


def gains(ground, row, cands, cand_valid, rule: KernelRule):
    """Per-step marginal gains: RAW part sums (B, C), −inf at invalid
    candidates (the gains kernel; bitmap cands are (B, C, W) words and
    the ground is not read). With REPRO_TORCH_FUSED_CACHE_DTYPE=int8
    the ground features are seen per-row-quantized, as in the reference;
    that variant has no CUDA path yet."""
    quant = (not rule.is_bitmap and ground is not None
             and flags.fused_cache_dtype() == "int8")
    if quant:
        if cands.is_cuda:
            raise NotImplementedError(
                "gains: int8 ground storage has no CUDA path yet")
        ground = R.dequant(*R.quantize_rows(ground.to(F32)))
    if rule.is_bitmap:
        cands = cands.contiguous()
    else:
        ground = ground.to(F32).contiguous()
        cands = cands.to(F32).contiguous()
    return pairwise_k.gains(ground, _cast_row(row, rule), cands, cand_valid,
                            rule)


def pairwise_matrix(ground, cands, rule: KernelRule,
                    dtype: str = "float32"):
    """The cached ground×candidate matrix, (B, N, C), stored as ``dtype``.
    Feature rules run the pairwise kernel (its plain version on the
    CPU): f32 and bf16 straight from the kernel; int8 in chunks of
    greedies (plans.quant_chunk), each built in f32 and quantized by
    rules.quantize_rows in place into its slice of the cache — per-row
    scales, so the bytes of the one-shot build, with one chunk's f32 as
    the only transient. Bitmap rules transpose the candidate words — no
    launch."""
    if rule.is_bitmap:
        return cands.transpose(-1, -2)
    g = ground.to(F32).contiguous()
    c = cands.to(F32).contiguous()
    if dtype != "int8":
        return pairwise_k.pairwise(g, c, rule.pairwise,
                                   out_dtype=pairwise_k.DTYPES[dtype])
    b, n, nc = g.shape[0], g.shape[1], c.shape[1]
    q = torch.empty((b, n, nc), dtype=torch.int8, device=g.device)
    scale = torch.empty((b, 1, n), dtype=F32, device=g.device)
    step = quant_chunk(n, nc)
    for b0 in range(0, b, step):
        part = slice(b0, b0 + step)
        _, scale[part] = R.quantize_rows(
            pairwise_k.pairwise(g[part], c[part], rule.pairwise),
            out=q[part])
    return QuantMatrix(q, scale)


def fused_step(mat, row, mask, prev, rule: KernelRule,
               plan: Optional[EnginePlan] = None):
    """One fused greedy step over the cached matrix → (new_row (B, N),
    best (B,), raw gain (B,)) (the fused_step kernel on the cache as
    stored; ``plan`` gives a feature rule's rows per block)."""
    kw = {}
    if not rule.is_bitmap:      # a bitmap matrix is read in place
        mat, kw["scale"], dtype = _storage(mat)
        kw["block_n"] = (plan.block_n if plan is not None
                         else 0) or fused_block_n(dtype)
    return fused_k.fused_step(mat, _cast_row(row, rule),
                              mask.to(F32).contiguous(), prev, rule, **kw)


def greedy_loop(mat, row, mask, k: int, rule: KernelRule,
                plan: Optional[EnginePlan] = None):
    """STREAMING tier: all k steps over cached (B, N, C) matrices in one
    launch, over the caches as stored. Returns (final rows (B, N), bests
    (B, k) with −1 = rejected, raw gains (B, k))."""
    kw = {}
    if not rule.is_bitmap:      # a bitmap matrix is read in place
        mat, kw["scale"], dtype = _storage(mat)
        kw["block_n"] = (plan.loop_block_n if plan is not None
                         else 0) or loop_block_n(mat.shape[-1], dtype)
    return loop_k.greedy_loop(mat, _cast_row(row, rule),
                              mask.to(F32).contiguous(), k, rule, **kw)


def greedy_loop_resident(ground, cands, row, mask, k: int,
                         rule: KernelRule, cache_dtype: str = "float32",
                         kq=None, logical=None):
    """RESIDENT tier: matrix build + all k steps, one launch for all B
    greedies. ``kq`` (int or (B,)): per-greedy step budget; ``logical``:
    (n_logical, c_logical) bounding the sub-f32 rounding of pre-padded
    inputs. Returns as `greedy_loop`."""
    b = mask.shape[0]
    n, c = row.shape[-1], mask.shape[-1]
    ln, lc = logical if logical is not None else (n, c)
    dev = cands.device

    def col(v):
        return torch.as_tensor(v, dtype=torch.int32,
                               device=dev).expand(b)

    ctl = torch.stack([col(k if kq is None else kq), col(ln), col(lc)],
                      dim=-1).contiguous()
    g = None if rule.is_bitmap else ground.to(F32).contiguous()
    cd = cands.contiguous() if rule.is_bitmap else cands.to(F32).contiguous()
    return loop_k.greedy_loop_resident(g, cd, _cast_row(row, rule),
                                       mask.to(F32).contiguous(), ctl, k,
                                       rule, cache_dtype=cache_dtype)


def apply_column(mat, row, idx, rule: KernelRule):
    """Fold column idx (B,) of each cached matrix into its state row;
    idx < 0 is a no-op. The column is gathered in its storage and only
    it is widened: the values of the whole matrix's dequant, without an
    f32 copy of the cache."""
    if isinstance(mat, QuantMatrix):
        col = R.dequant(ref.column(mat.q, idx).unsqueeze(-1),
                        mat.scale).squeeze(-1)
    else:
        col = R.logical(ref.column(mat, idx))
    return R.fold_winner(row, col[..., :row.shape[-1]], idx, rule)


def masked_col_reduce(mat, col_valid, row, rule: KernelRule):
    """Batched replay: fold ALL valid columns of each cached matrix into
    its state row in one pass. Valid for every fold: min/max are
    idempotent, OR is one union, and the saturated add telescopes."""
    n, c = row.shape[-1], col_valid.shape[-1]
    if c == 0:
        return row
    sub = _dequant_mat(mat)[..., :n, :c]
    valid = col_valid.unsqueeze(-2)
    if rule.fold == "or":
        masked = torch.where(valid, sub, torch.zeros_like(sub))
        union = functools.reduce(torch.bitwise_or, masked.unbind(-1))
        return torch.bitwise_or(row, union)
    sub = sub.to(F32)
    if rule.fold == "min":
        vals = torch.where(valid, sub, torch.full_like(sub, float("inf")))
        return torch.minimum(row, vals.amin(-1))
    if rule.fold == "max":
        vals = torch.where(valid, sub, torch.full_like(sub, float("-inf")))
        return torch.maximum(row, vals.amax(-1))
    inc = torch.sum(torch.where(valid, torch.clamp(sub, min=0.0),
                                torch.zeros_like(sub)), dim=-1)
    if rule.fold == "satsum":
        return torch.clamp(row + inc, max=rule.cap)
    if rule.fold == "sum":
        return row + inc
    raise KeyError(rule.fold)
