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

On CUDA tensors the kernels take f32 storage of the feature rules and
the bitmap rule's int32 words; bf16/int8 storage raises
NotImplementedError there (its plain versions run on the CPU). A bitmap
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
from repro_torch.kernels.plans import EnginePlan, fused_block_n, loop_block_n
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
        return R.dequant(mat.q, mat.scale)
    if mat.dtype == torch.bfloat16:
        return mat.to(F32)
    return mat


def _cast_row(row, rule: KernelRule):
    return row.to(rule.dtype).contiguous()


def _storage_check(mat, what: str) -> None:
    """bf16/int8 caches have no CUDA path yet: raise on the card."""
    if mat.is_cuda and (isinstance(mat, QuantMatrix)
                        or mat.dtype not in (F32, R.WORD_DTYPE)):
        raise NotImplementedError(
            f"{what}: {mat.dtype} storage has no CUDA path yet")


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
    """The cached ground×candidate matrix, (B, N, C). Feature rules run
    the pairwise kernel (its plain version on the CPU) and store it in
    ``dtype``; bitmap rules transpose the candidate words — no launch."""
    if rule.is_bitmap:
        return cands.transpose(-1, -2)
    if cands.is_cuda and dtype != "float32":
        raise NotImplementedError(
            f"pairwise_matrix: {dtype} storage has no CUDA path yet")
    m = pairwise_k.pairwise(ground.to(F32).contiguous(),
                            cands.to(F32).contiguous(), rule.pairwise)
    if dtype == "int8":
        return QuantMatrix(*R.quantize_rows(m))
    if dtype == "bfloat16":
        return m.to(torch.bfloat16)
    return m


def fused_step(mat, row, mask, prev, rule: KernelRule,
               plan: Optional[EnginePlan] = None):
    """One fused greedy step over the cached matrix → (new_row (B, N),
    best (B,), raw gain (B,)) (the fused_step kernel; ``plan`` gives a
    feature rule's rows per block)."""
    _storage_check(mat, "fused_step")
    blocks = {}
    if not rule.is_bitmap:      # a bitmap matrix is read in place
        mat = _dequant_mat(mat).contiguous()
        blocks["block_n"] = (plan.block_n if plan is not None
                             else 0) or fused_block_n()
    return fused_k.fused_step(mat, _cast_row(row, rule),
                              mask.to(F32).contiguous(), prev, rule,
                              **blocks)


def greedy_loop(mat, row, mask, k: int, rule: KernelRule,
                plan: Optional[EnginePlan] = None):
    """STREAMING tier: all k steps over cached (B, N, C) matrices in one
    launch. Returns (final rows (B, N), bests (B, k) with −1 = rejected,
    raw gains (B, k))."""
    _storage_check(mat, "greedy_loop")
    blocks = {}
    if not rule.is_bitmap:      # a bitmap matrix is read in place
        mat = _dequant_mat(mat).contiguous()
        blocks["block_n"] = (plan.loop_block_n if plan is not None
                             else 0) or loop_block_n(mat.shape[-1])
    return loop_k.greedy_loop(mat, _cast_row(row, rule),
                              mask.to(F32).contiguous(), k, rule, **blocks)


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
    idx < 0 is a no-op."""
    col = ref.column(_dequant_mat(mat), idx)[..., :row.shape[-1]]
    return R.fold_winner(row, col, idx, rule)


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
