"""Kernel dispatch, rule-dispatched (answers `src/repro/kernels/ops.py`).

Every function takes a leading batch dimension B: the greedies of one
tree level, served by one kernel launch. Whether a kernel or its plain
version runs follows the tensors' device — CPU tensors take the plain
PyTorch path, CUDA tensors launch the hand-written kernel or raise; there
is no backend switch that could put a plain version on the card.

  pairwise_matrix       cached (B, N, C) matrix → kernels/pairwise.py
  gains                 step engine's gains     → kernels/pairwise.py
  gains_norms           its ground's norms      → kernels/pairwise.py
  fused_step            fused engine's step     → kernels/fused_step.py
  greedy_loop           streaming tier          → kernels/greedy_loop.py
  greedy_loop_resident  resident tier           → kernels/greedy_loop.py
  stream_filter         sieve batch filter      → kernels/stream_filter.py
  apply_column          final-winner flush      (plain torch, O(N))
  masked_col_reduce     batched replay fold     (plain torch)

A feature rule's cache is stored as the plan says (plans.py's storage
ladder): f32, bf16, or int8 as a `QuantMatrix` of per-row-scaled
entries. The kernels take each storage as it is — on the card nothing
here widens a bf16/int8 cache into an f32 copy, which would take the
memory the ladder stepped down to save — and an int8 cache is built in
chunks of greedies (`pairwise_matrix`). Under a forced int8 rung the
per-step gains and the stream filter read their GROUND features int8
per-row-quantized too (`quantize_ground`, as the reference), each kernel
widening an entry as it loads it. A bitmap
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
from repro_torch.kernels import stream_filter as stream_k
from repro_torch.kernels.plans import (QUANT_CHUNK_BYTES, EnginePlan,
                                       fused_block_n, quant_chunk,
                                       stream_plan)
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


def quantize_ground(ground):
    """(…, N, D) f32 ground features → (q int8 (…, N, D), scale f32
    (…, 1, N)): rules.quantize_rows of every row, taken in chunks of rows
    whose f32 work buffer is at most QUANT_CHUNK_BYTES (a row's scale
    sees only its own row, so the chunks give the one-shot bits)."""
    g = ground.to(F32)
    d = g.shape[-1]
    flat = g.reshape(-1, d)
    q = torch.empty(flat.shape, dtype=torch.int8, device=g.device)
    scale = torch.empty((flat.shape[0],), dtype=F32, device=g.device)
    step = max(1, QUANT_CHUNK_BYTES // max(1, 4 * d))
    for i in range(0, flat.shape[0], step):
        _, sc = R.quantize_rows(flat[i:i + step].clone(), out=q[i:i + step])
        scale[i:i + step] = sc.reshape(-1)
    return (q.reshape(g.shape),
            scale.reshape(g.shape[:-1]).unsqueeze(-2))


def gains(ground, row, cands, cand_valid, rule: KernelRule, gscale=None,
          gnorm=None):
    """Per-step marginal gains: RAW part sums (B, C), −inf at invalid
    candidates (the gains kernel; bitmap cands are (B, C, W) words and
    the ground is not read). ``gscale`` (B, 1, N): the ground is already
    int8 (`quantize_ground`; the objective quantizes once per greedy).
    ``gnorm`` (B, N): the stored ground's `gains_norms` for a 'dist'
    rule (the objective takes them once per greedy; the kernel computes
    them per call when not given). With REPRO_TORCH_FUSED_CACHE_DTYPE=
    int8 an f32 ground is quantized here, as in the reference; the
    kernel reads it as int8 (a ``gnorm`` beside a ground quantized here
    raises: it would be the f32 rows')."""
    if (not rule.is_bitmap and gscale is None and ground is not None
            and flags.fused_cache_dtype() == "int8"):
        if gnorm is not None:
            raise ValueError("gains: gnorm goes with the stored ground "
                             "(int8 here: pass its gscale)")
        ground, gscale = quantize_ground(ground)
    if rule.is_bitmap:
        cands = cands.contiguous()
    else:
        ground = (ground.to(F32) if gscale is None else ground).contiguous()
        gscale = None if gscale is None else gscale.to(F32).contiguous()
        gnorm = None if gnorm is None else gnorm.to(F32).contiguous()
        cands = cands.to(F32).contiguous()
    return pairwise_k.gains(ground, _cast_row(row, rule), cands, cand_valid,
                            rule, gscale=gscale, gnorm=gnorm)


def gains_norms(ground, gscale=None):
    """The 'dist' norms (B, N) of a ground as `gains` stores it (f32, or
    int8 with its (B, 1, N) scales): one pass, taken once per greedy
    (the ground does not change over its steps)."""
    ground = (ground.to(F32) if gscale is None else ground).contiguous()
    gscale = None if gscale is None else gscale.to(F32).contiguous()
    return pairwise_k.ground_norms(ground, gscale)


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
    stored; ``plan`` gives a feature rule's rows a chunk of the sum)."""
    kw = {}
    if rule.is_bitmap:  # (B, W, C) over candidate-major (B, C, W) words
        mat = mat.mT.contiguous().mT
    else:
        mat, kw["scale"], dtype = _storage(mat)
        kw["block_n"] = (plan.block_n if plan is not None
                         else 0) or fused_block_n(dtype)
    return fused_k.fused_step(mat, _cast_row(row, rule),
                              mask.to(F32).contiguous(), prev, rule, **kw)


def greedy_loop(mat, row, mask, k: int, rule: KernelRule,
                plan: Optional[EnginePlan] = None):
    """STREAMING tier: all k steps over cached (B, N, C) matrices in one
    launch, over the caches as stored (a feature rule's gains summed in
    the plan's chunks of block_n rows, as fused_step sums them). Returns
    (final rows (B, N), bests (B, k) with −1 = rejected, raw gains
    (B, k))."""
    kw = {}
    if rule.is_bitmap:  # (B, W, C) over candidate-major (B, C, W) words
        mat = mat.mT.contiguous().mT
    else:
        mat, kw["scale"], dtype = _storage(mat)
        kw["block_n"] = (plan.block_n if plan is not None
                         else 0) or fused_block_n(dtype)
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


def stream_ground(ground, dtype: str, rule: KernelRule):
    """A feature stream's evaluation set as the stream filter stores it
    (stream_plan's dtype: 'int8' per-row-quantized, else f32) → (ground,
    gscale (N,) or None, gnorm (N,) or None). gnorm: the stored rows'
    norms for a 'dist' rule on the card (stream_filter.ground_norms),
    which the slab reads every batch; None elsewhere. One call per
    evaluation set and storage (SieveStreamer keeps what it returns)."""
    gscale = None
    if dtype == "int8":
        ground, gscale = quantize_ground(ground)
        gscale = gscale.to(F32).reshape(-1).contiguous()
    ground = (ground.to(F32) if gscale is None else ground).contiguous()
    gnorm = (stream_k.ground_norms(ground, gscale)
             if ground.is_cuda and rule.pairwise == "dist" else None)
    return ground, gscale, gnorm


def stream_filter(ground, batch, rows, row0, values, counts, expos, m_max,
                  bvalid, k: int, eps_log: float, rule: KernelRule,
                  costs=None, spent=None, budget=None, gscale=None,
                  gnorm=None):
    """One batch of B arrivals against all L sieve levels — of one sieve,
    or of G stacked sieves — in ONE dispatch (the stream-filter kernels;
    their plain version on the CPU).

    Feature rules: ground (N, D) fixed evaluation set (int8 with
    ``gscale`` (1, N) or (N,) when already quantized), batch (B, D).
    Bitmap rules: ground None, batch (B, W) words (N = W). State: rows
    (L, N), values (L,), counts/expos (L,), m_max (), with a leading
    (G,) when stacked; batch/bvalid/costs may carry the same leading G
    (one batch a sieve) or not (the same batch for all). row0 (N,).
    stream_plan decides the ground's storage: 'int8' stores it
    per-row-quantized (quantized here unless ``gscale`` is given). On
    the card a level state too large for a block's shared memory runs
    the kernel's global-memory tier (the plan's 'global'); only what no
    kernel takes (bf16 ground, an unknown fold) raises. ``gnorm`` (N,):
    the stored ground's norms for a 'dist' rule on the card, given with
    the ground as `stream_ground` stores it (computed per call when not
    given; a ``gnorm`` beside a ground this call would quantize raises).
    ``costs`` (…, B) / ``spent`` (…, L) / ``budget`` switch admission to
    the knapsack rule. Returns (rows, values, counts, admits (…, L, B)
    bool, expos, m_new, expired bool) [+ spent], shaped as the state
    came."""
    stacked = rows.dim() == 3
    n = rows.shape[-1]
    b = batch.shape[-2]
    d = None if rule.is_bitmap else ground.shape[-1]
    plan = stream_plan(n, b, d, rule)
    if not rule.is_bitmap:
        if plan["dtype"] == "int8" and gscale is None:
            if gnorm is not None:
                raise ValueError("stream_filter: gnorm goes with the stored "
                                 "ground (int8 here: pass its gscale, as "
                                 "stream_ground returns them)")
            ground, gscale = quantize_ground(ground)
        ground = (ground.to(F32) if gscale is None else ground).contiguous()
        if gscale is not None:
            gscale = gscale.to(F32).reshape(-1).contiguous()

    def lanes(x, dim, dtype):
        x = x if x.dim() == dim else x.unsqueeze(0)
        return x.to(dtype).contiguous()

    st = (lanes(rows, 3, rule.dtype), lanes(values, 2, F32),
          lanes(counts, 2, torch.int32), lanes(expos, 2, torch.int32),
          lanes(m_max, 1, F32))
    arr = lanes(batch, 3, rule.dtype if rule.is_bitmap else F32)
    bv = lanes(bvalid, 2, torch.bool)
    cost_kw = {}
    if costs is not None:
        cost_kw = dict(costs=lanes(costs, 2, F32), spent=lanes(spent, 2, F32),
                       budget=float(budget))
    r0 = _cast_row(row0, rule)
    out = stream_k.stream_filter(ground, arr, *st[:1], r0, *st[1:], bv, k,
                                 eps_log, rule, gscale=gscale, gnorm=gnorm,
                                 **cost_kw)
    return out if stacked else tuple(x[0] for x in out)


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
