"""Declarative kernel rules, in PyTorch (answers `src/repro/kernels/rules.py`).

The selection algebra over a ground×candidate matrix M and a per-ground-row
state r, exactly as in the reference:

    name        pairwise  fold     row          part(r, m)
    ---------   --------  ------   ----------   --------------------------
    kmedoid     dist      min      f32 mind     relu(r − m)
    facility    dot       max      f32 curmax   relu(m − r)
    coverage    bits      or       32-bit words popcount(m & ~r)
    satcover    dot       satsum   f32 cursum   min(relu(m), cap − r)
    graphcut    dot       sum      f32 cursum   Δh(r; m), h(t) = t − t²/2cap
    mmr         dot       sum      f32 cursum   λ·relu(m) + (1−λ)·Δh(r; m)

Every primitive works on tensors with any leading batch dimensions, so
the port's batched greedies (one launch for all leaves of a level) use
them unchanged.

Bitmap words: torch has no unsigned 32-bit arithmetic worth the name and
no popcount, so the port keeps each uint32 word as the same bit pattern
in an int32 tensor (`WORD_DTYPE`): 4 B a word on every device, as the
planner budgets a bitmap cache and as the CUDA kernels read it.
`to_words` narrows once, where words enter the port (a numpy uint32
array is reinterpreted without a copy). `popcount` is the SWAR bit count
on the low 32 bits, so it also takes words held in int64 (0 … 2³²−1).

Distance formulas (fault F0 of the reference, kept on purpose):
`pairwise_block` uses the ‖g‖²+‖c‖²−2⟨g,c⟩ expansion, `pairwise_col` the
direct difference — each where the reference uses it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

F32 = torch.float32
# the port's bitmap word: the bit pattern of a uint32 in an int32
WORD_DTYPE = torch.int32

# facility/satsum pad sentinel for invalid ground rows (≈ f32 max; keeps
# the per-element gain part at exactly 0)
BIG = 3.0e38

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class KernelRule:
    """Static, hashable spec of one objective's kernel math."""
    name: str            # registry key
    pairwise: str        # 'dist' | 'dot' | 'bits'
    fold: str            # 'min' | 'max' | 'or' | 'satsum' | 'sum'
    row_dtype: str       # 'float32' | 'uint32'
    row_pad: float       # pad value for ground-axis padding (0 gain)
    cap: float = 0.0     # saturation cap (satsum/sum folds only)
    lam: float = 0.0     # relevance weight λ ('sum' fold only)

    @property
    def dtype(self) -> torch.dtype:
        """Torch dtype of the state row: uint32 words live in int32."""
        return WORD_DTYPE if self.row_dtype == "uint32" else F32

    @property
    def is_bitmap(self) -> bool:
        return self.pairwise == "bits"


DIST_MIN = KernelRule("kmedoid", "dist", "min", "float32", 0.0)
DOT_MAX = KernelRule("facility", "dot", "max", "float32", BIG)
BITS_OR = KernelRule("coverage", "bits", "or", "uint32", 0.0)

_RULES = {r.name: r for r in (DIST_MIN, DOT_MAX, BITS_OR)}


@functools.lru_cache(maxsize=None)
def sat_sum(cap: float, name: str = "satcover") -> KernelRule:
    """Saturated coverage f(S) = Σ_x min(cap, Σ_{v∈S} relu⟨x, v⟩)."""
    if cap <= 0.0:
        raise ValueError("satsum needs a positive saturation cap")
    return KernelRule(name, "dot", "satsum", "float32", float(cap),
                      cap=float(cap))


@functools.lru_cache(maxsize=None)
def graph_cut(alpha: float, name: str = "graphcut") -> KernelRule:
    """Graph-cut potential h(t) = t − α·t²/2 clipped at its vertex 1/α."""
    if alpha <= 0.0:
        raise ValueError("graph-cut needs a positive redundancy weight")
    return KernelRule(name, "dot", "sum", "float32", BIG,
                      cap=1.0 / float(alpha))


@functools.lru_cache(maxsize=None)
def mmr(lam: float, theta: float, name: str = "mmr") -> KernelRule:
    """MMR relevance–diversity potential λ·t + (1−λ)·h(t ∧ θ)."""
    if not 0.0 <= lam <= 1.0:
        raise ValueError("MMR λ must lie in [0, 1]")
    if theta <= 0.0:
        raise ValueError("MMR needs a positive saturation cap θ")
    return KernelRule(name, "dot", "sum", "float32", BIG,
                      cap=float(theta), lam=float(lam))


def get(name: str) -> KernelRule:
    """Look up a built-in rule by objective name."""
    return _RULES[name]


# ---------------------------------------------------------------------------
# 32-bit words in int32
# ---------------------------------------------------------------------------


def to_words(x) -> torch.Tensor:
    """uint32 bitmap words → an int32 tensor of the same bit patterns (on
    the input's device; the caller places it). A numpy uint32 array is
    reinterpreted in place (no copy); int64 words 2³¹ … 2³²−1 wrap to
    their negative int32 pattern; int32 passes through."""
    if isinstance(x, torch.Tensor):
        if x.dtype == WORD_DTYPE:
            return x
        if x.dtype == torch.uint32:
            return x.view(WORD_DTYPE)
        x = x.to(torch.int64)
        return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(WORD_DTYPE)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a.view(np.int32))
    return to_words(torch.as_tensor(a))


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits among the low 32 bits of each word (int32 patterns, or
    int64 holding 0 … 2³²−1) → the input's dtype. The SWAR count: bit
    pairs, nibbles, bytes, then the byte sum; every mask clears what an
    arithmetic shift drags in from above bit 31."""
    x = words >> 1
    x &= 0x55555555
    x = words - x
    y = x >> 2
    y &= 0x33333333
    x &= 0x33333333
    x += y
    x += x >> 4
    x &= 0x0F0F0F0F
    x += x >> 8
    x += x >> 16
    return x & 0x3F


# ---------------------------------------------------------------------------
# the shared selection algebra
# ---------------------------------------------------------------------------


def gain_part(row, m, rule: KernelRule):
    """Per-element marginal-gain contribution part(r, M), broadcast over
    any orientation (row along the ground axis, m the matrix slab)."""
    if rule.fold == "min":
        return torch.clamp(row - m.to(F32), min=0.0)
    if rule.fold == "max":
        return torch.clamp(m.to(F32) - row, min=0.0)
    if rule.fold == "satsum":
        return torch.minimum(torch.clamp(m.to(F32), min=0.0),
                             rule.cap - row)
    if rule.fold == "sum":
        inc = torch.clamp(m.to(F32), min=0.0)
        mod = torch.clamp(row + inc, max=BIG) - torch.clamp(row, max=BIG)
        t0 = torch.clamp(row, max=rule.cap)
        t1 = torch.clamp(row + inc, max=rule.cap)
        sat = (t1 - t0) - (t1 * t1 - t0 * t0) / (2.0 * rule.cap)
        return rule.lam * mod + (1.0 - rule.lam) * sat
    if rule.fold == "or":
        return popcount(m & torch.bitwise_not(row)).to(F32)
    raise KeyError(rule.fold)


def fold_cols(row, col, rule: KernelRule):
    """State-row fold: absorb one matrix column (an accepted element)."""
    if rule.fold == "min":
        return torch.minimum(row, col.to(F32))
    if rule.fold == "max":
        return torch.maximum(row, col.to(F32))
    if rule.fold == "satsum":
        return torch.clamp(row + torch.clamp(col.to(F32), min=0.0),
                           max=rule.cap)
    if rule.fold == "sum":
        return row + torch.clamp(col.to(F32), min=0.0)
    if rule.fold == "or":
        return torch.bitwise_or(row, col)
    raise KeyError(rule.fold)


def fold_winner(row, col, prev, rule: KernelRule):
    """Deferred update: fold the previous winner's column into the state
    row; prev < 0 (no accepted winner yet) is a no-op. ``prev`` may be a
    per-batch tensor (…,) broadcast against row (…, N)."""
    prev = torch.as_tensor(prev, device=row.device)
    keep = (prev >= 0).reshape(prev.shape + (1,) * (row.dim()
                                                    - prev.dim()))
    return torch.where(keep, fold_cols(row, col, rule), row)


def partial_gains(row, m, rule: KernelRule):
    """(…, 1, BN) state row × (…, BN, C) matrix block → (…, 1, C)."""
    return torch.sum(gain_part(row.transpose(-1, -2), m, rule), dim=-2,
                     keepdim=True)


def level_gains(rows, col, rule: KernelRule):
    """(…, L, N) per-level state rows × (…, 1, N) arrival column →
    (…, L, 1) raw gains — the level-batched transpose of
    `partial_gains` (the sieve's admission step)."""
    return torch.sum(gain_part(rows, col, rule), dim=-1, keepdim=True)


def masked_argmax(gains, mask):
    """(…, C) gains + 0/1 mask → (first argmax (…,) int64, max (…,) f32).

    First-max tie-break over −inf-masked gains, exactly as the
    reference: the smallest column index whose gain equals the maximum
    (index 0 when every column is masked)."""
    g = torch.where(mask > 0, gains,
                    torch.full_like(gains, _NEG_INF, dtype=F32))
    mx = torch.amax(g, dim=-1, keepdim=True)
    cols = torch.arange(g.shape[-1], device=g.device).expand(g.shape)
    first = torch.where(g == mx, cols,
                        torch.full_like(cols, 2 ** 30)).amin(dim=-1)
    return first, mx.squeeze(-1)


# ---------------------------------------------------------------------------
# int8 quantized storage (per-row f32 scale, f32 rescale-accumulate)
# ---------------------------------------------------------------------------

_QMAX = 127.0


def cache_itemsize(dtype: str) -> int:
    """Bytes per cached-matrix entry for a storage dtype name."""
    return {"float32": 4, "uint32": 4, "bfloat16": 2, "int8": 1}[dtype]


def quantize_rows(mat, out=None):
    """(…, N, C) f32 → (q int8 (…, N, C), scale f32 (…, 1, N)) with a
    symmetric per-row scale; all-zero rows get scale 1.

    Both divisions divide by a tensor: on CUDA tensors PyTorch computes a
    division by a Python number as a product with its reciprocal, which
    rounds otherwise than the IEEE division of the CPU, the reference and
    the resident kernel's rounding phase. With ``out`` (an int8 tensor of
    the matrix's shape: a chunked cache build's slice) q is written into
    it and an f32 input is the work buffer, overwritten: the same bits
    with no transient beyond the input itself."""
    m = mat.to(F32)
    # max |m| without an |m| temporary
    amax = torch.maximum(m.amax(-1, keepdim=True), -m.amin(-1, keepdim=True))
    scale = torch.where(amax > 0.0, amax / amax.new_tensor(_QMAX),
                        torch.ones_like(amax))
    t = m / scale if out is None else m.div_(scale)
    t.round_().clamp_(-_QMAX, _QMAX)
    q = t.to(torch.int8) if out is None else out.copy_(t)
    return q, scale.transpose(-1, -2)


def dequant(q, scale):
    """(…, N, C) int8 + (…, 1, N) per-row scale → (…, N, C) f32."""
    return q.to(F32) * scale.transpose(-1, -2)


def logical(mat, scale=None):
    """A cached matrix's f32 values: an int8 `mat` with its (…, 1, N)
    row scales dequantized, bf16 widened (exactly); f32 matrices and
    bitmap words pass through."""
    if scale is not None:
        return dequant(mat, scale)
    return mat.to(F32) if mat.dtype == torch.bfloat16 else mat


# ---------------------------------------------------------------------------
# matrix construction
# ---------------------------------------------------------------------------


def pairwise_block(g, c, mode: str):
    """(…, TN, D) × (…, TC, D) feature blocks → (…, TN, TC) f32.

    The ‖g‖²+‖c‖²−2⟨g,c⟩ expansion of the reference. This is plain
    PyTorch (one `torch.matmul`): the CUDA kernel in kernels/pairwise.py
    computes the same function with its own fp32 FMA tiles."""
    cross = torch.matmul(g, c.transpose(-1, -2))
    if mode == "dot":
        return cross
    gn = torch.sum(g * g, dim=-1, keepdim=True)                # (…, TN, 1)
    cn = torch.sum(c * c, dim=-1, keepdim=True).transpose(-1, -2)
    return torch.sqrt(torch.clamp(gn + cn - 2.0 * cross, min=0.0))


def matrix_block(g, c, rule: KernelRule):
    """Matrix slab in ground-major (…, N|W, C) orientation; for 'bits'
    the candidate bitmaps ARE the columns (one transpose)."""
    if rule.is_bitmap:
        return c.transpose(-1, -2)
    return pairwise_block(g.to(F32), c.to(F32), rule.pairwise)


# ---------------------------------------------------------------------------
# per-step (uncached) state math
# ---------------------------------------------------------------------------


# elements of one temporary of the direct difference (1 GiB of f32)
COL_CHUNK_ELEMS = 2 ** 28


def pairwise_col(ground, payload, rule: KernelRule):
    """One candidate's matrix column M[:, c] against the ground set: the
    direct difference for 'dist' (not the expansion — F0). ground
    (…, N, D), payload (…, D) → (…, N). The difference is taken over
    slices of ground rows, each temporary at most COL_CHUNK_ELEMS: whole,
    it would be as large as the ground set (4.9 GB at the Tiny-ImageNet
    leaf shape) on every step."""
    if rule.is_bitmap:
        return payload
    g = ground.to(F32)
    p = payload.to(F32)
    if rule.pairwise != "dist":
        return torch.matmul(g, p.unsqueeze(-1)).squeeze(-1)
    p = p.unsqueeze(-2)
    n = g.shape[-2]
    rows = max(1, COL_CHUNK_ELEMS // max(1, g.numel() // max(1, n)))
    return torch.cat([
        torch.sqrt(torch.clamp(torch.sum((g[..., i:i + rows, :] - p) ** 2,
                                         dim=-1), min=0.0))
        for i in range(0, max(n, 1), rows)], dim=-1)


def update_row(ground, row, payload, rule: KernelRule):
    """Per-step state update after accepting `payload`."""
    return fold_cols(row, pairwise_col(ground, payload, rule), rule)


def empty_row(ground, ground_valid, rule: KernelRule, words: int = 0,
              batch: tuple = (), device=None):
    """State row of the EMPTY solution: the fold identity per ground row,
    invalid rows pinned at the zero-gain pad value. 'min' uses the
    paper's auxiliary element e0 = 0 (row = ‖x‖); 'bits' rows are
    all-clear words of shape batch + (words,)."""
    if rule.is_bitmap:
        return torch.zeros(tuple(batch) + (words,), dtype=WORD_DTYPE,
                           device=device)
    pad = torch.tensor(rule.row_pad, dtype=F32, device=ground.device)
    if rule.fold == "min":
        d0 = torch.linalg.vector_norm(ground.to(F32), dim=-1)
        return torch.where(ground_valid, d0, pad)
    zero = torch.zeros(ground.shape[:-1], dtype=F32, device=ground.device)
    return torch.where(ground_valid, zero, pad)
