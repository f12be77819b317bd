"""Plain PyTorch oracles (answers `src/repro/kernels/ref.py`).

The semantic ground truth of the port's kernels and the CPU execution
path. All objective math comes from the shared rule primitives
(kernels/rules.py). Every function takes optional leading batch
dimensions: (…, N, C) matrices, (…, N) rows, (…, C) masks, (…,) scalars
— the batch of greedies that one kernel launch serves. The sieve oracles
of the reference wait for the streaming slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import rules as R
from repro_torch.kernels.rules import KernelRule

F32 = torch.float32


def pairwise(ground, cands, rule: KernelRule):
    """Full logical cached matrix for any rule: (…, N, C) f32, or the
    transposed (…, W, C) words for bitmap rules."""
    if rule.is_bitmap:
        return cands.transpose(-1, -2)
    return R.matrix_block(ground, cands, rule)


def gains(ground, row, cands, cand_valid, rule: KernelRule):
    """Per-step marginal gains: RAW part sums (…, C), −inf at invalid
    candidates."""
    mat = pairwise(ground, cands, rule)
    raw = torch.sum(R.gain_part(row.unsqueeze(-1), mat, rule), dim=-2)
    return torch.where(cand_valid, raw,
                       torch.full_like(raw, float("-inf")))


def column(mat, idx):
    """Column idx.clamp(0) of each (…, N, C) matrix → (…, N)."""
    idx = torch.as_tensor(idx, device=mat.device).clamp(min=0)
    idx = idx.reshape(idx.shape + (1, 1)).expand(mat.shape[:-1] + (1,))
    return torch.gather(mat, -1, idx).squeeze(-1)


def fused_step(mat, row, mask, prev, rule: KernelRule):
    """One greedy step over a cached matrix: fold the previous winner's
    column (deferred update), masked gain sums, first argmax. Returns
    (new_row, best (…,) int64, best_gain (…,) f32 raw part sum)."""
    new_row = R.fold_winner(row, column(mat, prev), prev, rule)
    raw = torch.sum(R.gain_part(new_row.unsqueeze(-1), mat, rule), dim=-2)
    best, gain = R.masked_argmax(raw, mask)
    return new_row, best, gain


def greedy_loop(mat, row, mask, k: int, rule: KernelRule, kq=None):
    """All k selection steps over a cached (…, N, C) matrix with the
    accept rule (finite gain > 0), mask update and final flush.

    ``kq`` (int or (…,) tensor, default k): steps ≥ kq freeze — bests
    emit −1 and gains 0 — so a k-padded call matches a solo k=kq run.
    Returns (final_row (…, N), bests (…, k) int64 with −1 for rejected
    steps, gains (…, k) f32 raw part sums)."""
    batch = mask.shape[:-1]
    dev = mask.device
    kq_ = torch.as_tensor(k if kq is None else kq, device=dev)
    kq_ = kq_.expand(batch) if kq_.dim() == 0 else kq_
    cols = torch.arange(mask.shape[-1], device=dev)
    mask = mask.to(F32)
    prev = torch.full(batch, -1, dtype=torch.int64, device=dev)
    bests, gains_ = [], []
    for s in range(k):
        row, best, gain = fused_step(mat, row, mask, prev, rule)
        live = kq_ > s
        accept = torch.isfinite(gain) & (gain > 0) & live
        best_i = torch.where(accept, best, torch.full_like(best, -1))
        hit = accept.unsqueeze(-1) & (cols == best.unsqueeze(-1))
        mask = torch.where(hit, torch.zeros_like(mask), mask)
        prev = best_i
        bests.append(best_i)
        gains_.append(torch.where(live, gain, torch.zeros_like(gain)))
    row = R.fold_winner(row, column(mat, prev), prev, rule)
    if k == 0:
        return (row, torch.zeros(batch + (0,), dtype=torch.int64,
                                 device=dev),
                torch.zeros(batch + (0,), dtype=F32, device=dev))
    return row, torch.stack(bests, -1), torch.stack(gains_, -1)
