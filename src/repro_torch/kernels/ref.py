"""Plain PyTorch oracles (answers `src/repro/kernels/ref.py`).

The semantic ground truth of the port's kernels and the CPU execution
path. All objective math comes from the shared rule primitives
(kernels/rules.py). Every function takes optional leading batch
dimensions: (…, N, C) matrices, (…, N) rows, (…, C) masks, (…,) scalars
— the batch of greedies that one kernel launch serves.

The sieve oracles (`sieve_admit`, `sieve_reanchor`, `stream_sieve`) keep
every formula as the reference writes it; their leading dimensions are
the G stacked sieves of one launch (window checkpoints, continuous
lanes). Divisions and products by the f32 eps_log go through tensors:
PyTorch computes a CUDA tensor divided by a Python number as a product
with its reciprocal, which rounds otherwise than the reference's f32
division.
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


# ---------------------------------------------------------------------------
# Sieve-Streaming (streaming/sieve.py)
# ---------------------------------------------------------------------------


def sieve_admit(gains_, values, counts, vgrid, ok, k: int, cost=None,
                spent=None, budget=None):
    """Sieve-Streaming admission (Badanidiyuru et al. 2014): admit when
    |S_l| < k and the raw gain clears (v_l/2 − f(S_l))/(k − |S_l|), and
    the gain is positive. With ``cost``/``spent``/``budget`` (knapsack
    streaming): gain ≥ thresh·c(e) with thresh = (v_l/2 − f(S_l)) /
    max(B − c(S_l), 1e-30), the element fitting the remaining budget.
    Shapes broadcast; raw units; budget an f32 tensor or number."""
    if cost is None:
        remaining = torch.clamp(k - counts, min=1).to(F32)
        thresh = (vgrid * 0.5 - values) / remaining
        return ok & (counts < k) & (gains_ >= thresh) & (gains_ > 0.0)
    budget = torch.as_tensor(budget, dtype=F32, device=spent.device)
    room = torch.clamp(budget - spent, min=0.0)
    thresh = (vgrid * 0.5 - values) / torch.clamp(room, min=1e-30)
    fits = (cost > 0.0) & (cost <= room)
    return (ok & (counts < k) & fits & (gains_ >= thresh * cost)
            & (gains_ > 0.0))


def sieve_reanchor(singletons, bvalid, rows, row0, values, counts, expos,
                   m_max, eps_log: float):
    """Slide the sieve exponent window up to the new max singleton gain,
    recycling expired levels (v < m) as fresh sieves at the exponents
    above the old window top. singletons/bvalid (…, B), rows (…, L, N),
    row0 (…, N) (broadcast), values (…, L), counts/expos (…, L) int32,
    m_max (…,). Returns (rows, values, counts, expos, m_new (…,),
    expired (…, L) bool)."""
    l = expos.shape[-1]
    dev = expos.device
    m_new = torch.maximum(m_max, torch.where(
        bvalid > 0, singletons, torch.zeros_like(singletons)).amax(-1))
    eps_t = torch.tensor(eps_log, dtype=F32, device=dev)
    low = torch.where(
        m_new > 0.0,
        torch.ceil(torch.log(torch.clamp(m_new, min=1e-30))
                   / eps_t).to(torch.int32),
        expos.amin(-1))
    # first anchor: every slot is still empty (an admitted element would
    # have set m_max > 0), so the whole window may jump — also DOWN
    first = (m_max == 0.0) & (m_new > 0.0)
    lidx = torch.arange(l, dtype=torch.int32, device=dev)
    base = torch.where(first.unsqueeze(-1), low.unsqueeze(-1) + lidx, expos)
    expired = base < low.unsqueeze(-1)
    old_high = base.amax(-1)
    # distinct exponents ⇒ expired slots rank uniquely; refill the missing
    # window exponents ascending (max() covers the full-window jump)
    rank = (expired.unsqueeze(-2)
            & (base.unsqueeze(-2) < base.unsqueeze(-1))).sum(-1).to(
                torch.int32)
    expos = torch.where(
        expired, torch.maximum(old_high + 1, low).unsqueeze(-1) + rank, base)
    rows = torch.where(expired.unsqueeze(-1),
                       row0.unsqueeze(-2).expand(rows.shape), rows)
    values = torch.where(expired, torch.zeros_like(values), values)
    counts = torch.where(expired, torch.zeros_like(counts), counts)
    return rows, values, counts, expos, m_new, expired


def stream_sieve(mat, row0, rows, values, counts, expos, m_max, bvalid,
                 k: int, eps_log: float, rule: KernelRule, costs=None,
                 spent=None, budget=None):
    """The batched sieve filter: re-anchor the exponent window on the
    batch's singleton gains, then admit arrivals IN ORDER (admitting
    arrival b changes the state arrival b+1 sees).

    mat (…, N, B) ground×arrival matrix (W words × B bitmaps for
    'bits'); row0 (…, N) empty-solution row; rows (…, L, N); values
    (…, L) raw; counts/expos (…, L) int32; m_max (…,); bvalid (…, B).
    ``costs`` (…, B) / ``spent`` (…, L) / ``budget`` switch admission to
    the knapsack rule. Returns (rows, values, counts, admits (…, L, B)
    f32 0/1, expos, m_new, expired (…, L) f32 0/1) [+ spent]."""
    b = mat.shape[-1]
    singletons = torch.sum(R.gain_part(row0.unsqueeze(-1), mat, rule),
                           dim=-2)                             # (…, B)
    rows, values, counts, expos, m_new, expired = sieve_reanchor(
        singletons, bvalid.to(F32), rows, row0, values.to(F32), counts,
        expos, m_max.to(F32), eps_log)
    eps_t = torch.tensor(eps_log, dtype=F32, device=expos.device)
    vgrid = torch.exp(expos.to(F32) * eps_t)                   # (…, L)
    cost_mode = costs is not None
    if cost_mode:
        spent = torch.where(expired, torch.zeros_like(spent),
                            spent.to(F32))
        costs = costs.to(F32)
    admits = []
    for i in range(b):
        col = mat[..., i].unsqueeze(-2)                        # (…, 1, N)
        gains_ = R.level_gains(rows, col, rule).squeeze(-1)    # (…, L)
        ok = (bvalid[..., i] > 0).unsqueeze(-1)
        if cost_mode:
            ci = costs[..., i].unsqueeze(-1)
            admit = sieve_admit(gains_, values, counts, vgrid, ok, k,
                                cost=ci, spent=spent, budget=budget)
            spent = spent + torch.where(admit, ci, torch.zeros_like(ci))
        else:
            admit = sieve_admit(gains_, values, counts, vgrid, ok, k)
        upd = R.fold_cols(rows, col, rule)
        rows = torch.where(admit.unsqueeze(-1), upd, rows)
        values = values + torch.where(admit, gains_,
                                      torch.zeros_like(gains_))
        counts = counts + admit.to(counts.dtype)
        admits.append(admit.to(F32))
    admits = (torch.stack(admits, -1) if admits
              else torch.zeros(values.shape + (0,), dtype=F32,
                               device=values.device))
    out = (rows, values, counts, admits, expos, m_new, expired.to(F32))
    return out + (spent,) if cost_mode else out
