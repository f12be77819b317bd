"""How a kernel is held against its plain version (used by the CUDA tests
and by chip_smoke.py).

Pairwise matrices are held against a float64 build of the same function
('dist' in squared form, where the square root amplifies rounding near
zero): the kernel's error from float64 may be at most a small multiple of
the plain f32 version's own error from float64, in root-mean-square and in
the largest entry (`compare_pairwise`). An fp32 kernel that sums in
another order lands near ratio 1; TF32 products or a dropped slice of
features land far above it, and chip_smoke.py shows on the card that
they fail the rule. The per-step gains (`compare_gains`) are held the same
way: gain sums against a float64 build of matrix, gain parts and sums.

A fused step (`compare_steps`) is fed the plain matrix: the folded rows
must be equal bit for bit (one f32 min, max or add per entry, the same in
both), the chosen gain within the reordering bound below, and the chosen
column equal unless the plain gains of the two choices lie within that
bound of each other (a tie decided by rounding).

Bitmap kernels (`compare_exact`): their gains are integer popcount sums,
exact in f32 on both sides, and both take the first index among equal
gains, so every output — rows, bests, raw gains — must be equal bit for
bit, with no tie allowance (integer gains tie often).

The bf16/int8 cache storage is held bit for bit too (`compare_exact`),
against what runs the same arithmetic, not against a plain version:
  * pairwise with bf16 output against the f32 kernel's output rounded to
    bf16 (torch's .to(torch.bfloat16), nearest even): the same tiles,
    another store;
  * an int8 cache built on the card in chunks against rules.quantize_rows
    of the whole f32 kernel output on the CPU, q and scales: per-row
    scales do not see the chunks, and both divide in IEEE f32;
  * fused_step and the streaming loop over a bf16/int8 cache against the
    f32 kernel over the dequantized cache (rules.logical): each entry is
    widened to the same f32 value (bf16 exactly, int8 by one f32
    product) before the same operations in the same order;
  * the resident loop's scratch under a bf16/int8 plan against
    greedy_loop.resident_matrix's rounding of the kernel's own f32 build.
Beside these the variants are held to their plain versions by the rules
above (float64 ratio, entry bounds, reordering).

The stream filter (`compare_stream`, B6 on feature rules) is held over
one batch fed the same state on both sides: its matrix slab by the
float64 pairwise rule above; its decisions walked in arrival order along
the plain version's path, in float64. `admits`, `counts`, `expos` and
`expired` must be equal, except at a decision whose float64 gain lies
within the bound below of its threshold (or of 0, the `gain > 0`
conjunct): that level is not compared further (as `compare_loops`
stops at a tie). A gain moves by the reordering bound, by its column's
Σ_n ΔM and by the summed row error; the threshold moves through f(S),
which carries every earlier admitted gain's bound, and by f32 rounding
of exp, the halving and the division (4 eps each, widened). A window
whose exponent ⌈log(m)/eps_log⌉ differs is accepted only when an
integer lies between the exponents of the two m's bounds (a tie of the
re-anchor), and that sieve is not compared further. Where all agree,
rows, values and m are held to the derived bounds, spent bit for bit.
The bitmap variant is held by `compare_exact`, and the int8-ground one
bit for bit against the f32 kernel on the dequantized ground.

Loops: selections must be equal step for step. At the first step where
two greedies differ, the comparison passes only if the two chosen gains
at that step lie within the stated float tolerance of each other — a
genuine tie, decided by rounding — and later steps are not compared.
Where all steps agree, gains and final rows are held to the tolerance.
The tolerances are derived from f32 rounding, never fitted:
  * a gain is a sum of N nonnegative parts; summed in another order it
    moves by ~√N·eps·gain, held to 4·√N·eps·gain (`gain_rtol`);
  * when the two versions also built their matrices apart, with entry
    differences ΔM (B, N, C), every feature rule's gain part moves by at
    most |Δr| + |Δm| (it is 1-Lipschitz in the row r and the entry m).
    So candidate c's gain moves by Σ_i ΔM[i, c] plus the summed row
    error, and a row entry by the ΔM of the folded winners — their
    largest for the min/max folds, their sum for the additive ones.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.rules import BIG, KernelRule, gain_part

EPS32 = float(np.finfo(np.float32).eps)
TINY32 = float(np.finfo(np.float32).tiny)

# a kernel's error from float64 may be at most this multiple of the plain
# f32 version's: its RMS error (a stable statistic over ~10⁵–10⁷ entries)
# and its largest entry error (noisier: the worst of many entries)
PAIRWISE_RMS_RATIO = 1.5
PAIRWISE_MAX_RATIO = 2.0


def sq_dist_bound(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Worst-case per-entry rounding bound of the squared 'dist' expansion
    of (…, N, D) × (…, C, D) in f32: 4·D·eps·(‖g‖²+‖c‖²+2‖g‖‖c‖)."""
    gn = (g.double() ** 2).sum(-1).unsqueeze(-1)
    cn = (c.double() ** 2).sum(-1).unsqueeze(-2)
    return 4 * g.shape[-1] * EPS32 * (gn + cn + 2 * (gn * cn).sqrt())


def exact_matrix(g: torch.Tensor, c: torch.Tensor, mode: str):
    """The pairwise function in float64: ⟨g, c⟩ for 'dot', the SQUARED
    distance for 'dist'."""
    g64, c64 = g.double(), c.double()
    cross = torch.matmul(g64, c64.transpose(-1, -2))
    if mode == "dot":
        return cross
    gn = (g64 * g64).sum(-1, keepdim=True)
    cn = (c64 * c64).sum(-1).unsqueeze(-2)
    return torch.clamp(gn + cn - 2.0 * cross, min=0.0)


def matrix_error(mat: torch.Tensor, exact: torch.Tensor, mode: str):
    """Per-entry |mat − exact| (squared form for 'dist'), float64."""
    m = mat.double()
    return ((m * m if mode == "dist" else m) - exact).abs()


def pairwise_stats(got, plain, exact, mode: str) -> Dict[str, float]:
    """Errors of `got` and `plain` from `exact` (exact_matrix) and their
    ratios."""
    return _ratio_stats(matrix_error(got, exact, mode),
                        matrix_error(plain, exact, mode), exact)


def _ratio_stats(e_k, e_p, exact) -> Dict[str, float]:
    """RMS and largest errors of a kernel (e_k) and its plain version
    (e_p) and their ratios. A floor of one f32 rounding of the largest
    exact value (at least the least normal f32) keeps exact inputs (both
    errors 0) from dividing by zero."""
    floor = max(EPS32 * float(exact.abs().max()) if exact.numel() else 0.0,
                TINY32)
    rms_k = float(e_k.pow(2).mean().sqrt())
    rms_p = float(e_p.pow(2).mean().sqrt())
    max_k, max_p = float(e_k.max()), float(e_p.max())
    return {"rms": rms_k, "plain_rms": rms_p,
            "rms_ratio": rms_k / max(rms_p, floor),
            "max": max_k, "plain_max": max_p,
            "max_ratio": max_k / max(max_p, floor)}


def pairwise_holds(stats: Dict[str, float]) -> bool:
    """The float64 ratio rule, for pairwise matrices and per-step gains."""
    return (stats["rms_ratio"] <= PAIRWISE_RMS_RATIO
            and stats["max_ratio"] <= PAIRWISE_MAX_RATIO)


def compare_pairwise(got, plain, g, c, mode: str,
                     what: str = "pairwise") -> Dict[str, float]:
    """Hold a pairwise kernel's (…, N, C) output against the plain
    version's on the same features g (…, N, D), c (…, C, D). Returns the
    stats; raises AssertionError when the kernel's error from float64
    exceeds the stated multiples of the plain version's."""
    stats = pairwise_stats(got, plain, exact_matrix(g, c, mode), mode)
    assert pairwise_holds(stats), (
        f"{what} {mode}: error from float64 is {stats['rms_ratio']:.3f}× "
        f"(RMS) / {stats['max_ratio']:.3f}× (max) the plain f32 "
        f"version's, beyond {PAIRWISE_RMS_RATIO}× / {PAIRWISE_MAX_RATIO}×")
    return stats


def _gain_part64(row, m, rule: KernelRule):
    """rules.gain_part in float64 (feature rules)."""
    if rule.fold == "min":
        return torch.clamp(row - m, min=0.0)
    if rule.fold == "max":
        return torch.clamp(m - row, min=0.0)
    if rule.fold == "satsum":
        return torch.minimum(torch.clamp(m, min=0.0), rule.cap - row)
    if rule.fold == "sum":
        inc = torch.clamp(m, min=0.0)
        mod = torch.clamp(row + inc, max=BIG) - torch.clamp(row, max=BIG)
        t0 = torch.clamp(row, max=rule.cap)
        t1 = torch.clamp(row + inc, max=rule.cap)
        sat = (t1 - t0) - (t1 * t1 - t0 * t0) / (2.0 * rule.cap)
        return rule.lam * mod + (1.0 - rule.lam) * sat
    raise KeyError(rule.fold)


def exact_gains(ground, row, cands, rule: KernelRule):
    """Raw gain sums (B, C) in float64 of ground (B, N, D), row (B, N),
    cands (B, C, D): matrix, gain parts and sums in float64 (one greedy
    at a time, to bound the temporaries)."""
    out = []
    for b in range(ground.shape[0]):
        m = exact_matrix(ground[b], cands[b], rule.pairwise)
        if rule.pairwise == "dist":
            m = m.sqrt()
        out.append(_gain_part64(row[b].double().unsqueeze(-1), m,
                                rule).sum(-2))
    return torch.stack(out)


def gains_stats(got, plain, exact) -> Dict[str, float]:
    """Errors of gain sums `got` and `plain` (B, C), −inf at the same
    invalid candidates, from `exact` (exact_gains) and their ratios."""
    fin = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(got), fin), "masks differ"
    ex = exact.to(got.device)[fin]
    return _ratio_stats((got[fin].double() - ex).abs(),
                        (plain[fin].double() - ex).abs(), ex)


def compare_gains(got, plain, ground, row, cands, rule: KernelRule,
                  what: str = "gains") -> Dict[str, float]:
    """Hold a gains kernel's (B, C) output against the plain version's on
    the same inputs under the float64 ratio rule. Returns the stats;
    raises AssertionError when the kernel's error from float64 exceeds
    the stated multiples of the plain version's."""
    stats = gains_stats(got, plain, exact_gains(ground, row, cands, rule))
    assert pairwise_holds(stats), (
        f"{what} {rule.name}: error from float64 is "
        f"{stats['rms_ratio']:.3f}× (RMS) / {stats['max_ratio']:.3f}× (max) "
        f"the plain f32 version's, beyond {PAIRWISE_RMS_RATIO}× / "
        f"{PAIRWISE_MAX_RATIO}×")
    return stats


def gain_rtol(n_rows: int) -> float:
    """Relative bound of a reordered f32 sum of n_rows nonnegative parts.
    Its rounding errors take independent signs, so the sum moves by about
    0.2·√N·eps·gain (one standard deviation of a sequential sum, the
    worst order either version uses); 4·√N·eps is some 20 of them, where
    the worst case N·eps would let a dropped part (gain/N) through."""
    return 4.0 * max(1, n_rows) ** 0.5 * EPS32


def compare_loops(kern, plain, rule: KernelRule,
                  entry_diff: Optional[torch.Tensor] = None,
                  what: str = "loop") -> Dict[str, float]:
    """Hold one loop kernel's (rows (B, N), bests (B, k), gains (B, k))
    against its plain version's. `entry_diff` (B, N, C) is |M_kernel −
    M_plain| when the two built their matrices apart; None when both ran
    over the same matrix. Returns a summary (ties met, the earliest step
    a tie split a greedy — k when none did — the largest gain and row
    differences and the largest gain tolerance used); raises
    AssertionError when a greedy disagrees beyond a genuine tie."""
    rows_k, bests_k, gains_k = (t.detach().double().cpu() for t in kern)
    rows_p, bests_p, gains_p = (t.detach().double().cpu() for t in plain)
    nb, n = rows_p.shape
    k = bests_p.shape[-1]
    rt = gain_rtol(n)
    additive = rule.fold in ("satsum", "sum")
    dm = None if entry_diff is None else entry_diff.detach().double().cpu()
    ties, first_tie = 0, k
    max_gain_err = max_row_err = max_gain_tol = 0.0
    for b in range(nb):
        diff = (bests_k[b] != bests_p[b]).nonzero()
        upto = int(diff[0]) if len(diff) else k
        steps = upto + (upto < k)
        # the entry-difference part of each compared step's gain bound
        atol = torch.zeros(steps, dtype=torch.float64)
        rowerr = torch.zeros(n, dtype=torch.float64)
        if dm is not None:
            colsum = dm[b].sum(0)
            for t in range(steps):
                cols = [int(bests_k[b, t]), int(bests_p[b, t])]
                col = max(float(colsum[j]) if j >= 0 else float(colsum.max())
                          for j in cols)
                atol[t] = col + float(rowerr.sum())
                s = int(bests_p[b, t])
                if t < upto and s >= 0:
                    rowerr = (rowerr + dm[b, :, s] if additive
                              else torch.maximum(rowerr, dm[b, :, s]))
        gk, gp = gains_k[b, :steps], gains_p[b, :steps]
        fin = torch.isfinite(gp)
        assert torch.equal(torch.isfinite(gk), fin), (what, b, gk, gp)
        err = (gk[fin] - gp[fin]).abs()
        tol = rt * gp[fin].abs() + atol[fin] + 1e-30
        assert bool((err <= tol).all()), (
            f"{what}, greedy {b}: gains differ by up to "
            f"{float(err.max()):.3e}, beyond {rt:.2e}·|g| + the entry "
            f"bound (first differing step {upto})")
        if err.numel():
            max_gain_err = max(max_gain_err, float(err.max()))
            max_gain_tol = max(max_gain_tol, float(tol.max()))
        if upto < k:
            ties += 1
            first_tie = min(first_tie, upto)
            continue
        fr = torch.isfinite(rows_p[b])
        rerr = (rows_k[b][fr] - rows_p[b][fr]).abs()
        # additive folds round once more per accepted winner
        folds = int((bests_p[b] >= 0).sum()) if additive and dm is not None \
            else 0
        row_tol = (4 + folds) * EPS32 * rows_p[b][fr].abs() + rowerr[fr] \
            + 1e-30
        assert bool((rerr <= row_tol).all()), \
            f"{what}, greedy {b}: rows differ by up to {float(rerr.max())}"
        assert torch.equal(rows_k[b][~fr], rows_p[b][~fr])
        if rerr.numel():
            max_row_err = max(max_row_err, float(rerr.max()))
    return {"ties": ties, "first_tie_step": first_tie,
            "max_gain_err": max_gain_err, "max_gain_tol": max_gain_tol,
            "max_row_err": max_row_err}


def compare_steps(kern, plain, mat, mask, rule: KernelRule,
                  what: str = "fused_step") -> Dict[str, float]:
    """Hold a fused step's (new_row (B, N), best (B,), gain (B,)) against
    its plain version's over the same matrix mat (B, N, C) and mask
    (B, C). Returns the largest gain difference, the tolerance it met and
    the number of greedies whose choices split at a tie; raises
    AssertionError otherwise."""
    rows_k, best_k, gain_k = kern
    rows_p, best_p, gain_p = plain
    assert torch.equal(rows_k, rows_p), f"{what}: folded rows differ"
    rt = gain_rtol(mat.shape[-2])
    gk, gp = gain_k.double().cpu(), gain_p.double().cpu()
    fin = torch.isfinite(gp)
    assert torch.equal(torch.isfinite(gk), fin), (what, gk, gp)
    err = (gk[fin] - gp[fin]).abs()
    tol = rt * gp[fin].abs() + 1e-30
    assert bool((err <= tol).all()), (
        f"{what}: gains differ by up to {float(err.max()):.3e}, beyond "
        f"{rt:.2e}·|g|")
    ties = 0
    split = (best_k != best_p).nonzero().flatten().tolist()
    if split:
        raw = torch.sum(gain_part(rows_p.unsqueeze(-1), mat, rule), dim=-2)
        for b in split:
            a, c = int(best_k[b]), int(best_p[b])
            assert bool(mask[b, a] > 0), f"{what}, greedy {b}: masked pick"
            ga, gc = float(raw[b, a]), float(raw[b, c])
            assert abs(ga - gc) <= rt * max(abs(ga), abs(gc)), (
                f"{what}, greedy {b}: picks {a} ({ga}) and {c} ({gc}) "
                "are no tie")
            ties += 1
    return {"max_gain_err": float(err.max()) if err.numel() else 0.0,
            "max_gain_tol": float(tol.max()) if tol.numel() else 0.0,
            "ties": ties}


def compare_exact(kern, plain, what: str = "bitmap kernel"
                  ) -> Dict[str, float]:
    """Hold a kernel's outputs (a tensor or a tuple: rows, bests, gains)
    against another's: equal shapes and dtypes and equal bit patterns
    (floats compared as their 16- or 32-bit words, so −inf, 0 and −0 are
    told apart). Returns the entries compared, the entries that
    differ, the largest |kernel − plain| over the float outputs (0 where
    the bits agree, inf where only one side is finite) and, for a loop's
    (B, k) bests, the accepted steps; raises AssertionError when any
    entry differs."""
    kern = kern if isinstance(kern, tuple) else (kern,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert len(kern) == len(plain), what
    entries, differing, err = 0, 0, 0.0
    for i, (k, p) in enumerate(zip(kern, plain)):
        k, p = k.detach().cpu(), p.detach().cpu()
        assert k.shape == p.shape and k.dtype == p.dtype, (
            f"{what}, output {i}: {k.dtype}{tuple(k.shape)} vs "
            f"{p.dtype}{tuple(p.shape)}")
        if k.is_floating_point():
            word = {2: torch.int16, 4: torch.int32}[k.element_size()]
            same = k.view(word) == p.view(word)
            diff = (k.double() - p.double()).abs().nan_to_num(nan=math.inf)
            diff = torch.where(same, torch.zeros_like(diff), diff)
            if diff.numel():
                err = max(err, float(diff.max()))
        else:
            same = k == p
        bad = int((~same).sum())
        differing += bad
        entries += k.numel()
        assert bad == 0, f"{what}, output {i}: {bad} entries differ"
    out = {"entries": entries, "differing": differing, "max_abs_err": err}
    if len(plain) == 3 and plain[1].dim() == 2:
        out["accepted"] = int((plain[1] >= 0).sum())
    return out


def compare_stream(kern, plain, mat_k, mat_p, state, bvalid, k: int,
                   eps_log: float, rule: KernelRule, costs=None,
                   budget=None, what: str = "stream_filter"
                   ) -> Dict[str, float]:
    """Hold a feature rule's stream-filter outputs against the plain
    version's over the same inputs (module doc). kern/plain: (rows (G, L,
    N), values, counts, admits (G, L, B) bool, expos, m_new (G,),
    expired[, spent]); mat_k (A, B, N) the kernel's slab, mat_p (A, N, B)
    the plain matrix; state = (rows, row0, values, counts, expos, m_max,
    spent or None) as fed to both; bvalid (A, B); costs (A, B) and
    budget in cost mode. Returns the compared decisions, the ties (level
    decisions and windows) and the largest errors; raises AssertionError
    where a difference is no tie."""
    rows_in, row0, values_in, counts_in, expos_in, m_in, spent_in = state
    g_n, l_n, n = rows_in.shape
    a_n, _, b_n = mat_p.shape
    cost_mode = costs is not None
    dev = mat_p.device
    rt = gain_rtol(n)
    eps32 = float(torch.tensor(eps_log, dtype=torch.float32))
    additive = rule.fold in ("satsum", "sum")
    mp = mat_p.double()                                        # (A, N, B)
    dm = (mat_k.transpose(-1, -2).double() - mp).abs()         # (A, N, B)
    colsum = dm.sum(-2)                                        # (A, B)
    lane = torch.arange(g_n, device=dev) if a_n > 1 else torch.zeros(
        g_n, dtype=torch.int64, device=dev)
    # m: the max valid singleton, each within its bound
    single = _gain_part64(row0.double()[None, :, None], mp, rule).sum(-2)
    s_err = rt * single + colsum
    valid = bvalid.bool()
    m_err = torch.where(valid, s_err, torch.zeros_like(s_err)).amax(-1)
    m_k, m_p = kern[5].double(), plain[5].double()
    m_tol = m_err[lane] + EPS32 * m_p.abs() + 1e-30
    assert bool(((m_k - m_p).abs() <= m_tol).all()), (
        f"{what}: m differs by {float((m_k - m_p).abs().max()):.3e}")
    # the window: equal, or a tie of the re-anchor's ceil
    win_ok = (kern[4] == plain[4]).all(-1) & (kern[6] == plain[6]).all(-1)
    window_ties = 0
    for g in (~win_ok).nonzero().flatten().tolist():
        lo = max(float(m_p[g] - m_tol[g]), 1e-30)
        hi = float(m_p[g] + m_tol[g])
        x0, x1 = (math.log(lo) / eps32 * (1 - 1e-6),
                  math.log(hi) / eps32 * (1 + 1e-6))
        x0, x1 = min(x0, x1), max(x0, x1)
        assert math.floor(x1) >= math.ceil(x0) or float(m_in[g]) == 0.0, (
            f"{what}, sieve {g}: the window differs and no integer lies "
            f"between {x0} and {x1}")
        window_ties += 1
    active = win_ok.unsqueeze(-1).expand(g_n, l_n).clone()
    # walk the plain version's path in float64
    expired = plain[6]
    rows64 = torch.where(expired.unsqueeze(-1), row0.double(),
                         rows_in.double())
    f64 = torch.where(expired, 0.0, values_in.double())
    cnt = torch.where(expired, 0, counts_in.to(torch.int64))
    spent = (torch.where(expired, 0.0, spent_in.double()) if cost_mode
             else None)
    vgrid = torch.exp(plain[4].double() * eps32)
    rowerr = torch.zeros_like(rows64)
    ferr = torch.zeros_like(f64)
    ties = decisions = 0
    adm_k, adm_p = kern[3], plain[3]
    for b in range(b_n):
        col = mp[lane, :, b].unsqueeze(1)                      # (G, 1, N)
        ok = valid[lane, b].unsqueeze(-1) & (cnt < k)
        c = 1.0
        if cost_mode:
            c = costs[lane, b].double().unsqueeze(-1)
            room = torch.clamp(float(budget) - spent, min=0.0)
            ok = ok & (c > 0) & (c <= room)
            rem = torch.clamp(room, min=1e-30)
        else:
            rem = torch.clamp(k - cnt, min=1).double()
        live = ok & active
        decisions += int(live.sum())
        g64 = _gain_part64(rows64, col, rule).sum(-1)          # (G, L)
        thresh = (vgrid * 0.5 - f64) / rem * c
        gerr = rt * g64 + colsum[lane, b].unsqueeze(-1) + rowerr.sum(-1)
        tol = (gerr + ferr / rem * c
               + 4 * EPS32 * (g64.abs() + thresh.abs() + vgrid / rem * c)
               + 1e-30)
        pa, ka = adm_p[..., b], adm_k[..., b]
        differ = (pa != ka) & active
        tie = differ & (torch.minimum((g64 - thresh).abs(), g64.abs())
                        <= tol)
        bad = differ & ~tie
        assert not bool(bad.any()), (
            f"{what}: arrival {b} decided apart at {bad.nonzero().tolist()} "
            "with no tie")
        ties += int(tie.sum())
        active &= ~tie
        take = pa & active
        upd = take.unsqueeze(-1)
        new_rows = _fold64(rows64, col, rule)
        rows64 = torch.where(upd, new_rows, rows64)
        dcol = dm[lane, :, b].unsqueeze(1)
        rowerr = torch.where(upd, rowerr + dcol + EPS32 * new_rows.abs()
                             if additive else torch.maximum(rowerr, dcol),
                             rowerr)
        f64 = f64 + torch.where(take, g64, 0.0)
        ferr = ferr + torch.where(take, gerr, 0.0)
        cnt = cnt + take.to(torch.int64)
        if cost_mode:
            spent = spent + torch.where(take, c, 0.0)
    # where every decision agreed: counts, rows, values (and spent)
    act = active
    assert torch.equal(kern[2][act], plain[2][act]), f"{what}: counts"
    rk, rp = kern[0][act].double(), plain[0][act].double()
    fin = torch.isfinite(rp)
    row_tol = rowerr[act] + 4 * EPS32 * rp.abs() + 1e-30
    rerr = (rk - rp).abs()
    assert bool((rerr[fin] <= row_tol[fin]).all()), (
        f"{what}: rows differ by up to {float(rerr[fin].max()):.3e}")
    assert torch.equal(rk[~fin], rp[~fin]), f"{what}: non-finite rows"
    vk, vp = kern[1][act].double(), plain[1][act].double()
    verr = (vk - vp).abs()
    v_tol = ferr[act] + 4 * EPS32 * (cnt[act] + 1) * vp.abs() + 1e-30
    assert bool((verr <= v_tol).all()), (
        f"{what}: values differ by up to {float(verr.max()):.3e}")
    if cost_mode:
        assert torch.equal(kern[7][act], plain[7][act]), f"{what}: spent"
    return {"decisions": decisions, "ties": ties,
            "window_ties": window_ties,
            "admitted": int(plain[3].sum()),
            "max_m_err": float((m_k - m_p).abs().max()),
            "max_value_err": float(verr.max()) if verr.numel() else 0.0,
            "max_row_err": float(rerr[fin].max()) if fin.any() else 0.0,
            "max_matrix_diff": float(dm.max())}


def _fold64(row, col, rule: KernelRule):
    """rules.fold_cols in float64 (feature rules)."""
    if rule.fold == "min":
        return torch.minimum(row, col)
    if rule.fold == "max":
        return torch.maximum(row, col)
    if rule.fold == "satsum":
        return torch.clamp(row + torch.clamp(col, min=0.0), max=rule.cap)
    if rule.fold == "sum":
        return row + torch.clamp(col, min=0.0)
    raise KeyError(rule.fold)


def selection_tie(pool, valid, pool_ids, ids_a, ids_b,
                  rule: KernelRule) -> bool:
    """Whether two greedies over ONE pool (its own ground: `pool` (n, D),
    `valid` (n,), global `pool_ids` (n,)) first differ at a genuine tie,
    as ROADMAP §C P1 allows: at the first step where ids_a and ids_b
    (k,) differ, the two picks' float64 raw gains after the common
    prefix lie within the f32 bounds of their entries (a D-term 'dot' by
    2·D·eps·‖g‖‖c‖; the 'dist' expansion by B = sq_dist_bound in squared
    form, ≤ min(√B, B/2d) in d) and of their sums (2·n·eps·|g|). Runs in
    float64 on the pool's device. True when the selections are equal."""
    a = torch.as_tensor(ids_a).cpu().tolist()
    b = torch.as_tensor(ids_b).cpu().tolist()
    diff = [i for i, (u, v) in enumerate(zip(a, b)) if u != v]
    if not diff:
        return True
    s = diff[0]
    where = {int(e): j for j, e in enumerate(
        torch.as_tensor(pool_ids).cpu().tolist()) if e >= 0}
    g = pool.double()
    valid = valid.to(g.device).bool()

    def column(j):
        c = g[j]
        if rule.pairwise == "dist":
            return torch.linalg.vector_norm(g - c, dim=-1)
        return g @ c

    if rule.fold == "min":
        row = torch.where(valid, torch.linalg.vector_norm(g, dim=-1),
                          torch.zeros((), dtype=g.dtype, device=g.device))
    else:
        row = torch.where(valid, torch.zeros_like(g[:, 0]),
                          torch.full_like(g[:, 0], rule.row_pad))
    for e in a[:s]:
        if e >= 0:
            row = _fold64(row, column(where[int(e)]), rule)
    gains, tols = [], []
    n, d = g.shape
    for e in (a[s], b[s]):
        if e < 0:
            gains.append(0.0)
            tols.append(0.0)
            continue
        j = where[int(e)]
        col = column(j)
        gain = float(_gain_part64(row, col, rule)[valid].sum())
        if rule.pairwise == "dist":
            bnd = sq_dist_bound(g, g[j:j + 1])[:, 0]
            err = torch.minimum(bnd.sqrt(),
                                bnd / torch.clamp(2 * col, min=1e-300))
        else:
            gn = torch.linalg.vector_norm(g, dim=-1)
            err = 2 * d * EPS32 * gn * gn[j]
        gains.append(gain)
        tols.append(float(err[valid].sum()) + 2 * n * EPS32 * abs(gain))
    return abs(gains[0] - gains[1]) <= tols[0] + tols[1] + 1e-12
