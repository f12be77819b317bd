"""The kernel of `src/repro/kernels/stream_filter.py` (stream_filter_pallas):
one batch of B arrivals against all L levels of G stacked sieves, in
one dispatch — csrc/stream_filter.cu, its wrappers and its plain
version.

  stream_filter        f32 ground (N, D), arrivals (A, B, D):
                       csrc/stream_filter.cu:rt_stream_filter, counted
                       as `stream_filter`; int8 ground with (N,) row
                       scales, the same kernels widening each entry as
                       the tile stages it, counted as
                       `stream_filter[int8]`; bitmap arrivals (A, B, W)
                       words, no ground: rt_stream_filter_bits,
                       `stream_filter[coverage]`. Each with or without
                       the knapsack cost mode, and on either tier of
                       plans.stream_tier: 'kernel' (a feature level's row
                       in the shared memory of a thread-block cluster of
                       8 blocks, a chunk a block; a bitmap level's
                       words in one block's) or 'global' (in its row of
                       the output state in device memory; the same bits).
                       One counted dispatch a batch (the reference's
                       count): four CUDA launches for feature rules
                       (arrival norms, slab, singleton gains, decisions),
                       two for bitmaps (singletons and word lists,
                       levels).
  ground_norms         the ground's float64 norms ('dist' rules), which
                       the slab reads: computed once per evaluation set
                       and storage by ops.stream_ground (SieveStreamer
                       keeps them) and passed as ``gnorm``; a call
                       without them computes them.
  stream_slab          the feature slab alone, (A, B, N) and its
                       singleton partials, as rt_stream_filter builds it,
                       or with ``reference=True`` the 64x64-tile build it
                       must equal bit for bit (a check's and a timing's
                       entry point, on the card only).
  stream_filter_plain  the plain PyTorch version (kernels/ref.py:
                       stream_sieve over ref.pairwise's matrix): the CPU
                       path at any size (the 'plain' tier), and the
                       kernel's yardstick on the card.
  scatter_slots        the sieve's solution slots after a batch
                       (streaming/sieve.py:_scatter_slots): expired
                       levels cleared, admitted arrivals written in
                       order, in place on every device. On the card
                       csrc/stream_filter.cu:rt_scatter_slots writes
                       only the admitted rows (no host sync, no rewrite
                       of every slot); `scatter_slots_plain` is the
                       reference's one-hot formula, functional. A
                       helper of the sieve with no TPU kernel behind it
                       (the reference does this in jnp), counted as
                       `scatter_slots`.

Shapes (canonical; ops.stream_filter maps the reference's onto them):
rows (G, L, N) f32 or int32 words, row0 (N,), values (G, L) f32, counts
and expos (G, L) int32, m_max (G,) f32; arrivals (A, B, ·) with A = 1
(every sieve sees the same batch: the window's checkpoints) or A = G
(the continuous mode's lanes); bvalid (A, B) bool; costs (A, B) f32,
spent (G, L) f32 and a float budget in cost mode. Returns (rows, values,
counts, admits (G, L, B) bool, expos, m_new (G,), expired (G, L) bool)
[+ spent].
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, counters, plans, ref
from repro_torch.kernels import rules as R
from repro_torch.kernels.pairwise import (FOLDS, MODES, STORAGES,
                                          check_feature_rule, check_operand,
                                          check_words)

F32 = torch.float32
I32 = torch.int32
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

COUNTERS = {"float32": counters.counter("stream_filter"),
            "int8": counters.counter("stream_filter[int8]"),
            "uint32": counters.counter("stream_filter[coverage]")}
SCATTER_COUNTER = counters.counter("scatter_slots")


def stream_filter_plain(ground, batch, rows, row0, values, counts, expos,
                        m_max, bvalid, k: int, eps_log: float,
                        rule: R.KernelRule, gscale=None, costs=None,
                        spent=None, budget=None):
    """The plain version (ref.stream_sieve over ref.pairwise's (A, N, B)
    matrix, an int8 ground dequantized first), canonical shapes."""
    if rule.is_bitmap:
        mat = batch.transpose(-1, -2)                   # (A, W, B) words
    else:
        g = R.dequant(ground, gscale.reshape(1, -1)) if gscale is not None \
            else ground
        mat = ref.pairwise(g, batch, rule)              # (A, N, B)
    cost_kw = {}
    if costs is not None:
        cost_kw = dict(costs=costs, spent=spent, budget=budget)
    out = ref.stream_sieve(mat, row0, rows, values, counts, expos, m_max,
                           bvalid, k, eps_log, rule, **cost_kw)
    rows_, values_, counts_, admits, expos_, m_new, expired = out[:7]
    res = (rows_, values_, counts_, admits > 0, expos_, m_new, expired > 0)
    return res + (out[7],) if costs is not None else res


@functools.lru_cache(maxsize=None)
def _lib():
    """The library with its entry points typed (once a process: the
    stream calls it every batch)."""
    lib = build.load("stream_filter")
    lib.rt_stream_norms.restype = _I
    lib.rt_stream_norms.argtypes = [_P] * 3 + [ctypes.c_longlong, _I, _I, _P]
    lib.rt_stream_slab.restype = _I
    lib.rt_stream_slab.argtypes = [_P] * 8 + [_I] * 7 + [_F] * 3 + [_I, _P]
    lib.rt_stream_filter.restype = _I
    lib.rt_stream_filter.argtypes = ([_P] * 25 + [_I] * 10 + [_F] * 4
                                     + [_I, _F, _I, _P])
    lib.rt_stream_filter_bits.restype = _I
    lib.rt_stream_filter_bits.argtypes = ([_P] * 22 + [_I] * 6
                                          + [_F, _I, _F, _I, _P])
    lib.rt_scatter_slots.restype = _I
    lib.rt_scatter_slots.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ground_norms(ground, gscale=None):
    """(N,) f32 squared norms of the ground rows ((N, D) f32, or int8 with
    its (N,) row scales: the dequantized rows), each one float64
    fma(v, v, ·) chain in ascending feature order cast once to f32, as
    the slab reads them. On the card one launch (part of the stream
    filter's work, not counted on its own); CPU tensors get the plain
    float64 sum (the plain version needs no norms)."""
    if not ground.is_cuda:
        g = R.dequant(ground, gscale.reshape(1, -1)) if gscale is not None \
            else ground
        return g.double().square().sum(-1).to(F32)
    dev = ground.device
    n, d = ground.shape
    storage = STORAGES.get(ground.dtype)
    if storage is None or ground.dtype not in (F32, torch.int8):
        raise NotImplementedError("ground_norms: f32 or int8 ground")
    check_operand(ground, (n, d), ground.dtype, "ground", dev)
    if (gscale is None) != (ground.dtype != torch.int8):
        raise ValueError("int8 ground goes with its (N,) row scales")
    if gscale is not None:
        check_operand(gscale, (n,), F32, "gscale", dev)
    out = torch.empty(n, dtype=F32, device=dev)
    lib = _lib()
    build.check(lib, lib.rt_stream_norms(
        ground.data_ptr(), _ptr(gscale), out.data_ptr(), n, d, storage,
        _stream(dev)), "stream_filter ground norms")
    return out


def _check_ground(ground, gscale, gnorm, rule, n, d, dev):
    """The feature ground's checks → (storage code, gnorm or None)."""
    storage = STORAGES[ground.dtype] if ground.dtype in (
        F32, torch.int8) else None
    if storage is None:
        raise NotImplementedError("stream_filter: the CUDA path takes "
                                  "f32 or int8 ground features")
    check_operand(ground, (n, d), ground.dtype, "ground", dev)
    if (gscale is None) != (ground.dtype != torch.int8):
        raise ValueError("int8 ground goes with its (N,) row scales")
    if gscale is not None:
        check_operand(gscale, (n,), F32, "gscale", dev)
    if rule.pairwise != "dist":
        return storage, None
    if gnorm is None:
        gnorm = ground_norms(ground, gscale)
    check_operand(gnorm, (n,), F32, "gnorm", dev)
    return storage, gnorm


def stream_slab(ground, batch, row0, rule: R.KernelRule, gscale=None,
                gnorm=None, reference: bool = False):
    """The feature slab of one batch on the card, alone: (mat (A, B, N)
    f32, partials (A, ceil(N/64), B) float64 singleton partials) as
    stream_filter builds them (the 128x128 tile, its norms from
    ``gnorm`` or computed), or, with ``reference``, as the 64x64 tile
    with its inline norms builds them: the yardstick the slab equals bit
    for bit. A check's and a timing's entry point: no counter, CUDA
    tensors only."""
    if not batch.is_cuda:
        raise ValueError("stream_slab runs on the card only")
    check_feature_rule(rule, "stream_slab")
    dev = batch.device
    a, b, d = batch.shape
    n = ground.shape[0]
    check_operand(batch, (a, b, d), F32, "arrivals", dev)
    check_operand(row0, (n,), F32, "row0", dev)
    storage, gnorm = _check_ground(ground, gscale, gnorm, rule, n, d, dev)
    if reference:
        gnorm = None                    # the 64x64 tile sums its own norms
    mat = torch.empty((a, b, n), dtype=F32, device=dev)
    partials = torch.empty((a, -(-n // 64), b), dtype=torch.float64,
                           device=dev)
    anorm = (torch.empty(a * b, dtype=F32, device=dev)
             if gnorm is not None else None)
    lib = _lib()
    build.check(lib, lib.rt_stream_slab(
        ground.data_ptr(), _ptr(gscale), _ptr(gnorm), batch.data_ptr(),
        _ptr(anorm), row0.data_ptr(), mat.data_ptr(), partials.data_ptr(),
        n, b, a, d, MODES[rule.pairwise], storage, FOLDS[rule.fold],
        rule.cap, rule.lam, 1.0 - rule.lam, int(reference), _stream(dev)),
        "stream_filter slab" + (" (64x64 reference)" if reference else ""))
    return mat, partials


def _check_state(rows, values, counts, expos, m_max, row_dtype, dev):
    if rows.dim() != 3:
        raise ValueError("stream_filter kernel takes (G, L, N) rows")
    g, l, n = rows.shape
    check_operand(rows, (g, l, n), row_dtype, "rows", dev)
    check_operand(values, (g, l), F32, "values", dev)
    check_operand(counts, (g, l), I32, "counts", dev)
    check_operand(expos, (g, l), I32, "expos", dev)
    check_operand(m_max, (g,), F32, "m_max", dev)
    return g, l, n


def stream_filter(ground, batch, rows, row0, values, counts, expos, m_max,
                  bvalid, k: int, eps_log: float, rule: R.KernelRule,
                  gscale=None, costs=None, spent=None, budget=None,
                  scratch=None, gnorm=None):
    """One arrival batch against every level of G sieves (canonical
    shapes, module doc). CPU tensors take the plain version; CUDA
    tensors launch the kernels, on the tier plans.stream_tier gives, or
    raise. ``scratch`` (A, B, N)
    f32, for feature rules on the card, receives the matrix slab the
    kernel built (for checks; by default the wrapper allocates it).
    ``gnorm`` (N,): the ground's norms for a 'dist' rule
    (`ground_norms`, computed here when not given; the plain version
    needs none)."""
    counter = COUNTERS["uint32" if rule.is_bitmap else (
        "int8" if ground.dtype == torch.int8 else "float32")]
    counter.calls += 1
    cost_mode = costs is not None
    if not (costs is None) == (spent is None) == (budget is None):
        raise ValueError("costs, spent and budget go together")
    if not batch.is_cuda:
        if scratch is not None:
            raise ValueError("the plain version builds no scratch slab")
        return stream_filter_plain(ground, batch, rows, row0, values,
                                   counts, expos, m_max, bvalid, k, eps_log,
                                   rule, gscale=gscale, costs=costs,
                                   spent=spent, budget=budget)
    dev = batch.device
    if batch.dim() != 3:
        raise ValueError("stream_filter kernel takes (A, B, ·) arrivals")
    a, b = batch.shape[:2]
    g, l, n = _check_state(rows, values, counts, expos, m_max,
                           rule.dtype, dev)
    if a not in (1, g):
        raise ValueError(f"{a} arrival sets for {g} sieves (1 or G)")
    if b == 0 or n == 0:
        raise ValueError("stream_filter kernel needs arrivals and rows")
    check_operand(row0, (n,), rule.dtype, "row0", dev)
    check_operand(bvalid, (a, b), torch.bool, "bvalid", dev)
    if cost_mode:
        check_operand(costs, (a, b), F32, "costs", dev)
        check_operand(spent, (g, l), F32, "spent", dev)
    if max(g * l, a * b, n) >= 2 ** 31:
        raise ValueError("stream_filter extents must fit int32")
    rows_out = torch.empty_like(rows)
    values_out = torch.empty_like(values)
    counts_out = torch.empty_like(counts)
    admits = torch.empty((g, l, b), dtype=torch.bool, device=dev)
    expos_out = torch.empty_like(expos)
    m_out = torch.empty_like(m_max)
    expired = torch.empty((g, l), dtype=torch.bool, device=dev)
    spent_out = torch.empty_like(spent) if cost_mode else None
    eps32 = float(torch.tensor(eps_log, dtype=F32))  # the f32 both use
    bud = float(budget) if cost_mode else 0.0
    global_rows = int(plans.stream_tier(n, b, rule) == "global")
    lib = _lib()
    stream = _stream(dev)
    state = [_ptr(values), _ptr(counts), _ptr(expos), _ptr(m_max),
             _ptr(bvalid), _ptr(costs), _ptr(spent)]
    outs = [_ptr(rows_out), _ptr(values_out), _ptr(counts_out),
            _ptr(admits), _ptr(expos_out), _ptr(m_out), _ptr(expired),
            _ptr(spent_out)]
    if rule.is_bitmap:
        if scratch is not None:
            raise ValueError("the bitmap stream filter builds no matrix")
        check_operand(batch, (a, b, n), R.WORD_DTYPE, "arrivals", dev)
        check_words(n, "stream_filter")
        lists = torch.empty((2, a, b, n), dtype=I32, device=dev)
        lcnt = torch.empty((a, b), dtype=I32, device=dev)
        single = torch.empty((a, b), dtype=F32, device=dev)
        err = lib.rt_stream_filter_bits(
            batch.data_ptr(), row0.data_ptr(), rows.data_ptr(), *state,
            lists[0].data_ptr(), lists[1].data_ptr(), lcnt.data_ptr(),
            single.data_ptr(), *outs, g, l, n, b, a, k, eps32,
            int(cost_mode), bud, global_rows, stream)
        build.check(lib, err, "stream_filter[coverage] kernel")
    else:
        check_feature_rule(rule, "stream_filter")
        d = batch.shape[2]
        check_operand(batch, (a, b, d), F32, "arrivals", dev)
        storage, gnorm = _check_ground(ground, gscale, gnorm, rule, n, d,
                                       dev)
        if scratch is None:
            scratch = torch.empty((a, b, n), dtype=F32, device=dev)
        check_operand(scratch, (a, b, n), F32, "scratch", dev)
        partials = torch.empty((a, -(-n // 64), b), dtype=torch.float64,
                               device=dev)
        small = torch.empty(2 * a * b, dtype=F32, device=dev)
        err = lib.rt_stream_filter(
            ground.data_ptr(), _ptr(gscale), _ptr(gnorm), batch.data_ptr(),
            row0.data_ptr(), rows.data_ptr(), *state, scratch.data_ptr(),
            partials.data_ptr(), small.data_ptr(), small[a * b:].data_ptr(),
            *outs, g, l, n, b, a, d, k, MODES[rule.pairwise], storage,
            FOLDS[rule.fold], rule.cap, rule.lam, 1.0 - rule.lam, eps32,
            int(cost_mode), bud, global_rows, stream)
        what = "stream_filter[int8]" if gscale is not None else \
            "stream_filter"
        build.check(lib, err, what + " kernel")
    counter.launches += 1
    res = (rows_out, values_out, counts_out, admits, expos_out, m_out,
           expired)
    return res + (spent_out,) if cost_mode else res


def scatter_slots_plain(ids, payloads, counts_before, expired, admits,
                        batch_ids, batch_pay, k: int):
    """The reference's formula: clear expired levels' slots, then place
    level l's admits of this batch at consecutive slots from its count
    (0 when expired). ids (G, L, k), payloads (G, L, k, …), counts_before
    and expired (G, L), admits (G, L, B), batch_ids (A, B), batch_pay
    (A, B, …). Returns new (ids, payloads)."""
    exp = expired.unsqueeze(-1)
    ids = torch.where(exp, torch.full_like(ids, -1), ids)
    keep = exp.reshape(exp.shape + (1,) * (payloads.dim() - 3))
    payloads = torch.where(keep, torch.zeros_like(payloads), payloads)
    base = torch.where(expired, torch.zeros_like(counts_before),
                       counts_before)
    adm = admits.to(torch.int64)
    pos = base.unsqueeze(-1) + torch.cumsum(adm, -1) - adm      # (G, L, B)
    slot = admits.unsqueeze(-1) & (pos.unsqueeze(-1) == torch.arange(
        k, device=ids.device))                                  # (G,L,B,k)
    taken = slot.any(-2)                                        # (G, L, k)
    src = slot.to(torch.int8).argmax(-2)                        # (G, L, k)
    a_ids = batch_ids.unsqueeze(-2).expand(admits.shape)
    new_ids = torch.where(taken, torch.gather(a_ids, -1, src), ids)
    g, l = admits.shape[:2]
    pay = batch_pay.unsqueeze(1).expand((g, l) + batch_pay.shape[-2:])
    idx = src.reshape(src.shape + (1,) * (pay.dim() - 3)).expand(
        src.shape + pay.shape[3:])
    gathered = torch.gather(pay, 2, idx)                        # (G,L,k,…)
    keep = taken.reshape(taken.shape + (1,) * (pay.dim() - 3))
    return new_ids, torch.where(keep, gathered, payloads)


def scatter_slots(ids, payloads, counts_before, expired, admits, batch_ids,
                  batch_pay, k: int):
    """The solution slots after a batch (shapes as scatter_slots_plain,
    batch_ids/batch_pay with A = 1 or G), written into ids and payloads
    IN PLACE on every device, which are returned: the state they belong
    to is consumed. On the card the kernel writes only the admitted rows
    and the expired levels; CPU tensors take the plain version, copied
    back."""
    SCATTER_COUNTER.calls += 1
    if not ids.is_cuda:
        new_ids, new_pay = scatter_slots_plain(
            ids, payloads, counts_before, expired, admits, batch_ids,
            batch_pay, k)
        return ids.copy_(new_ids), payloads.copy_(new_pay)
    dev = ids.device
    g, l = admits.shape[:2]
    a, b = batch_ids.shape
    if a not in (1, g):
        raise ValueError(f"{a} arrival sets for {g} sieves (1 or G)")
    tail = tuple(payloads.shape[3:])
    if payloads.element_size() != 4:
        raise NotImplementedError("scatter_slots copies 32-bit payloads")
    row_words = math.prod(tail)
    check_operand(ids, (g, l, k), torch.int64, "ids", dev)
    check_operand(payloads, (g, l, k) + tail, payloads.dtype, "payloads",
                  dev)
    check_operand(counts_before, (g, l), I32, "counts_before", dev)
    check_operand(expired, (g, l), torch.bool, "expired", dev)
    check_operand(admits, (g, l, b), torch.bool, "admits", dev)
    check_operand(batch_ids, (a, b), torch.int64, "batch_ids", dev)
    check_operand(batch_pay, (a, b) + tail, payloads.dtype, "batch_pay",
                  dev)
    lib = _lib()
    err = lib.rt_scatter_slots(
        admits.data_ptr(), expired.data_ptr(), counts_before.data_ptr(),
        batch_ids.data_ptr(), batch_pay.data_ptr(), ids.data_ptr(),
        payloads.data_ptr(), g, l, b, a, k, row_words,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "scatter_slots kernel")
    SCATTER_COUNTER.launches += 1
    return ids, payloads
