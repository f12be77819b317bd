"""Fixed-shape Sieve-Streaming (Badanidiyuru et al. 2014), the online
leaf solver of the streaming subsystem (answers
`src/repro/streaming/sieve.py`).

Sieve-Streaming keeps one partial solution per guess v of OPT on the
geometric grid v = (1+ε)^j and admits an arriving element e into level v
exactly when

    gain(e | S_v)  ≥  (v/2 − f(S_v)) / (k − |S_v|)       and |S_v| < k,

which guarantees max_v f(S_v) ≥ (1/2 − ε)·OPT. Only the exponent window
{j : m ≤ (1+ε)^j ≤ 2k·m} matters (m the running max singleton gain), so
L = ⌈log_{1+ε}(2k)⌉ + 2 levels, rounded up to a multiple of 8, slide
with m: each batch updates m and recycles levels that fell below the
window as fresh sieves above its top.

Per-level state lives in (…, L, N) rows over a FIXED evaluation ground
set for the feature rules ((…, L, W) covered words for coverage), with
(…, L, k) id / (…, L, k, …) payload slots and counts giving validity.
The leading dimensions are stacked sieves (a window's checkpoints, the
continuous mode's lanes). One arrival batch against all L levels of all
stacked sieves is ONE stream-filter launch (kernels/stream_filter.py,
planned by plans.stream_plan); the slots are then updated on the card
(`scatter_slots`, in place: only admitted rows are written). Nothing
here waits on the card: the drivers read values only at the end or at
merges. Values and thresholds are RAW part sums (popcounts for
coverage); `solution()` normalizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.greedy import Solution
from repro_torch.kernels import ops
from repro_torch.kernels import rules as R
from repro_torch.kernels import stream_filter as stream_k
from repro_torch.kernels.plans import stream_plan

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass
class SieveState:
    """One sieve's state, or G stacked ones (a leading (G,) on every
    field). ids and payloads are updated in place, on every device, by
    `SieveStreamer.process_batch`: a state handed to it is consumed."""
    rows: torch.Tensor       # (…, L, N) f32 | (…, L, W) int32 words
    values: torch.Tensor     # (…, L) f32 raw f(S_v)
    counts: torch.Tensor     # (…, L) int32 |S_v|
    expos: torch.Tensor      # (…, L) int32 grid exponents
    m_max: torch.Tensor      # (…,) f32 running max raw singleton gain
    ids: torch.Tensor        # (…, L, k) int64 element ids (-1 = empty)
    payloads: torch.Tensor   # (…, L, k, …) admitted payloads
    evals: torch.Tensor      # (…,) int64 marginal-gain evaluations
    spent: Optional[torch.Tensor] = None   # (…, L) f32, knapsack mode

    def map(self, fn) -> "SieveState":
        return SieveState(*(None if getattr(self, f.name) is None
                            else fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)))


def num_levels(k: int, eps: float) -> int:
    """Static sieve-level count: the exponent window's width
    ⌈log_{1+ε}(2k)⌉ (+2 ceil/slide margin), rounded up to a multiple of
    8 — part of the algorithm's output: more levels, more guesses of
    OPT."""
    width = int(math.ceil(math.log(2.0 * k) / math.log1p(eps))) + 2
    return -(-width // 8) * 8


class SieveStreamer:
    """Objective-adapted sieve engine, on the objective's device.

    For k-medoid/facility pass ``ground``/``ground_valid``: the fixed
    evaluation set the summary is scored against. Coverage needs
    neither. ``budget`` > 0 enables knapsack streaming:
    ``process_batch`` then takes per-arrival ``costs`` and admits by
    cost ratio, with a per-level spent track in the same launch."""

    def __init__(self, objective, k: int, eps: float = 0.1,
                 ground=None, ground_valid=None, budget: float = 0.0):
        self.objective = objective
        self.rule = objective.rule
        self.device = objective.device
        self.k = int(k)
        self.eps = float(eps)
        self.eps_log = math.log1p(float(eps))
        self.budget = float(budget)
        self.levels = num_levels(k, eps)
        self._stored = {}
        if self.rule.is_bitmap:
            self.ground = None
            self.row0 = R.empty_row(None, None, self.rule,
                                    words=objective.words,
                                    device=self.device)
            self.n_eff = torch.ones((), dtype=F32, device=self.device)
        else:
            if ground is None:
                raise ValueError("vector objectives need a fixed "
                                 "evaluation ground set")
            ground = torch.as_tensor(ground, device=self.device).to(F32)
            if ground_valid is None:
                ground_valid = torch.ones(ground.shape[0], dtype=torch.bool,
                                          device=self.device)
            gvalid = torch.as_tensor(ground_valid, device=self.device)
            state0 = objective.init_state(ground[None], gvalid[None])
            self.ground = ground
            self.row0 = state0.row[0]
            self.n_eff = state0.n_eff[0]

    # -- planning ------------------------------------------------------------

    def plan(self, batch: int) -> dict:
        """stream_plan for a batch of `batch` arrivals: the tier ('kernel'
        while a level's state fits a block's shared memory, else
        'global'; CPU tensors run the plain version on either), and the
        ground's storage."""
        d = None if self.rule.is_bitmap else self.ground.shape[1]
        return stream_plan(self.row0.shape[0], batch, d, self.rule)

    def _ground(self, plan: dict):
        """The ground features as the plan stores them, with their norms
        for a 'dist' rule on the card (ops.stream_ground, once per
        streamer and storage) → (ground, gscale, gnorm); Nones for
        bitmap rules."""
        if self.rule.is_bitmap:
            return None, None, None
        if plan["dtype"] not in self._stored:
            self._stored[plan["dtype"]] = ops.stream_ground(
                self.ground, plan["dtype"], self.rule)
        return self._stored[plan["dtype"]]

    # -- state construction --------------------------------------------------

    def init(self, payload_example=None, lanes: Optional[int] = None
             ) -> SieveState:
        """Empty sieve(s) — `lanes` stacked ones when given; the window
        self-anchors on the first arrivals' singleton gains.
        ``payload_example`` (B, …) sets the payload slots' tail and
        dtype (default: the ground's features, or the words)."""
        L, k, dev = self.levels, self.k, self.device
        if payload_example is not None:
            pe = (R.to_words(payload_example) if self.rule.is_bitmap
                  else torch.as_tensor(payload_example))
            tail, dtype = tuple(pe.shape[1:]), pe.dtype
        elif self.rule.is_bitmap:
            tail, dtype = (self.objective.words,), R.WORD_DTYPE
        else:
            tail, dtype = (self.ground.shape[1],), self.ground.dtype
        lead = () if lanes is None else (lanes,)
        return SieveState(
            self.row0.expand(lead + (L,) + self.row0.shape).clone(),
            torch.zeros(lead + (L,), dtype=F32, device=dev),
            torch.zeros(lead + (L,), dtype=I32, device=dev),
            torch.arange(L, dtype=I32, device=dev).expand(
                lead + (L,)).clone(),
            torch.zeros(lead, dtype=F32, device=dev),
            torch.full(lead + (L, k), -1, dtype=torch.int64, device=dev),
            torch.zeros(lead + (L, k) + tail, dtype=dtype, device=dev),
            torch.zeros(lead, dtype=torch.int64, device=dev),
            torch.zeros(lead + (L,), dtype=F32, device=dev)
            if self.budget > 0 else None)

    # -- the batched arrival update ------------------------------------------

    def process_batch(self, state: SieveState, ids, payloads, valid,
                      costs=None) -> SieveState:
        """Fold one batch of B arrivals into all L levels of the state's
        sieve(s): the re-anchor and the sequential admission in ONE
        stream-filter launch, then the slot update. ids (B,) / payloads
        (B, …) / valid (B,) — or with a leading (G,) for stacked sieves
        that each see their own arrivals. ``costs`` (…, B): per-arrival
        knapsack costs, required iff the streamer has a budget."""
        cost_mode = self.budget > 0
        if (costs is not None) != cost_mode:
            raise ValueError("per-arrival costs go with a construction-"
                             "time budget")
        dev = self.device
        ids = torch.as_tensor(ids, device=dev).to(torch.int64)
        pay = (R.to_words(payloads).to(dev) if self.rule.is_bitmap
               else torch.as_tensor(payloads, device=dev))
        # arrival sets (A, B, …): A = 1 when every sieve sees the batch
        b = ids.shape[-1]
        tail = pay.shape[ids.dim():]
        ids = ids.reshape(-1, b)
        pay = pay.reshape(ids.shape + tail)
        valid = torch.as_tensor(valid, device=dev).to(torch.bool).reshape(
            ids.shape)
        if cost_mode:
            costs = torch.as_tensor(costs, device=dev).to(F32).reshape(
                ids.shape)
        stacked = state.rows.dim() == 3
        st = state if stacked else state.map(lambda x: x.unsqueeze(0))
        plan = self.plan(b)
        ground, gscale, gnorm = self._ground(plan)
        out = ops.stream_filter(
            ground, pay if self.rule.is_bitmap else pay.to(F32), st.rows,
            self.row0, st.values, st.counts, st.expos, st.m_max, valid,
            self.k, self.eps_log, self.rule,
            costs=costs if cost_mode else None,
            spent=st.spent if cost_mode else None,
            budget=self.budget if cost_mode else None, gscale=gscale,
            gnorm=gnorm)
        rows, values, counts, admits, expos, m_new, expired = out[:7]
        new_ids, new_pay = stream_k.scatter_slots(
            st.ids, st.payloads, st.counts, expired, admits, ids,
            pay.to(st.payloads.dtype), self.k)
        evals = st.evals + self.levels * valid.sum(-1)
        new = SieveState(rows, values, counts, expos, m_new, new_ids,
                         new_pay, evals, out[7] if cost_mode else None)
        return new if stacked else new.map(lambda x: x[0])

    # -- extraction ----------------------------------------------------------

    def solution(self, state: SieveState) -> Solution:
        """Best level's partial solution as a fixed-shape Solution (value
        normalized to the objective's units); batched over stacked
        sieves."""
        lvl = torch.argmax(state.values, dim=-1)                 # (…,)

        def at(x):
            idx = lvl.reshape(lvl.shape + (1,) * (x.dim() - lvl.dim()))
            idx = idx.expand(lvl.shape + (1,) + x.shape[lvl.dim() + 1:])
            return torch.gather(x, lvl.dim(), idx).squeeze(lvl.dim())

        slot_valid = (torch.arange(self.k, device=self.device)
                      < at(state.counts).unsqueeze(-1))
        return Solution(at(state.ids), at(state.payloads), slot_valid,
                        at(state.values) / self.n_eff, state.evals)
