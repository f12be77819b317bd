"""Multi-tenant batched selection query engine (answers
`src/repro/serving/engine.py`).

Tenants submit one-shot queries — each with its own registered
objective, k, constraint and seed — into a bounded request queue, and
the engine ADMISSION-BATCHES compatible queries into one resident-loop
dispatch. Compatibility is `plans.serve_key`: the same KernelRule (name,
cap and λ), the same candidate bucket `bucket_len(c, 128)`, the same
trailing axis (features D / universe words W) and the same device.
Admission is FIFO by key up to min(serve_plan's b_max,
REPRO_TORCH_SERVE_BATCH or ``max_batch``).

An admitted group is stacked on a leading query axis — each pool
zero-padded to the bucket (pad slots: zero payloads, invalid, id −1),
the batch padded to a power of two with inert fill queries (k = 0, all
invalid) — and run by `RuleObjective.megakernel_loop_batched`: the query
axis is the batch dimension of ONE `greedy_loop_resident` dispatch
(`greedy_loop_resident[coverage]` for bitmaps), each query's k in
ctl[:, 0] and its real (n, c) in ctl[:, 1:3]. Each query's initial state
row, base and normalizer are taken on its own unpadded pool, as its solo
run takes them, and its answer is read back from its unpadded slice, so
every query's ids and value equal its solo ``greedy(engine="mega")``
run bit for bit. ``ServeMetrics.batch_executed`` records the batch's
dispatches: the launch counters' delta on the card (calls on the CPU,
where no kernel launches), one resident dispatch however many CUDA
launches it takes.

Queries the batched path cannot serve run alone through `greedy()`, on
the engine's device — the reference's admission rule, not a refuge for a
failed launch (a failed launch raises): constrained queries and sampled
queries (per-step host logic the loop kernel does not evaluate),
explicit engine overrides, and shapes off the resident tier
(serve_plan None). Every knob is read through runtime/flags.py.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import greedy as greedy_mod
from repro_torch.core.objective import RuleState, make_objective
from repro_torch.kernels import counters, plans
from repro_torch.kernels import rules as R
from repro_torch.runtime import flags
from repro_torch.runtime.device import DeviceLike, resolve_device
from repro_torch.serving.metrics import ServeMetrics


class QueueFull(RuntimeError):
    """Raised by submit() at the queue bound (REPRO_TORCH_SERVE_QUEUE):
    backpressure, drain() first."""


@dataclasses.dataclass
class Query:
    """One tenant's selection request: objective/universe/params build the
    registered objective; ids/payloads/valid are the pool as a solo
    `greedy()` caller passes it; constraint/sample/seed/engine mirror
    greedy()'s arguments (a non-default value of any of them serves the
    query solo — the same result, not co-batched)."""
    objective: str
    k: int
    ids: Any
    payloads: Any
    valid: Any
    tenant: str = "anon"
    universe: int = 0
    params: dict = dataclasses.field(default_factory=dict)
    constraint: Any = None
    sample: int = 0
    seed: int = 0
    engine: str = "auto"


@dataclasses.dataclass
class QueryResult:
    """A completed query: the Solution and how it was served."""
    qid: int
    tenant: str
    solution: greedy_mod.Solution
    batched: bool
    batch_size: int
    key: Optional[str]
    latency_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class QueryEngine:
    """Bounded queue + admission batcher + batched/solo scheduler, on
    `device` (default the card)."""

    def __init__(self, *, device: DeviceLike = None,
                 max_batch: Optional[int] = None,
                 queue_cap: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None):
        self.device = resolve_device(device)
        self.max_batch = max_batch      # None → flags.serve_batch()
        self.queue_cap = queue_cap      # None → flags.serve_queue()
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._pending: collections.deque = collections.deque()
        self._next_qid = 0
        self._objs: Dict[tuple, Any] = {}

    # -- submission ----------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._pending)

    def submit(self, query: Query) -> int:
        """Enqueue a query; returns its qid (the key into drain()'s
        result dict). Raises QueueFull at the queue bound."""
        cap = (self.queue_cap if self.queue_cap is not None
               else flags.serve_queue())
        if len(self._pending) >= cap:
            raise QueueFull(f"request queue at capacity ({cap})")
        qid = self._next_qid
        self._next_qid += 1
        t0 = self.metrics.submitted(query.tenant)
        self._pending.append((qid, query, t0))
        return qid

    # -- objective + compatibility -------------------------------------------

    def _objective(self, q: Query):
        kp = (q.objective, q.universe, tuple(sorted(q.params.items())))
        obj = self._objs.get(kp)
        if obj is None:
            obj = make_objective(q.objective, universe=q.universe,
                                 device=self.device, **q.params)
            self._objs[kp] = obj
        return obj

    def _compat(self, q: Query) -> Tuple[Optional[str], Optional[dict]]:
        """(serve_key, admission plan) when the query can co-batch, else
        (None, None): the solo path."""
        c = int(q.valid.shape[0])
        if (q.constraint is not None or 0 < q.sample < c
                or q.engine not in ("auto", "mega")):
            return None, None
        obj = self._objective(q)
        rule = obj.rule
        c_bkt = plans.bucket_len(c, 128)
        n, d = ((obj.words, None) if rule.is_bitmap
                else (c_bkt, int(q.payloads.shape[-1])))
        sp = plans.serve_plan(rule, n, c_bkt, d, device=self.device.type)
        if sp is None:
            return None, None               # off the resident tier → solo
        return plans.serve_key(rule, n, c, d, self.device.type), sp

    # -- admission -----------------------------------------------------------

    def _admit(self):
        """Pop the queue head; its key defines the batch. Scan the rest
        FIFO for same-key queries up to the admission cap; everything
        else keeps its queue position."""
        head = self._pending.popleft()
        skey, sp = self._compat(head[1])
        group = [head]
        if skey is None:
            return None, None, group
        cap = (self.max_batch if self.max_batch is not None
               else flags.serve_batch())
        b_max = max(1, min(sp["b_max"], cap))
        keep: collections.deque = collections.deque()
        while self._pending and len(group) < b_max:
            entry = self._pending.popleft()
            ekey, _ = self._compat(entry[1])
            if ekey == skey:
                group.append(entry)
            else:
                keep.append(entry)
        while self._pending:
            keep.append(self._pending.popleft())
        self._pending = keep
        return skey, sp, group

    # -- execution -----------------------------------------------------------

    def _pool(self, obj, q: Query):
        """The query's pool on the engine's device, as greedy() takes it."""
        dev = self.device
        pay = (R.to_words(q.payloads).to(dev) if obj.rule.is_bitmap
               else torch.as_tensor(q.payloads, device=dev))
        return (torch.as_tensor(q.ids, device=dev).to(torch.int64), pay,
                torch.as_tensor(q.valid, device=dev).to(torch.bool))

    def _run_solo(self, entry) -> QueryResult:
        qid, q, t0 = entry
        obj = self._objective(q)
        ids, pay, valid = self._pool(obj, q)
        c = int(valid.shape[0])
        key = (torch.Generator().manual_seed(q.seed) if 0 < q.sample < c
               else None)
        sol = greedy_mod.greedy(obj, ids, pay, valid, q.k, sample=q.sample,
                                key=key, constraint=q.constraint,
                                engine=q.engine)
        _sync(self.device)
        lat = self.metrics.completed(q.tenant, t0, batched=False)
        return QueryResult(qid, q.tenant, sol, False, 1, None, lat)

    def _run_batched(self, skey: str, sp: dict, group) -> List[QueryResult]:
        t_exec = time.monotonic()
        obj = self._objective(group[0][1])
        rule, dev = obj.rule, self.device
        pools = [self._pool(obj, q) for _, q, _ in group]
        c_bkt = plans.bucket_len(max(int(v.shape[0]) for _, _, v in pools),
                                 128)
        k_pad = plans.bucket_len(max(q.k for _, q, _ in group), 4)
        b_pad = 1
        while b_pad < len(group):
            b_pad *= 2
        b_pad = max(min(b_pad, sp["b_max"]), len(group))
        tail = tuple(pools[0][1].shape[1:])
        pays = torch.zeros((b_pad, c_bkt) + tail, dtype=pools[0][1].dtype,
                           device=dev)
        vals = torch.zeros((b_pad, c_bkt), dtype=torch.bool, device=dev)
        ks = torch.zeros(b_pad, dtype=torch.int32)
        lims = torch.zeros((b_pad, 2), dtype=torch.int32)
        # each query's initial state on its own unpadded pool, as its
        # solo run takes it; inert fill queries keep the empty padding
        fill = obj.init_state(pays[:1], vals[:1])
        rows = fill.row.expand((b_pad,) + tuple(fill.row.shape[1:])).clone()
        base = fill.base.expand(b_pad).clone()
        n_eff = fill.n_eff.expand(b_pad).clone()
        solo = []
        for i, ((_, q, _), (ids, pay, valid)) in enumerate(zip(group,
                                                               pools)):
            c = int(valid.shape[0])
            pays[i, :c] = pay
            vals[i, :c] = valid
            ks[i] = q.k
            lims[i] = torch.tensor([obj.words if rule.is_bitmap else c, c])
            st = obj.init_state(pay.unsqueeze(0), valid.unsqueeze(0))
            if rule.is_bitmap:
                rows[i] = st.row[0]
            else:
                rows[i, :c] = st.row[0]
            base[i], n_eff[i] = st.base[0], st.n_eff[0]
            solo.append(st)
        state = RuleState(None if rule.is_bitmap else pays,
                          None if rule.is_bitmap else vals, rows, base,
                          n_eff)
        before = counters.snapshot()
        mega = obj.megakernel_loop_batched(pays, vals, ks, k_pad,
                                           plan=sp["plan"], logical=lims,
                                           state=state)
        if mega is None:
            raise RuntimeError(f"serve plan {sp['plan']} is not resident")
        _, bests, gains = mega
        _sync(dev)
        ndisp = counters.dispatches(before, counters.snapshot(), dev)
        self.metrics.batch_executed(skey, len(group), ndisp,
                                    time.monotonic() - t_exec)
        out = []
        for i, (entry, (ids, pay, valid), st) in enumerate(zip(group, pools,
                                                               solo)):
            qid, q, t0 = entry
            c = int(valid.shape[0])
            row = mega[0].row[i:i + 1]
            if not rule.is_bitmap:
                row = row[:, :c]
            one = (dataclasses.replace(st, row=row.contiguous()),
                   bests[i:i + 1, :q.k], gains[i:i + 1, :q.k])
            sol = greedy_mod._finalize_mega(
                obj, one, ids.unsqueeze(0), pay.unsqueeze(0),
                valid.unsqueeze(0), q.k).map(lambda x: x[0])
            lat = self.metrics.completed(q.tenant, t0, batched=True)
            out.append(QueryResult(qid, q.tenant, sol, True, len(group),
                                   skey, lat))
        return out

    # -- the scheduler loop --------------------------------------------------

    def drain(self) -> Dict[int, QueryResult]:
        """Serve every pending query: admit the head's compatible group
        and run it as one batched dispatch (or the head solo when it
        cannot co-batch), until the queue is empty. Returns {qid:
        QueryResult}."""
        out: Dict[int, QueryResult] = {}
        while self._pending:
            skey, sp, group = self._admit()
            if skey is None:
                results = [self._run_solo(e) for e in group]
            else:
                results = self._run_batched(skey, sp, group)
            for r in results:
                out[r.qid] = r
        return out
