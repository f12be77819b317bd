"""Per-tenant serving metrics (answers `src/repro/serving/metrics.py`).

One `ServeMetrics` instance rides a QueryEngine (and optionally a
SessionManager): submit/complete timestamps per query give host-side
latency percentiles and throughput, batch records give the admitted
batch's size and its dispatch count (the launch counters' delta,
kernels/counters.py: one resident dispatch a batch), and stream records
count per-tenant continuous pushes. Pure host-side bookkeeping with an
injectable clock; nothing here touches the device.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (0 ≤ q ≤ 100) by linear interpolation between
    order statistics — enough for latency reporting without pulling
    numpy into the serving hot path. Returns None for an empty sample:
    NaN is not representable in strict JSON, so a tenant with zero
    completed queries must surface as null, not break json.dump."""
    if not values:
        return None
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def _ms(seconds: Optional[float]) -> Optional[float]:
    """Seconds → milliseconds, passing None (empty sample) through."""
    return None if seconds is None else seconds * 1e3


class ServeMetrics:
    """Counters + latency samples for the serving engine.

    Per tenant: submitted/completed counts, solo-fallback count, and the
    submit→result wall latency of every completed query. Per engine: one
    record per executed admitted batch (compat key, batch size, counted
    dispatches, wall seconds). `snapshot()` renders the whole thing as a
    JSON-ready dict (p50/p99 in milliseconds, queries/s over the active
    window)."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._submitted: Dict[str, int] = {}
        self._completed: Dict[str, int] = {}
        self._solo: Dict[str, int] = {}
        self._latencies: Dict[str, List[float]] = {}
        self._stream_pushes: Dict[str, int] = {}
        self.batches: List[dict] = []
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- recording -----------------------------------------------------------

    def submitted(self, tenant: str) -> float:
        t = self.clock()
        self._submitted[tenant] = self._submitted.get(tenant, 0) + 1
        if self._t_first is None:
            self._t_first = t
        return t

    def completed(self, tenant: str, t_submit: float,
                  batched: bool) -> float:
        t = self.clock()
        self._completed[tenant] = self._completed.get(tenant, 0) + 1
        if not batched:
            self._solo[tenant] = self._solo.get(tenant, 0) + 1
        self._latencies.setdefault(tenant, []).append(t - t_submit)
        self._t_last = t
        return t - t_submit

    def batch_executed(self, key: str, size: int, dispatches: int,
                       wall_s: float) -> None:
        self.batches.append({"key": key, "size": size,
                             "dispatches": dispatches,
                             "wall_s": wall_s})

    def stream_push(self, tenant: str) -> None:
        self._stream_pushes[tenant] = \
            self._stream_pushes.get(tenant, 0) + 1

    # -- reporting -----------------------------------------------------------

    def tenant_stats(self, tenant: str) -> dict:
        lat = self._latencies.get(tenant, [])
        return {"submitted": self._submitted.get(tenant, 0),
                "completed": self._completed.get(tenant, 0),
                "solo_fallbacks": self._solo.get(tenant, 0),
                "stream_pushes": self._stream_pushes.get(tenant, 0),
                "p50_ms": _ms(percentile(lat, 50)),
                "p99_ms": _ms(percentile(lat, 99))}

    def snapshot(self) -> dict:
        tenants = sorted(set(self._submitted) | set(self._completed)
                         | set(self._stream_pushes))
        all_lat = [v for lat in self._latencies.values() for v in lat]
        total = sum(self._completed.values())
        window = ((self._t_last - self._t_first)
                  if self._t_first is not None
                  and self._t_last is not None else 0.0)
        return {
            "tenants": {t: self.tenant_stats(t) for t in tenants},
            "total_queries": total,
            "total_batches": len(self.batches),
            "solo_fallbacks": sum(self._solo.values()),
            "p50_ms": _ms(percentile(all_lat, 50)),
            "p99_ms": _ms(percentile(all_lat, 99)),
            "queries_per_s": (total / window if window > 0 else None),
            "dispatches_per_batch": (
                [b["dispatches"] for b in self.batches] or None),
        }
