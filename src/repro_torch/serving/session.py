"""Per-tenant continuous selection sessions (answers
`src/repro/serving/session.py`).

A `TenantSession` serves a tenant whose candidates ARRIVE over time. It
owns a `streaming.driver.ContinuousSelector` — the push/merge machinery
behind `stream_select_continuous` — so a session that pushes batches
B1..Bn and then calls query() returns what a one-shot
`stream_select_continuous(objective, [B1..Bn], k, …)` run with the same
knobs returns. `SessionManager` multiplexes sessions of many tenants
over one shared ServeMetrics.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.greedy import Solution
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.streaming.driver import ContinuousSelector


class TenantSession:
    """One tenant's always-on selection stream: push() folds an arrival
    batch into the tenant's lanes, query() returns the current merged
    Solution (monotone between calls), info() the selector's counters."""

    def __init__(self, tenant: str, objective, k: int, *,
                 metrics: Optional[ServeMetrics] = None, **selector_kw):
        self.tenant = tenant
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.selector = ContinuousSelector(objective, k, **selector_kw)

    def push(self, ids, payloads, valid) -> "TenantSession":
        self.selector.push(ids, payloads, valid)
        self.metrics.stream_push(self.tenant)
        return self

    def query(self) -> Solution:
        """The stream's current answer (merges any unmerged tail)."""
        return self.selector.result()

    def info(self) -> dict:
        d = self.selector.info()
        d["tenant"] = self.tenant
        return d


class SessionManager:
    """Open/lookup/close TenantSessions sharing one ServeMetrics."""

    def __init__(self, metrics: Optional[ServeMetrics] = None):
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._sessions: Dict[str, TenantSession] = {}

    def open(self, tenant: str, objective, k: int,
             **selector_kw) -> TenantSession:
        if tenant in self._sessions:
            raise ValueError(f"session already open for {tenant!r}")
        s = TenantSession(tenant, objective, k, metrics=self.metrics,
                          **selector_kw)
        self._sessions[tenant] = s
        return s

    def get(self, tenant: str) -> TenantSession:
        return self._sessions[tenant]

    def close(self, tenant: str) -> Solution:
        """Close a session, returning its final answer."""
        return self._sessions.pop(tenant).query()

    def tenants(self):
        return sorted(self._sessions)
