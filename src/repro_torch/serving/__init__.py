"""Selection as a service (answers `src/repro/serving/`): `QueryEngine`
admission-batches compatible one-shot queries into single resident-loop
dispatches; `TenantSession`/`SessionManager` run per-tenant continuous
streams on the machinery of stream_select_continuous; `ServeMetrics`
records per-tenant latency and per-batch dispatch counts."""
from repro_torch.serving.engine import (Query, QueryEngine, QueryResult,
                                        QueueFull)
from repro_torch.serving.metrics import ServeMetrics, percentile
from repro_torch.serving.session import SessionManager, TenantSession

__all__ = ["Query", "QueryEngine", "QueryResult", "QueueFull",
           "ServeMetrics", "percentile", "SessionManager",
           "TenantSession"]
