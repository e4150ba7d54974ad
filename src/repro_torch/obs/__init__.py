"""``repro_torch.obs`` — the flight recorder, counterpart of ``repro/obs``.

One :class:`FlightRecorder` bundles the three observability surfaces:

* :class:`~repro_torch.obs.trace.Tracer` — typed spans/events exported as
  Chrome/Perfetto trace JSON (``nimble.trace/v1``);
* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
  histograms snapshot as ``nimble.metrics/v1``;
* :class:`~repro_torch.obs.provenance.ProvenanceLog` — a plan-provenance
  audit trail queryable after the run.

Attach one recorder at the top (``Session(spec, recorder=rec)`` or
``ControlPlane(spec, mode, recorder=rec)``) and every layer below —
runtime, fabric arbiter, planner solves — records into it under one
correlation id.  The instrumentation sites are duck-typed and guarded
by a single ``is None`` check, so a run without a recorder pays one
branch a site and its reports are those of a recorded run (pinned by
``tests/test_torch_obs.py`` and the obs section of
``repro_torch.launch.drills``).
"""

from __future__ import annotations

import itertools

from .metrics import (
    MetricsRegistry,
    collect_arbiter,
    collect_runtime,
    collect_session,
)
from .provenance import PlanProvenance, ProvenanceLog, price_summary
from .trace import Tracer, validate_trace

_CORR_COUNTER = itertools.count(1)


class FlightRecorder:
    """Tracer + metrics + provenance under one correlation id."""

    def __init__(self, correlation_id: str | None = None, *,
                 enabled: bool = True, trace_capacity: int = 1_000_000):
        if correlation_id is None:
            correlation_id = f"nimble-{next(_CORR_COUNTER)}"
        self.correlation_id = correlation_id
        self.enabled = bool(enabled)
        self.tracer = Tracer(correlation_id, capacity=trace_capacity)
        self.metrics = MetricsRegistry()
        self.provenance = ProvenanceLog()

    @classmethod
    def disabled(cls) -> "FlightRecorder":
        """A recorder every instrumentation site treats as absent."""
        return cls("disabled", enabled=False)

    def export_trace(self) -> dict:
        """``nimble.trace/v1`` Chrome trace JSON of everything recorded."""
        return self.tracer.export()

    def metrics_snapshot(self) -> dict:
        """``nimble.metrics/v1`` snapshot of the registry."""
        return self.metrics.snapshot()

    def __repr__(self) -> str:
        return (
            f"FlightRecorder({self.correlation_id!r}, "
            f"enabled={self.enabled}, events={len(self.tracer)}, "
            f"metrics={len(self.metrics)}, plans={len(self.provenance)})"
        )


__all__ = [
    "FlightRecorder",
    "MetricsRegistry",
    "PlanProvenance",
    "ProvenanceLog",
    "Tracer",
    "collect_arbiter",
    "collect_runtime",
    "collect_session",
    "price_summary",
    "validate_trace",
]
