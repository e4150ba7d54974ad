"""``repro_torch.obs`` — the metrics registry of the flight recorder.

Counterpart of ``repro/obs``, for now its metrics only:
:class:`~repro_torch.obs.metrics.MetricsRegistry` (counters / gauges /
histograms snapshot as ``nimble.metrics/v1``) and the pull-based collectors
that ``Session.report()`` embeds.  The tracer, the plan-provenance log and
the ``FlightRecorder`` that bundles them come with the port of the fault
harness (ROADMAP Queue 1 item 4).
"""

from .metrics import (
    MetricsRegistry,
    collect_arbiter,
    collect_runtime,
    collect_session,
)

__all__ = [
    "MetricsRegistry",
    "collect_arbiter",
    "collect_runtime",
    "collect_session",
]
