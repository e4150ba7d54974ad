"""Metrics registry for the flight recorder (DESIGN.md §11).

Counterpart of ``repro/obs/metrics.py``, copied as it is (the stdlib only).

One process-wide bag of named counters / gauges / histograms with
labels, snapshot as a ``nimble.metrics/v1`` record.  The registry
absorbs the health signals that previously lived in scattered stats
objects — ``RuntimeStats.reprices``, ``ArbiterStats.evictions``, gated
windows, telemetry ``rejected`` counters, estimator ``confidence`` —
into one scrapeable schema embedded in ``Session.report()`` and the
``nimble.serve/v1`` record.

Naming convention (pinned in DESIGN.md §11): ``nimble_<layer>_<name>``
with ``_total`` suffix for monotonic counts, snake-case labels
(``tenant``, ``scenario``, ``mode``).  Snapshots are deterministic
(sorted by name then labels) and JSON-native, so they round-trip
bit-exact through :mod:`repro_torch.jsonio`.

The collectors at the bottom (:func:`collect_runtime`,
:func:`collect_arbiter`) are pull-based: they duck-type over live
runtime / arbiter objects at snapshot time, so the hot per-window path
pays nothing for them.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

from ..jsonio import tag

METRICS_KIND = "metrics"

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: Default histogram bucket upper bounds (seconds-ish, log-spaced).
DEFAULT_BUCKETS = (
    0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[dict]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic count.  ``inc`` rejects negative increments."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Cumulative-bucket histogram with explicit upper bounds."""

    __slots__ = ("bounds", "counts", "total", "count", "vmin", "vmax")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram bounds must be sorted unique: {b}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)   # last bucket = +inf
        self.total = 0.0
        self.count = 0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for bound in self.bounds:
            if v <= bound:
                break
            i += 1
        self.counts[i] += 1
        self.total += v
        self.count += 1
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)


class MetricsRegistry:
    """Named metrics with labels; deterministic JSON snapshots."""

    def __init__(self):
        # (name, label_key) -> (type, instrument)
        self._metrics: Dict[Tuple[str, _LabelKey], Tuple[str, object]] = {}

    def _get(self, kind: str, name: str, labels: Optional[dict],
             factory) -> object:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        key = (name, _label_key(labels))
        hit = self._metrics.get(key)
        if hit is not None:
            if hit[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {hit[0]}, "
                    f"requested {kind}"
                )
            return hit[1]
        inst = factory()
        self._metrics[key] = (kind, inst)
        return inst

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        return self._metrics_typed("counter", name, labels, Counter)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        return self._metrics_typed("gauge", name, labels, Gauge)

    def histogram(self, name: str, labels: Optional[dict] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        factory = (lambda: Histogram(buckets)) if buckets else Histogram
        return self._metrics_typed("histogram", name, labels, factory)

    def _metrics_typed(self, kind, name, labels, factory):
        return self._get(kind, name, labels, factory)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """All metrics as one ``nimble.metrics/v1`` record (sorted)."""
        out = []
        for (name, lkey), (kind, inst) in sorted(self._metrics.items()):
            rec = {"name": name, "type": kind, "labels": dict(lkey)}
            if kind == "histogram":
                h = inst
                rec.update({
                    "count": h.count,
                    "sum": h.total,
                    "min": h.vmin,
                    "max": h.vmax,
                    "buckets": [
                        [b, c] for b, c in zip(
                            list(h.bounds) + ["+inf"], h.counts
                        )
                    ],
                })
            else:
                rec["value"] = inst.value
            out.append(rec)
        return tag(METRICS_KIND, {"metrics": out})


# -- pull-based collectors --------------------------------------------------
#
# Duck-typed over the live objects so repro_torch.obs never imports the runtime
# or fabric layers (no cycles); called at snapshot/report time only.

def collect_runtime(reg: MetricsRegistry, runtime,
                    tenant: str = "default") -> None:
    """Absorb OrchestrationRuntime stats + estimator/telemetry health."""
    labels = {"tenant": tenant}
    s = runtime.stats

    def g(name: str, value) -> None:
        reg.gauge(name, labels).set(float(value))

    g("nimble_runtime_windows_total", s.windows)
    g("nimble_runtime_replans_total", s.replans)
    g("nimble_runtime_solves_total", s.solves)
    g("nimble_runtime_cache_hits_total", s.cache_hits)
    g("nimble_runtime_swaps_total", s.swaps)
    g("nimble_runtime_fault_events_total", s.events)
    g("nimble_runtime_reprices_total", s.reprices)
    g("nimble_runtime_watchdog_abandons_total", s.watchdog_abandons)
    g("nimble_runtime_gated_windows_total", getattr(s, "gated", 0))
    g("nimble_estimator_confidence", runtime.estimator.confidence)
    g("nimble_estimator_missing_windows_total",
      runtime.estimator.missing_windows)
    health = runtime.telemetry.health()
    g("nimble_telemetry_windows_total", health["windows"])
    g("nimble_telemetry_rejected_records_total", health["rejected"])
    g("nimble_telemetry_utilization_imbalance",
      health["utilization_imbalance"])
    pol = runtime.policy.state_snapshot()
    g("nimble_policy_armed", int(pol["armed"]))
    g("nimble_policy_breach_windows", pol["breach"])
    g("nimble_policy_flap_level", pol["flap_level"])
    g("nimble_plan_version", runtime.active_version)


def collect_arbiter(reg: MetricsRegistry, arbiter) -> None:
    """Absorb FabricArbiter stats + per-tenant ledger staleness."""
    s = arbiter.stats

    def g(name: str, value, labels: Optional[dict] = None) -> None:
        reg.gauge(name, labels).set(float(value))

    g("nimble_fabric_solves_total", s.solves)
    g("nimble_fabric_sweeps_total", s.sweeps)
    g("nimble_fabric_admitted_total", s.admitted)
    g("nimble_fabric_throttled_total", s.throttled)
    g("nimble_fabric_commits_total", s.commits)
    g("nimble_fabric_price_hints_total", s.price_hints)
    g("nimble_fabric_reprices_total", s.reprices)
    g("nimble_fabric_evictions_total", s.evictions)
    g("nimble_fabric_tenants", len(arbiter.tenants()))
    summary = arbiter.state.summary()
    g("nimble_fabric_clock", summary["clock"])
    g("nimble_fabric_combined_drain_s", summary["combined_drain_s"])
    for tenant, stale in summary["staleness"].items():
        g("nimble_fabric_ledger_staleness", stale, {"tenant": tenant})


def collect_session(reg: MetricsRegistry, session) -> None:
    """One call per Session — runtime (if adaptive) + arbiter (if priced)."""
    runtime = getattr(session, "runtime", None)
    if runtime is not None:
        collect_runtime(reg, runtime, tenant=session.spec.tenant)
    arbiter = getattr(session, "arbiter", None)
    if arbiter is not None:
        collect_arbiter(reg, arbiter)
