"""Drill harness — drive a runtime through a compiled fault schedule.

:func:`run_drill` replays a traffic trace through one runtime (or
:class:`~repro_torch.api.Session`) while the :class:`~repro_torch.faults.injector.
FaultSchedule` perturbs every window: link events are armed into the
runtime's event log up front, elephants are added to the executed demand,
blackouts/dropouts filter what telemetry observes, and stragglers inflate
the measured completion.  The result wraps the per-window reports with
the recovery/availability accounting the fault drills gate on
(``repro_torch.launch.drills``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..jsonio import tag
from ..runtime.controller import WindowReport
from .injector import FaultSchedule


def _unwrap_runtime(runtime_or_session):
    """Accept an OrchestrationRuntime or a Session wrapping one."""
    inner = getattr(runtime_or_session, "runtime", None)
    return inner if inner is not None else runtime_or_session


def arm_events(runtime_or_session, schedule: FaultSchedule) -> int:
    """Schedule the fault timeline's link events into the runtime's log."""
    rt = _unwrap_runtime(runtime_or_session)
    for ev in schedule.events:
        rt.events.schedule(ev)
    return len(schedule.events)


@dataclasses.dataclass
class DrillResult:
    """Per-window reports of one drill plus fault-drill accounting."""

    reports: List[WindowReport]
    schedule: FaultSchedule

    @property
    def total_completion_s(self) -> float:
        return float(sum(r.completion_s for r in self.reports))

    def completions(self) -> np.ndarray:
        return np.array([r.completion_s for r in self.reports])

    def healthy_median_s(self, until: int) -> float:
        """Median completion over windows ``[0, until)`` — the pre-fault
        reference the recovery/availability metrics compare against."""
        pre = [r.completion_s for r in self.reports if r.window < until]
        return float(np.median(pre)) if pre else 0.0

    def availability(self, ref_completion_s: float,
                     factor: float = 5.0) -> float:
        """Fraction of windows with a *live* plan: completion within
        ``factor`` x the healthy reference (a plan funneling traffic onto
        a dead link blows far past this; a merely degraded fabric does
        not)."""
        if not self.reports or ref_completion_s <= 0:
            return 1.0
        ok = sum(
            1 for r in self.reports
            if r.completion_s <= factor * ref_completion_s
        )
        return ok / len(self.reports)

    def recovery_window(self, after: int, threshold_s: float
                        ) -> Optional[int]:
        """First window >= ``after`` whose completion is back under
        ``threshold_s`` (None if the drill never recovers)."""
        return next(
            (
                r.window
                for r in self.reports
                if r.window >= after and r.completion_s <= threshold_s
            ),
            None,
        )

    def replans_by_reason(self) -> Dict[str, int]:
        """Issued-replan count per reason (plus suppressed ``backoff`` and
        ``gated`` windows, which issue nothing but are drill signals)."""
        counts: collections.Counter = collections.Counter()
        for r in self.reports:
            if r.replan_issued or r.replan_reason in ("backoff", "gated"):
                counts[r.replan_reason] += 1
        return dict(counts)

    @property
    def replan_count(self) -> int:
        return sum(1 for r in self.reports if r.replan_issued)

    @property
    def backoff_windows(self) -> List[int]:
        """Windows where the flap backoff suppressed a topology replan."""
        return [
            r.window for r in self.reports if r.replan_reason == "backoff"
        ]

    def to_json_obj(self) -> dict:
        return tag(
            "fault_drill",
            {
                "scenario": self.schedule.scenario.name,
                "digest": self.schedule.digest(),
                "windows": len(self.reports),
                "total_completion_s": self.total_completion_s,
                "replans": self.replan_count,
                "replans_by_reason": self.replans_by_reason(),
                "backoff_windows": self.backoff_windows,
            },
        )


def run_drill(
    runtime_or_session,
    trace: np.ndarray,               # [W, n, n]
    schedule: FaultSchedule,
    tenant: Optional[str] = None,
) -> DrillResult:
    """Replay ``trace`` through the runtime under ``schedule``'s faults.

    ``tenant`` (when given) honors the schedule's crash specs: stepping
    stops cold at the tenant's crash window — no teardown, no final
    commit — exactly the no-heartbeat failure the fabric's staleness
    eviction exists for.  The caller owns event arming when it wants
    broadcast semantics instead; by default the link events are armed
    into the runtime's own log here.
    """
    rt = _unwrap_runtime(runtime_or_session)
    arm_events(rt, schedule)
    reports: List[WindowReport] = []
    for w in range(len(trace)):
        if tenant is not None and schedule.crashed(tenant, w):
            break
        demand = schedule.perturbed_demand(w, trace[w])
        observed = schedule.observed_demand(w, demand)
        reports.append(
            rt.step(
                demand,
                observed=observed,
                completion_scale=schedule.completion_scale(w),
            )
        )
    return DrillResult(reports=reports, schedule=schedule)
