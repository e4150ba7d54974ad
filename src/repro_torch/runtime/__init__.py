"""Execution-time orchestration runtime, ported.

The monitor -> estimate -> replan -> swap loop on top of the planner core:
per-resource telemetry, EWMA + skew-burst demand estimation, hysteresis
replan triggers, a double-buffered plan cache with atomic boundary swaps,
and link-fault events that rebuild the planner tables.  Each replan is
solved by the tensor planner on the runtime's device (the card unless the
caller names the CPU).  Multiple runtimes sharing one fabric are
coordinated by the fabric arbiter (``repro_torch.fabric``) via
``register_runtime``.
"""

from .controller import (
    OrchestrationRuntime,
    PlanHandle,
    RuntimeConfig,
    RuntimeStats,
    TraceResult,
    WindowReport,
    demand_dict,
    run_oracle,
    run_static,
    solve_plans_batch,
)
from .estimator import DemandEstimator, EstimatorConfig
from .events import (
    EventLog,
    LinkEvent,
    PricesMovedHint,
    link_degraded,
    link_down,
    link_restored,
)
from .policy import NeverReplan, PolicyConfig, ReplanDecision, ReplanPolicy
from .telemetry import LinkTelemetry, TelemetryWindow
from .traces import balanced_trace, drifting_skew_trace, skew_burst_trace

__all__ = [
    "OrchestrationRuntime",
    "PlanHandle",
    "RuntimeConfig",
    "RuntimeStats",
    "TraceResult",
    "WindowReport",
    "demand_dict",
    "run_oracle",
    "run_static",
    "solve_plans_batch",
    "DemandEstimator",
    "EstimatorConfig",
    "EventLog",
    "LinkEvent",
    "PricesMovedHint",
    "link_degraded",
    "link_down",
    "link_restored",
    "NeverReplan",
    "PolicyConfig",
    "ReplanDecision",
    "ReplanPolicy",
    "LinkTelemetry",
    "TelemetryWindow",
    "balanced_trace",
    "drifting_skew_trace",
    "skew_burst_trace",
]
