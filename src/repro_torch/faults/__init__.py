"""Deterministic fault injection + drill harness.

Counterpart of ``repro/faults`` (numpy and the stdlib only): the same
specs, the same seeded schedules byte for byte (``FaultSchedule.digest``),
the same drill accounting.

Declarative, seeded fault scenarios — link flap trains, rail/NIC loss,
telemetry blackout/dropout, stragglers, tenant crashes, background
elephants — compiled by :class:`FaultInjector` into schedules the
existing runtime machinery consumes (``EventLog`` link events, telemetry
perturbations through ``OrchestrationRuntime.step``).  Same seed + spec
-> bit-identical schedule (``FaultSchedule.digest``); the graceful-
degradation paths these drills exercise live in the layers themselves
(estimator confidence fallback, policy flap backoff, runtime watchdog,
planner degraded mode, fabric staleness eviction).
"""

from .harness import DrillResult, arm_events, run_drill
from .injector import FaultInjector, FaultSchedule
from .scenarios import (
    ElephantFlowSpec,
    FaultScenario,
    LinkFlapSpec,
    RailLossSpec,
    StragglerSpec,
    TelemetryBlackoutSpec,
    TenantCrashSpec,
)

__all__ = [
    "DrillResult",
    "arm_events",
    "run_drill",
    "FaultInjector",
    "FaultSchedule",
    "ElephantFlowSpec",
    "FaultScenario",
    "LinkFlapSpec",
    "RailLossSpec",
    "StragglerSpec",
    "TelemetryBlackoutSpec",
    "TenantCrashSpec",
]
