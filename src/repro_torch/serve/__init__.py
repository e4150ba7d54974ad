"""Serving control plane: scenario registry + continuous-traffic harness.

Counterpart of ``repro/serve``.  ``repro_torch.serve.scenario`` declares
*what* to serve (tenant mixes, traffic programs, churn, embedded fault
drills, SLO gates — all JSON-round-trip data); ``repro_torch.serve.
controlplane`` *runs* it (spawn → serve → drill → retire over shared-fabric
``Session``\\ s, every solve on the run's device, online SLO accounting,
``nimble.serve/v1`` reports); ``repro_torch.serve.engine`` is the
model-level token-serving engine behind ``launch/serve.py``'s generation
mode.

The engine is imported lazily — scenario/control-plane users (the drills,
the selfcheck) don't pay for the model registry and its kernels.
"""

from .controlplane import (
    ControlPlane,
    RingPercentiles,
    ServeReport,
    TenantLedger,
    evaluate_scenario,
    evaluate_slo,
    run_scenario,
    validate_serve_record,
)
from .scenario import (
    BUILTIN_SCENARIOS,
    ChurnSpec,
    ScenarioSpec,
    SloSpec,
    TenantSpec,
    TrafficProgram,
    compile_churn,
    get_scenario,
    load_scenario,
    scenario_names,
)

__all__ = [
    "BUILTIN_SCENARIOS",
    "ChurnSpec",
    "ControlPlane",
    "RingPercentiles",
    "ScenarioSpec",
    "ServeEngine",
    "ServeReport",
    "SloSpec",
    "TenantLedger",
    "TenantSpec",
    "TrafficProgram",
    "compile_churn",
    "evaluate_scenario",
    "evaluate_slo",
    "get_scenario",
    "load_scenario",
    "run_scenario",
    "scenario_names",
    "validate_serve_record",
]


def __getattr__(name):
    if name == "ServeEngine":
        from .engine import ServeEngine
        return ServeEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
