"""Fabric arbiter — shared congestion-pricing layer for multi-tenant
runtimes (DESIGN.md §4); counterpart of ``repro/fabric``.

One fabric, N tenants (serving jobs, MoE layer groups), each with its own
MWU planner: this package coordinates them.  ``FabricState`` is the ledger
of per-tenant committed load; ``FabricArbiter`` exports weighted congestion
prices into every tenant's solve (``ext_loads``), iterates sequential-
greedy sweeps to a priced equilibrium, gates replans (token bucket + QoS),
broadcasts link events over the shared ``LinkEventBus``, and accounts
fairness (Jain's index, weighted max-min violation) through
``repro_torch.jsonio``.
"""

from .admission import AdmissionConfig, AdmissionDecision, TokenBucket
from .arbiter import (
    ArbiterConfig,
    ArbiterStats,
    FabricArbiter,
    QOS_RANK,
    RepriceDecision,
    TenantConfig,
)
from .fairness import (
    fairness_report,
    jains_index,
    maxmin_violation,
    weighted_drains,
)
from .state import FabricState

__all__ = [
    "AdmissionConfig",
    "AdmissionDecision",
    "TokenBucket",
    "ArbiterConfig",
    "ArbiterStats",
    "FabricArbiter",
    "QOS_RANK",
    "RepriceDecision",
    "TenantConfig",
    "fairness_report",
    "jains_index",
    "maxmin_violation",
    "weighted_drains",
    "FabricState",
]
