"""NIMBLE core, ported: execution-time multi-path communication balancing.

Public API (counterpart of ``repro/core/__init__.py``):
  Topology / LinkCaps        — interconnect model (topology.py)
  CostModel / ResourceModel  — capacity-normalized cost F(L) (cost.py)
  solve_mwu / solve_direct / solve_static_striping — Algorithm 1 + baselines
  simulate / simulate_nccl_rounds — fabric simulator (fabsim.py)
  PathIncidence / incidence_for — cached sparse planner core (incidence.py)
  PlannerConfig / plan_flows / plan_flows_batch — the tensor planner
  NimbleAllToAll             — scheduled stacked-rank dataplane (dataplane.py)
  MoEDispatcher              — expert-parallel dispatch/combine (moe_comm.py)
"""

from .cost import CostModel, ResourceModel
from .dataplane import NimbleAllToAll, ref_all_to_allv
from .fabsim import SimResult, simulate, simulate_nccl_rounds
from .incidence import PathIncidence, incidence_for, topology_fingerprint
from .mcf import (
    Plan,
    congestion_lower_bound,
    solve_degraded,
    solve_direct,
    solve_mwu,
    solve_static_striping,
)
from .moe_comm import MoECommConfig, MoEDispatcher
from .paths import Path, all_pairs_paths, enumerate_paths
from .planner import (
    PlannerConfig,
    plan_chunks,
    plan_flows,
    plan_flows_batch,
    planner_provenance,
    quantize_chunks,
)
from .schedule import build_planner_tables, build_schedule
from .topology import LinkCaps, Topology

__all__ = [
    "Topology", "LinkCaps", "CostModel", "ResourceModel", "Plan",
    "solve_mwu", "solve_direct", "solve_static_striping", "solve_degraded",
    "congestion_lower_bound", "simulate", "simulate_nccl_rounds", "SimResult",
    "PlannerConfig", "plan_flows", "plan_flows_batch", "quantize_chunks",
    "plan_chunks", "planner_provenance",
    "PathIncidence", "incidence_for", "topology_fingerprint",
    "build_schedule", "build_planner_tables",
    "NimbleAllToAll", "ref_all_to_allv",
    "MoECommConfig", "MoEDispatcher",
    "Path", "enumerate_paths", "all_pairs_paths",
]
