"""NIMBLE-aware static invariant checker, over the PyTorch port.

Counterpart of ``repro/analysis`` (stdlib ``ast`` only, so it is a copy,
not an import), linting ``src/repro_torch``.  The port's conventions are
the reference's — ``core``/``fabric``/``faults`` stay seed-deterministic
(torch's global RNG included), every cross-file record carries a frozen
``nimble.<kind>/vN`` schema, frozen specs stay frozen, NaN is a telemetry
sentinel that never meets ``==`` — plus one of its own: a step's path
reads nothing back from the card that tracks the plan.  The package holds

  * a :class:`~repro_torch.analysis.engine.Rule` protocol + registry
    (:data:`RULES`: ``determinism``, ``schema-discipline``,
    ``frozen-spec``, ``float-eq``, ``host-sync``, ``units``,
    ``xmodule-determinism``, plus ``suppression`` and ``baseline``
    hygiene);
  * a shared per-file resolution context
    (:class:`~repro_torch.analysis.context.FileContext`): import/alias
    resolution, frozen-dataclass detection, the step entry points;
  * a whole-program layer (:mod:`repro_torch.analysis.callgraph`) — cached
    per-function summaries, the call graph, reachability — under three
    interprocedural rules: ``host-sync`` (the host syncs a step reaches, in
    the {TOPOLOGY_STABLE, WINDOW_DEPENDENT, PLAN_DEPENDENT} lattice,
    inventoried as ``nimble.retrace/v1`` and pinned by
    ``retrace.lock.json``; the port's counterpart of the reference's
    ``jit-purity`` and ``retrace-provenance``, which check JAX tracing),
    ``units`` and ``xmodule-determinism``;
  * inline suppressions — ``# nimble: ignore[<rule-id>] -- reason`` —
    with a mandatory written justification;
  * a committed baseline (``baseline.json``): the port's known PLAN_DEPENDENT
    host syncs, each with the ROADMAP item that retires it (``--debt``
    prints the ledger; stale or reasonless entries are findings);
  * a generated ``schemas.lock.json`` of the port's record sites
    (regenerate with ``--write-lock``);
  * a ``nimble.lint/v1`` JSON report through :mod:`repro_torch.jsonio`.

CLI::

    python -m repro_torch.analysis                 # lint src/repro_torch, exit != 0 on findings
    python -m repro_torch.analysis --json report.json
    python -m repro_torch.analysis --write-lock    # regenerate both locks + cache
    python -m repro_torch.analysis --check-lock    # lock freshness (no-op regen?)
    python -m repro_torch.analysis --debt          # suppression/baseline ledger
    python -m repro_torch.analysis --retrace-out - # the host-sync inventory

Gating: ``python -m repro_torch.api.selfcheck`` check 8 fails closed on
any non-baselined finding or a stale lock; on the card,
``launch/sync_audit.py`` holds the inventory against the syncs a real step
makes.
"""

from __future__ import annotations

from .callgraph import (
    CallGraph,
    FunctionSummary,
    Program,
    SummaryCache,
    build_program,
)
from .context import FileContext, build_context
from .engine import (
    AnalysisEngine,
    AnalysisReport,
    Finding,
    Rule,
    analyze_paths,
    analyze_source,
    analyze_sources,
    collect_debt,
    default_baseline_path,
    default_lock_path,
    load_baseline,
)
from .provenance import (
    HOST_SYNC,
    PLAN_DEPENDENT,
    TOPOLOGY_STABLE,
    WINDOW_DEPENDENT,
    analyze_program,
    build_retrace_inventory,
    default_retrace_lock_path,
    retrace_lock_is_fresh,
)
from .rules import RULES, generate_schema_lock
from .schemas import lock_is_fresh
from .units import analyze_units, build_units_inventory

__all__ = [
    "AnalysisEngine",
    "AnalysisReport",
    "CallGraph",
    "FileContext",
    "Finding",
    "FunctionSummary",
    "HOST_SYNC",
    "PLAN_DEPENDENT",
    "Program",
    "RULES",
    "Rule",
    "SummaryCache",
    "TOPOLOGY_STABLE",
    "WINDOW_DEPENDENT",
    "analyze_paths",
    "analyze_program",
    "analyze_source",
    "analyze_sources",
    "analyze_units",
    "build_context",
    "build_program",
    "build_retrace_inventory",
    "build_units_inventory",
    "collect_debt",
    "default_baseline_path",
    "default_lock_path",
    "default_retrace_lock_path",
    "generate_schema_lock",
    "load_baseline",
    "lock_is_fresh",
    "retrace_lock_is_fresh",
]
