"""``nimble.Session`` — the endpoint-driven front door (DESIGN.md §5).

Counterpart of ``repro/api/session.py``.  The port's ranks are stacked in
one process, so its endpoints take no mesh ``axis_name``; the session's
runtime solves on ``SessionSpec.device`` (the card unless the caller names
the CPU), and a session asking for the card on a host without one raises.
``Session(spec, recorder=rec)`` threads a :class:`repro_torch.obs.FlightRecorder`
to the runtime (from its initial solve on) and to the arbiter, as the
reference does; a disabled recorder or ``None`` leaves the session
unrecorded.

One facade owns lifecycle and composition for the whole stack: it builds
the fabric from a :class:`~repro_torch.api.spec.SessionSpec`, caches the
incidence tables, instantiates the orchestration runtime (adaptive+),
joins — or constructs — the shared fabric arbiter (arbitrated), and hands
out *ready-wired* endpoints:

  * :meth:`all_to_all` / :meth:`moe_dispatcher` — dataplane endpoints with
    telemetry already attached to the session's runtime;
  * :meth:`plan` — host-level solve, congestion-priced when arbitrated;
  * :meth:`step` / :meth:`run_trace` / :meth:`run_oracle` — the runtime
    loop (``run_trace`` on a static session is the one-shot baseline);
  * :meth:`report` — one tagged ``nimble.session/v1`` record embedding the
    existing ``nimble.<kind>/vN`` sub-schemas (runtime stats, telemetry
    aggregate, fabric fairness).

State machine: ``active`` (constructed; __enter__ requires it) → ``closed``
(:meth:`close` or context-manager exit: arbiter tenant unregistered —
ledger load withdrawn, bus unsubscribed — endpoint caches dropped; every
further call raises).  Closing is idempotent.

The facade adds *no* planning semantics: a Session-built stack produces
**byte-identical** plans and window reports to the hand-wired stack it
replaces (``tests/test_torch_session.py`` pins static, adaptive, and
arbitrated configurations against the reference's facade).  Direct construction of ``NimbleAllToAll`` /
``OrchestrationRuntime`` / ``FabricArbiter`` keeps working unchanged; the
facade is the recommended path, not the only one.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from ..core.dataplane import NimbleAllToAll
from ..core.mcf import Plan, solve_direct, solve_mwu, solve_static_striping
from ..core.moe_comm import MoECommConfig, MoEDispatcher
from ..core.planner import PlannerConfig
from ..core.schedule import build_planner_tables
from ..fabric import FabricArbiter, TenantConfig
from ..jsonio import tag
from ..runtime import (
    OrchestrationRuntime,
    RuntimeConfig,
    TraceResult,
    demand_dict,
    run_oracle,
    run_static,
)
from ..runtime.controller import solve_device
from .spec import SessionSpec

#: host-plan modes understood by :meth:`Session.plan`
PLAN_MODES = ("nimble", "direct", "stripe")


class Session:
    """Wired NIMBLE stack behind one declarative spec.

    ``Session(spec)`` — or ``Session(topology=..., adaptivity=...)`` as a
    convenience for inline specs — performs all construction and binding
    in the canonical order (fabric → tables → runtime → arbiter join, the
    order ``register_runtime`` needs to keep ledger, gate, and bus in
    sync).  Use as a context manager so the tenant's ledger share is
    released on exit.
    """

    def __init__(self, spec: Optional[SessionSpec] = None, *,
                 recorder=None, **spec_kwargs):
        if spec is None:
            spec = SessionSpec(**spec_kwargs)
        elif spec_kwargs:
            raise TypeError("pass either a SessionSpec or its fields, not both")
        # the card unless the spec names the CPU; no card raises here
        solve_device(spec.device)
        self.spec = spec
        # flight recorder: stored *before* the runtime is built so the
        # construction-time initial solve is traced under this session's
        # correlation id.  None (the default) leaves every layer on its
        # unrecorded code path.
        self._recorder = (
            recorder
            if recorder is not None and getattr(recorder, "enabled", False)
            else None
        )
        self.topo = spec.build_topology()
        self.cost_model = spec.build_cost_model()
        # incidence tables are fingerprint-cached (DESIGN.md §2.2); building
        # them here warms the cache every endpoint and solve will hit
        self.tables = build_planner_tables(self.topo, self.cost_model)
        self.runtime: Optional[OrchestrationRuntime] = None
        self.arbiter: Optional[FabricArbiter] = None
        self._owns_fabric = False
        self._registered = False
        self._endpoints: dict = {}
        self._last_trace: Optional[TraceResult] = None

        if spec.adaptivity in ("adaptive", "arbitrated"):
            self.runtime = OrchestrationRuntime.from_session(self)
        if spec.adaptivity == "arbitrated":
            if spec.fabric is not None:
                self.arbiter = spec.fabric
            else:
                self.arbiter = FabricArbiter.from_session(self)
                self._owns_fabric = True
            self.arbiter.register_runtime(
                spec.tenant, self.runtime, spec.tenant_config()
            )
            self._registered = True
        if self._recorder is not None and self.arbiter is not None:
            # shared fabrics: every joining session attaches the same
            # recorder — idempotent, last attach wins
            self.arbiter.attach_recorder(self._recorder)
        self._state = "active"

    # -- lifecycle ---------------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def recorder(self):
        """The attached :class:`repro_torch.obs.FlightRecorder` (None when the
        session runs unrecorded)."""
        return self._recorder

    @property
    def fabric(self) -> Optional[FabricArbiter]:
        """The shared arbiter (None unless arbitrated).  Hand this to a
        second session's ``SessionSpec(fabric=...)`` to co-tenant it."""
        return self.arbiter

    @property
    def tenant(self) -> str:
        return self.spec.tenant

    def _require_active(self) -> None:
        if self._state != "active":
            raise RuntimeError(
                f"session {self.spec.tenant!r} is {self._state}; "
                "construct a new Session"
            )

    def close(self) -> None:
        """Tear the session down: release the ledger share, unsubscribe
        from the bus, drop endpoint caches.  Idempotent."""
        if self._state == "closed":
            return
        if self._registered and self.arbiter is not None:
            # unregister withdraws committed load, unbinds the runtime,
            # and unsubscribes the bus callback — the reverse of the
            # register_runtime composition
            self.arbiter.unregister(self.spec.tenant)
        self._registered = False
        self._endpoints.clear()
        self._state = "closed"

    def __enter__(self) -> "Session":
        self._require_active()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- co-tenancy --------------------------------------------------------------
    def join_static_tenant(
        self,
        name: str,
        load,
        cfg: Optional[TenantConfig] = None,
    ) -> str:
        """Register a non-runtime tenant and commit its load to the ledger.

        ``load`` is a ``[R]`` resource-bytes vector or any object with a
        ``resource_bytes`` attribute (a solved :class:`Plan`) — the shape
        background/legacy jobs the arbiter cannot replan take in the
        benchmarks.  Arbitrated sessions only.
        """
        self._require_active()
        if self.arbiter is None:
            raise RuntimeError(
                "join_static_tenant requires adaptivity='arbitrated'"
            )
        loads = getattr(load, "resource_bytes", load)
        self.arbiter.register(name, cfg)
        try:
            self.arbiter.commit(name, np.asarray(loads, dtype=np.float64))
        except Exception:
            # atomic join: a rejected commit (wrong shape, negative load)
            # must not leave a registered zero-load ghost that activates
            # the gate/price machinery and blocks a corrected retry
            self.arbiter.unregister(name)
            raise
        return name

    # -- endpoints ---------------------------------------------------------------
    def all_to_all(
        self,
        *,
        max_chunks: int,
        chunk_bytes: float,
        alt_frac: float = 0.5,
        mode: str = "nimble",
        planner_cfg: Optional[PlannerConfig] = None,
        group=None,
    ) -> NimbleAllToAll:
        """Ready-wired dataplane endpoint (telemetry attached when the
        session runs a runtime).  Instances are cached per argument set, so
        per-layer callers share one schedule + incidence build.  ``group``:
        the model axis's process group, when the ranks span processes."""
        self._require_active()
        key = (
            "a2a", int(max_chunks), float(chunk_bytes),
            float(alt_frac), mode, planner_cfg, id(group),
        )
        if key not in self._endpoints:
            self._endpoints[key] = NimbleAllToAll.from_session(
                self,
                max_chunks=max_chunks,
                chunk_bytes=chunk_bytes,
                alt_frac=alt_frac,
                mode=mode,
                planner_cfg=planner_cfg,
                group=group,
            )
        return self._endpoints[key]

    def moe_dispatcher(
        self,
        cfg: MoECommConfig,
        planner_cfg: Optional[PlannerConfig] = None,
        group=None,
    ) -> MoEDispatcher:
        """Ready-wired expert-parallel dispatcher (runtime-fed when the
        session is adaptive); ``group`` as in :meth:`all_to_all`."""
        self._require_active()
        key = ("moe", tuple(
            str(v) for v in dataclasses.asdict(cfg).values()
        ), planner_cfg, id(group))
        if key not in self._endpoints:
            self._endpoints[key] = MoEDispatcher.from_session(
                self, cfg, planner_cfg=planner_cfg, group=group
            )
        return self._endpoints[key]

    # -- host-level planning -----------------------------------------------------
    def plan(self, demand, mode: str = "nimble", *,
             commit: Optional[bool] = None) -> Plan:
        """Solve one demand (``{(s, d): bytes}`` or an ``[n, n]`` array).

        ``mode`` selects the paper's §II-B policies: ``"nimble"`` (MWU,
        congestion-priced with the fabric's exported prices when the
        session is arbitrated), ``"direct"`` (NCCL/PXN-like least-hop), or
        ``"stripe"`` (UCX-like even striping).  ``commit`` controls
        whether the solved load is committed to the shared ledger under
        this session's tenant; the default commits exactly the arbitrated
        nimble solves (what co-planning needs), never the baselines.
        """
        self._require_active()
        dem = (
            dict(demand)
            if isinstance(demand, Mapping)
            else demand_dict(np.asarray(demand, dtype=np.float64))
        )
        if mode == "nimble":
            prices = (
                self.arbiter.prices_for(self.spec.tenant)
                if self.arbiter is not None
                else None
            )
            # thread the spec's planner knobs into the host solver so
            # plan() and the runtime's replan solves share one planner
            # truth; None keeps solve_mwu's exact defaults (which equal
            # PlannerConfig's: lam=0.25, ε=1 MiB)
            rcfg = self.spec.runtime_config()
            pcfg = rcfg.planner if rcfg is not None else None
            if pcfg is None:
                plan = solve_mwu(self.topo, dem, self.cost_model,
                                 ext_loads=prices)
            else:
                plan = solve_mwu(self.topo, dem, self.cost_model,
                                 lam=pcfg.lam, eps=pcfg.chunk_bytes,
                                 ext_loads=prices)
        elif mode == "direct":
            plan = solve_direct(self.topo, dem, self.cost_model)
        elif mode == "stripe":
            plan = solve_static_striping(self.topo, dem, self.cost_model)
        else:
            raise ValueError(f"unknown plan mode {mode!r}; one of {PLAN_MODES}")
        if commit is None:
            commit = self.arbiter is not None and mode == "nimble"
        if commit:
            if self.arbiter is None:
                raise RuntimeError("commit=True requires an arbitrated session")
            # host commits are unstamped (timeless: no window clock to
            # decay against) but fingerprint-tagged, so a session planning
            # on a different fabric geometry than the ledger's fails by
            # name instead of by shape
            self.arbiter.commit(
                self.spec.tenant, plan.resource_bytes,
                fingerprint=self.topo.fingerprint,
            )
        return plan

    # -- runtime loop ------------------------------------------------------------
    def _require_runtime(self) -> OrchestrationRuntime:
        self._require_active()
        if self.runtime is None:
            raise RuntimeError(
                "this call needs adaptivity 'adaptive' or 'arbitrated' "
                f"(session is {self.spec.adaptivity!r})"
            )
        return self.runtime

    def step(self, demand, **kw):
        """Advance the runtime loop one window (see
        ``OrchestrationRuntime.step``).  Keyword arguments — the fault
        drills' ``observed=`` / ``completion_scale=`` — pass through."""
        return self._require_runtime().step(demand, **kw)

    def run_trace(self, trace, events=None) -> TraceResult:
        """Replay a ``[W, n, n]`` traffic trace.

        Adaptive/arbitrated sessions drive the full runtime loop; a
        *static* session replays the one-shot baseline (plan on the first
        window, never replan) — the same ``TraceResult`` shape either way,
        so policy comparisons are a two-spec diff.
        """
        self._require_active()
        if self.runtime is None:
            rcfg = self.spec.runtime_config() or RuntimeConfig()
            return run_static(
                self.topo,
                trace,
                self.cost_model,
                rcfg.planner,
                chunk_bytes=rcfg.chunk_bytes,
                events=events,
                device=self.spec.device,
            )
        result = self.runtime.run_trace(trace, events=events)
        self._last_trace = result
        return result

    def run_oracle(self, trace) -> TraceResult:
        """Clairvoyant per-window re-solve over the session's fabric — the
        adaptation upper bound for :meth:`run_trace` comparisons."""
        self._require_active()
        rcfg = self.spec.runtime_config() or RuntimeConfig()
        return run_oracle(
            self.topo, trace, self.cost_model, rcfg.planner,
            chunk_bytes=rcfg.chunk_bytes, device=self.spec.device,
        )

    def prefill(self, demands) -> int:
        """Batch-solve and cache anticipated demand phases (see
        ``OrchestrationRuntime.prefill_cache``)."""
        return self._require_runtime().prefill_cache(demands)

    # -- reporting ---------------------------------------------------------------
    def report(self) -> dict:
        """One tagged ``nimble.session/v1`` record for the whole stack.

        Embeds the existing sub-schemas unchanged — ``nimble.
        runtime_stats/v1``, ``nimble.telemetry_aggregate/v1``,
        ``nimble.runtime_trace/v1`` (last ``run_trace``), ``nimble.
        fabric_fairness/v1`` and ``nimble.fabric_arbiter_stats/v1`` — so
        existing consumers dispatch on the kinds they already know — plus
        a ``nimble.metrics/v1`` snapshot (DESIGN.md §11) collected from the
        live stack, whether or not a recorder is attached.
        """
        self._require_active()
        payload: dict = {
            "tenant": self.spec.tenant,
            "adaptivity": self.spec.adaptivity,
            "state": self._state,
            "topology": self.topo.describe(),
        }
        if self.runtime is not None:
            payload["runtime_stats"] = self.runtime.stats.to_json_obj()
            payload["cache"] = self.runtime.cache_info()
            payload["telemetry"] = self.runtime.telemetry.aggregate()
        if self._last_trace is not None:
            payload["trace"] = self._last_trace.to_json_obj()
        if self.arbiter is not None:
            payload["fairness"] = self.arbiter.fairness_report()
            payload["arbiter_stats"] = self.arbiter.stats.to_json_obj()
        payload["metrics"] = self._metrics_snapshot()
        return tag("session", payload)

    def _metrics_snapshot(self) -> dict:
        """``nimble.metrics/v1`` snapshot of the scattered stack health
        signals (replans, reprices, evictions, gated windows, telemetry
        rejections, estimator confidence) under the §11 naming scheme.

        Collected from a fresh registry each call — pull-based, so the
        per-window hot path never pays for it.  With a recorder attached
        its registry is used instead, folding in anything the layers
        pushed live (per-window latency histograms).
        """
        from ..obs import MetricsRegistry, collect_session

        reg = (
            self._recorder.metrics
            if self._recorder is not None
            else MetricsRegistry()
        )
        collect_session(reg, self)
        return reg.snapshot()
