"""Execution-time orchestration controller.

Counterpart of ``repro/runtime/controller.py``.  :class:`OrchestrationRuntime`
owns the monitor -> estimate -> replan -> swap loop on one endpoint:

  * every window's realized traffic executes under the **active** plan's
    split ratios (``mcf.apply_plan_fractions``) — that is what a dataplane
    between replans actually does — and the resulting per-resource busy
    times feed :class:`~repro_torch.runtime.telemetry.LinkTelemetry`;
  * the :class:`~repro_torch.runtime.estimator.DemandEstimator` turns
    observed per-pair bytes into the next window's predicted demand;
  * the :class:`~repro_torch.runtime.policy.ReplanPolicy` compares the
    active plan's predicted-congestion ratio against its solve-time
    baseline and decides, with hysteresis, whether to replan;
  * replans are **double-buffered**: the new plan is solved off the hot
    path (modeled as ``solve_delay_windows`` of latency) by the tensor
    planner ``planner.plan_flows_batch`` on the runtime's ``device``,
    parked in the *pending* buffer, and swapped in **atomically at a window
    boundary** — never mid-round, so the dataplane's slot -> chunk ordering
    contract (sender and receiver derive indices from the same plan) holds
    by construction;
  * solved plans are cached under ``(topology fingerprint, quantized
    demand signature)``, so a returning traffic pattern swaps in a cached
    plan with zero solve latency;
  * topology events (:mod:`~repro_torch.runtime.events`) rebuild the
    cached incidence tables for the degraded fabric and force an immediate
    replan, discarding any in-flight pending plan solved for the old
    capacities;
  * when bound to a :class:`~repro_torch.fabric.FabricArbiter`
    (``register_runtime``), solves price in peers' committed load
    (``ext_loads``), replans pass the fabric admission gate (throttled
    decisions surface as ``replan_reason="gated"``), executed loads are
    exported to the shared ledger every window (window-stamped, so peers'
    price-recency decay can fade them), broadcast link events arrive
    through the shared bus, and a pending plan whose exported prices moved
    materially between issue and swap boundary is re-solved against live
    prices before it is allowed in (``FabricArbiter.reprice``).  Unbound
    (or solo-tenant) behavior is bit-identical to the standalone runtime.

With a :class:`~repro_torch.obs.FlightRecorder` attached (``recorder=`` or
``attach_recorder``) the loop records the reference's trace spans and
instants, a per-window completion histogram and a
:class:`~repro_torch.obs.PlanProvenance` for every plan
(``PlanHandle.provenance``), each hook behind one ``self._obs is None``
check.  Recorded or not, bound or unbound, the reports are the reference's
bit for bit.

Every solve runs on ``device``: the card unless the caller names the CPU.
The float64 demand is cast to float32 on the host (as the reference's
``jnp.asarray(..., float32)`` does) and the flows come back to the host
for :func:`~repro_torch.core.mcf.plan_from_flows`.

``run_trace`` drives the loop over a ``[W, n, n]`` traffic trace as a
discrete-event simulation through ``fabsim``; ``run_static`` and
``run_oracle`` are the evaluation bookends (one-shot plan vs per-window
clairvoyant replan).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.cost import CostModel, ResourceModel
from ..core.fabsim import simulate
from ..core.mcf import (
    PairKey,
    Plan,
    apply_plan_fractions,
    congestion_lower_bound,
    plan_from_flows,
)
from ..core.planner import (
    PlannerConfig,
    device_tables,
    plan_flows_batch,
    planner_provenance,
)
from ..core.schedule import build_planner_tables
from ..core.topology import Topology
from ..jsonio import tag
from .estimator import DemandEstimator
from .events import EventLog, LinkEvent
from .policy import ReplanDecision, ReplanPolicy
from .telemetry import LinkTelemetry


def demand_dict(D: np.ndarray) -> Dict[PairKey, float]:
    """[n, n] array -> sparse {(s, d): bytes} with zero/self pairs dropped."""
    n = D.shape[0]
    return {
        (s, d): float(D[s, d])
        for s in range(n)
        for d in range(n)
        if s != d and D[s, d] > 0
    }


def solve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA one must exist.

    The runtime never falls back to the CPU: asking for the card on a host
    without one raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the runtime's solves run on the card (device='cuda') and no CUDA "
            "device is present; pass device='cpu' to solve on the host"
        )
    return device


def solve_plans_batch(
    topo: Topology,
    demands: np.ndarray,            # [B, n, n]
    cost_model: CostModel | None = None,
    planner_cfg: PlannerConfig | None = None,
    ext_loads: np.ndarray | None = None,   # [B, R] external prices or None
    device="cuda",
) -> List[Plan]:
    """Solve B demand matrices in ONE ``plan_flows_batch`` call on ``device``.

    ``ext_loads`` (per-entry external committed load over the ``[R]``
    real resources) is priced into the solve but excluded from each
    returned plan's accounting.  ``None`` takes the unpriced solve.
    """
    device = solve_device(device)
    tables = build_planner_tables(topo, cost_model)
    pcfg = planner_cfg or PlannerConfig()
    d32 = torch.as_tensor(np.asarray(demands, dtype=np.float32)).to(device)
    ext = None
    if ext_loads is not None:
        # pad each price row with the trailing dummy-resource slot
        pad = np.zeros((len(demands), tables.n_resources), dtype=np.float32)
        pad[:, :-1] = np.asarray(ext_loads, dtype=np.float32)
        ext = torch.as_tensor(pad).to(device)
    flows = plan_flows_batch(d32, tables, pcfg, ext_loads=ext)[0].cpu().numpy()
    return [
        plan_from_flows(
            topo, flows[b], demand_dict(demands[b]), cost_model,
            iterations=pcfg.n_iters,
        )
        for b in range(len(demands))
    ]


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    chunk_bytes: float = float(1 << 20)
    planner: PlannerConfig = dataclasses.field(
        default_factory=lambda: PlannerConfig(n_iters=32)
    )
    solve_delay_windows: int = 1   # replan latency before the swap boundary
    signature_levels: int = 8      # demand-signature quantization resolution
    cache_capacity: int = 64       # LRU entries in the plan cache
    telemetry_windows: int = 256   # ring-buffer capacity
    # pending-plan watchdog: a buffered plan older than this many windows
    # past its issue is abandoned and re-solved against live state instead
    # of swapping in stale.  Healthy pendings become ready after at most
    # solve_delay_windows + 1, so the default never fires in normal
    # operation; None disables the watchdog entirely.
    pending_deadline_windows: Optional[int] = 8


@dataclasses.dataclass
class PlanHandle:
    """One buffered plan: the routing policy plus its provenance.

    ``solved_demand`` / ``solved_prices`` record what the plan was solved
    *against*, so the swap boundary can re-price it: when the fabric's
    exported prices moved materially between issue and swap, the pending
    plan is re-solved on the same demand under live prices.  ``repriced``
    marks a handle that already went through one re-price round — the
    retry swaps at its boundary regardless, so a continuously drifting
    fabric delays a swap by at most one re-solve.
    """

    plan: Plan
    signature: tuple
    version: int
    solved_window: int
    source: str   # "initial" | "solve" | "cache" | "reprice" | "watchdog"
    baseline_ratio: float  # Z/Z* on its own solve demand, for the policy
    solved_demand: Optional[np.ndarray] = None
    solved_prices: Optional[np.ndarray] = None
    repriced: bool = False
    # flight-recorder audit record (repro_torch.obs.PlanProvenance) when a
    # recorder is attached; None on unrecorded runs
    provenance: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class WindowReport:
    window: int
    completion_s: float
    payload_bytes: float
    bandwidth_gbs: float
    bottleneck: str
    congestion_ratio: float
    plan_version: int
    plan_source: str
    swapped: bool
    replan_issued: bool
    replan_reason: str
    cache_hit: bool
    events: Tuple[str, ...]
    # the policy's raw trigger before fabric-gate rewriting: a window with
    # ``replan_reason="gated"`` keeps its underlying trigger ("congestion",
    # "staleness", "fabric") here, so report consumers can tell a gated
    # trigger from a window where no trigger fired at all
    trigger_reason: str = "none"
    # health signals from the estimator / telemetry layers: prediction
    # confidence after this window (decays through blackouts) and the
    # cumulative count of telemetry records rejected as non-finite or
    # negative.  Bookends (static/oracle) report the healthy defaults.
    confidence: float = 1.0
    telemetry_rejected: int = 0

    def to_json_obj(self) -> dict:
        return tag("runtime_window", dataclasses.asdict(self))


@dataclasses.dataclass
class RuntimeStats:
    windows: int = 0
    replans: int = 0        # replan triggers issued (switch decisions)
    solves: int = 0         # actual MWU solves (cache misses)
    cache_hits: int = 0
    swaps: int = 0
    events: int = 0
    reprices: int = 0       # stale pendings re-solved on live prices at swap
    watchdog_abandons: int = 0   # pendings past deadline, re-solved live
    gated: int = 0          # fired triggers throttled by the fabric gate

    def to_json_obj(self) -> dict:
        return tag("runtime_stats", dataclasses.asdict(self))


@dataclasses.dataclass
class TraceResult:
    reports: List[WindowReport]
    stats: RuntimeStats

    @property
    def total_completion_s(self) -> float:
        return float(sum(r.completion_s for r in self.reports))

    @property
    def replan_windows(self) -> List[int]:
        return [r.window for r in self.reports if r.replan_issued]

    @property
    def replan_fraction(self) -> float:
        if not self.reports:
            return 0.0
        return len(self.replan_windows) / len(self.reports)

    @property
    def gated_windows(self) -> List[int]:
        """Windows whose fired trigger was throttled by the fabric gate."""
        return [r.window for r in self.reports if r.replan_reason == "gated"]

    def to_json_obj(self) -> dict:
        return tag(
            "runtime_trace",
            {
                "total_completion_s": self.total_completion_s,
                "replan_windows": self.replan_windows,
                "replan_fraction": self.replan_fraction,
                "gated_windows": self.gated_windows,
                "stats": self.stats.to_json_obj(),
                "windows": [r.to_json_obj() for r in self.reports],
            },
        )


class OrchestrationRuntime:
    """Endpoint-driven monitor -> estimate -> replan -> swap loop."""

    @classmethod
    def from_session(cls, session) -> "OrchestrationRuntime":
        """Build the runtime for a :class:`repro_torch.api.Session`.

        Narrow construction hook: the session is duck-typed — only
        ``.topo``, ``.cost_model`` and ``.spec`` (with ``runtime_config()``,
        ``policy_config()``, ``estimator``, ``initial_demand`` and
        ``device``) are read — so this module never imports
        ``repro_torch.api``.  ``None`` spec fields fall through to the exact
        constructor defaults, keeping Session-built runtimes bit-identical
        to hand-wired ``OrchestrationRuntime(topo)`` stacks.
        """
        spec = session.spec
        # policy_config() folds the spec-level calibrated fabric_staleness
        # into the policy for arbitrated sessions
        pcfg = spec.policy_config()
        policy = ReplanPolicy(pcfg) if pcfg is not None else None
        estimator = (
            DemandEstimator(session.topo.n_devices, spec.estimator)
            if spec.estimator is not None
            else None
        )
        return cls(
            session.topo,
            session.cost_model,
            cfg=spec.runtime_config(),
            policy=policy,
            estimator=estimator,
            initial_demand=spec.initial_demand,
            device=spec.device,
            # flight recorder: passed at construction so the *initial*
            # solve is traced and provenance-recorded too
            recorder=getattr(session, "_recorder", None),
            tenant_label=spec.tenant,
        )

    def __init__(
        self,
        topo: Topology,
        cost_model: CostModel | None = None,
        cfg: RuntimeConfig | None = None,
        policy: ReplanPolicy | None = None,
        estimator: DemandEstimator | None = None,
        events: EventLog | None = None,
        initial_demand: Optional[np.ndarray] = None,
        recorder=None,
        tenant_label: Optional[str] = None,
        device="cuda",
    ):
        self.device = solve_device(device)
        self.topo = topo
        self.cm = cost_model or CostModel()
        self.cfg = cfg or RuntimeConfig()
        self.policy = policy or ReplanPolicy()
        self.estimator = estimator or DemandEstimator(topo.n_devices)
        # copy, matching run_trace: the caller's log stays reusable
        self.events = events.copy() if events is not None else EventLog()
        self.stats = RuntimeStats()
        self.telemetry = LinkTelemetry(
            ResourceModel(topo, self.cm).capacity,
            window_capacity=self.cfg.telemetry_windows,
        )
        self._window = 0
        self._version = 0
        self._cache: "collections.OrderedDict[tuple, Plan]" = (
            collections.OrderedDict()
        )
        self._pending: Optional[Tuple[PlanHandle, int]] = None
        # fabric-arbiter binding (FabricArbiter.register_runtime): when set,
        # solves take arbiter-exported prices, replans pass the admission
        # gate, and executed loads are committed to the shared ledger
        self._arbiter = None
        self._tenant: Optional[str] = None
        self._fabric_window_offset = 0
        # flight recorder (repro_torch.obs): every hook below is guarded by
        # one ``self._obs is None`` check, so a run without a recorder
        # executes the unrecorded instruction stream
        self._obs = None
        self._obs_label = tenant_label or "runtime"
        self._fault_context: Tuple[str, ...] = ()
        if recorder is not None and getattr(recorder, "enabled", False):
            self._obs = recorder
        self._rebuild_planner()

        if initial_demand is None:
            # uniform warm plan: every pair ships 64 chunks; scale-free
            # enough that the first windows are served sanely pre-telemetry
            n = topo.n_devices
            initial_demand = np.full((n, n), 64.0 * self.cfg.chunk_bytes)
            np.fill_diagonal(initial_demand, 0.0)
        self._active, _ = self._solve_handle(
            np.asarray(initial_demand, dtype=np.float64),
            window=0,
            source="initial",
        )

    # -- fabric-arbiter binding -------------------------------------------------
    def bind_arbiter(self, arbiter, tenant: Optional[str]) -> None:
        """Attach/detach this runtime to a :class:`~repro_torch.fabric.FabricArbiter`.

        Called by ``FabricArbiter.register_runtime`` / ``unregister`` — use
        those entry points rather than calling this directly, so the
        ledger, admission gate, and event-bus subscription stay in sync.
        """
        self._arbiter = arbiter
        self._tenant = tenant
        if arbiter is not None:
            # align this runtime's window counter with the fabric clock:
            # commits are stamped in *fabric* windows, so a tenant joining
            # a fabric that has already run N windows is not priced as N
            # windows stale (and decayed to nothing) just because its own
            # counter starts at zero.  On a fresh fabric the offset is 0 —
            # stamps equal local windows.
            self._fabric_window_offset = arbiter.state.clock - self._window
        else:
            self._fabric_window_offset = 0

    def _arbiter_prices(self) -> Optional[np.ndarray]:
        """Exported prices for this tenant (None when unbound or alone)."""
        if self._arbiter is None:
            return None
        return self._arbiter.prices_for(self._tenant)

    # -- flight recorder --------------------------------------------------------
    def attach_recorder(self, recorder, tenant: Optional[str] = None) -> None:
        """Attach a :class:`repro_torch.obs.FlightRecorder` after construction.

        Prefer passing ``recorder=`` to the constructor (or building via a
        recorded Session) so the initial solve is traced too; this hook
        exists for already-built runtimes and backfills a provenance
        record for the current active plan so the audit trail still covers
        every plan.  A disabled recorder (or ``None``) detaches.
        """
        if tenant is not None:
            self._obs_label = tenant
        if recorder is None or not getattr(recorder, "enabled", False):
            self._obs = None
            return
        self._obs = recorder
        if self._active.provenance is None:
            self._active.provenance = recorder.provenance.issue(
                tenant=self._obs_label,
                version=self._active.version,
                source=self._active.source,
                trigger="initial",
                cache_hit=False,
                issued_window=self._active.solved_window,
                signature=self._active.signature,
                demand_bytes=(
                    float(self._active.solved_demand.sum())
                    if self._active.solved_demand is not None else 0.0
                ),
                baseline_ratio=self._active.baseline_ratio,
                planner=planner_provenance(self.cfg.planner),
                prices=self._active.solved_prices,
            )

    # -- planner / tables -------------------------------------------------------
    def _rebuild_planner(self) -> None:
        self.tables = build_planner_tables(self.topo, self.cm)
        # move the (possibly new) tables' candidate rows to the device once
        device_tables(self.tables, self.device)

    def _solve_batch(
        self, demands: np.ndarray, ext_loads: np.ndarray | None = None
    ) -> List[Plan]:
        """B demand matrices -> B host plans via one batched solve."""
        self.stats.solves += len(demands)
        return solve_plans_batch(
            self.topo, demands, self.cm, self.cfg.planner,
            ext_loads=ext_loads, device=self.device,
        )

    _PRICES_UNSET = object()   # sentinel: "fetch prices from the arbiter"

    def _solve_handle(self, demand: np.ndarray, window: int,
                      source: str,
                      repriced: bool = False,
                      prices=_PRICES_UNSET,
                      trigger: Optional[str] = None) -> Tuple[PlanHandle, bool]:
        """Probe the plan cache, solving on a miss; returns (handle, hit).

        ``prices`` lets a caller that already holds the live price vector
        (the swap-boundary reprice verdict) pass it through instead of
        recomputing the decayed external load.  ``trigger`` is the replan
        reason recorded in the provenance audit trail (defaults to
        ``source``).
        """
        if prices is OrchestrationRuntime._PRICES_UNSET:
            prices = self._arbiter_prices()
        sig = self.demand_signature(demand, prices)
        plan = self._cache_get(sig)
        cache_hit = plan is not None
        if plan is None:
            ext = None if prices is None else prices[None]
            if self._obs is not None:
                # the planner-layer span: the host boundary of the device
                # solve (its ``plan_flows_batch`` call on ``self.device``)
                with self._obs.tracer.span(
                    "solve", "planner", self._obs_label,
                    {"window": window, "source": source,
                     "priced": prices is not None},
                ):
                    plan = self._solve_batch(demand[None], ext_loads=ext)[0]
            else:
                plan = self._solve_batch(demand[None], ext_loads=ext)[0]
            self._cache_put(sig, plan)
        self._version += 1
        handle = PlanHandle(
            plan=plan,
            signature=sig,
            version=self._version,
            solved_window=window,
            source="cache" if cache_hit else source,
            baseline_ratio=self._ratio(plan, demand),
            solved_demand=demand,
            solved_prices=prices,
            repriced=repriced,
        )
        if self._obs is not None:
            handle.provenance = self._obs.provenance.issue(
                tenant=self._obs_label,
                version=handle.version,
                source=handle.source,
                trigger=trigger or source,
                cache_hit=cache_hit,
                issued_window=window,
                signature=sig,
                demand_bytes=float(demand.sum()),
                baseline_ratio=handle.baseline_ratio,
                planner=planner_provenance(self.cfg.planner),
                prices=prices,
                repriced=repriced,
                fault_context=self._fault_context,
            )
        return handle, cache_hit

    # -- plan cache -------------------------------------------------------------
    def demand_signature(
        self, demand: np.ndarray, prices: Optional[np.ndarray] = None
    ) -> tuple:
        """(topology fingerprint, scale bucket, quantized shape) cache key.

        The shape is quantized to ``signature_levels`` relative levels and
        the magnitude to a power-of-two bucket: MWU split ratios are (up to
        chunk quantization) scale-invariant, so nearby demands share a
        plan; a changed fingerprint (capacities, faults) never matches.

        Arbitrated solves extend the key with the exported price vector,
        quantized the same way — a plan solved under peers' load must not
        be served to a solve under different prices (and vice versa).
        ``prices=None`` leaves the key identical to the unarbitrated one.
        """
        def quantize(v: np.ndarray) -> tuple:
            v = np.asarray(v, dtype=np.float64)
            m = float(v.max())
            if m <= 0:
                return ("zero",)
            q = np.round(v / m * self.cfg.signature_levels).astype(np.int16)
            return (int(round(np.log2(max(m, 1.0)))), q.tobytes())

        sig = (self.topo.fingerprint,) + quantize(demand)
        if prices is None:
            return sig
        return sig + quantize(prices)

    def _cache_get(self, sig: tuple) -> Optional[Plan]:
        plan = self._cache.get(sig)
        if plan is not None:
            self._cache.move_to_end(sig)
            self.stats.cache_hits += 1
        return plan

    def _cache_put(self, sig: tuple, plan: Plan) -> None:
        self._cache[sig] = plan
        self._cache.move_to_end(sig)
        while len(self._cache) > self.cfg.cache_capacity:
            self._cache.popitem(last=False)

    def cache_info(self) -> dict:
        return {
            "size": len(self._cache),
            "hits": self.stats.cache_hits,
            "solves": self.stats.solves,
        }

    def prefill_cache(self, demands: Sequence[np.ndarray]) -> int:
        """Batch-solve and cache several anticipated demand matrices in one
        ``plan_flows_batch`` call (e.g. known tenant phases)."""
        fresh: List[np.ndarray] = []
        sigs: List[tuple] = []
        for D in demands:
            sig = self.demand_signature(np.asarray(D, dtype=np.float64))
            if sig not in self._cache and sig not in sigs:
                fresh.append(np.asarray(D, dtype=np.float64))
                sigs.append(sig)
        if fresh:
            for sig, plan in zip(sigs, self._solve_batch(np.stack(fresh))):
                self._cache_put(sig, plan)
        return len(fresh)

    # -- signals ----------------------------------------------------------------
    def _ratio(self, plan: Plan, demand: np.ndarray) -> float:
        """Predicted congestion ratio: stale-plan Z over the cut bound Z*."""
        dem = demand_dict(demand)
        if not dem:
            return 1.0
        z = apply_plan_fractions(
            plan, dem, topo=self.topo, cost_model=self.cm
        ).max_normalized_load()
        lb = congestion_lower_bound(self.topo, dem, self.cm)
        return z / lb if lb > 0 else 1.0

    # -- event handling ---------------------------------------------------------
    def _apply_events(self, due: List[LinkEvent]) -> None:
        overrides = dict(self.events.overrides(due))
        self.topo = self.topo.with_link_scale(overrides)
        self._rebuild_planner()
        # telemetry capacities follow the fabric; the ring buffer persists
        self.telemetry.capacity_bps = ResourceModel(
            self.topo, self.cm
        ).capacity
        self.stats.events += len(due)
        # a pending plan was solved against the old capacities — discard
        self._pending = None

    # -- the loop ----------------------------------------------------------------
    def _maybe_swap(self, window: int) -> bool:
        """Atomic plan swap at the window boundary (never mid-round).

        Arbitrated runtimes re-price the pending plan here: the plan was
        solved ``solve_delay_windows`` ago under the prices of its issue
        window, and on a fabric whose peers moved meanwhile those prices
        describe where everyone *was* — exactly the mutual over-avoidance
        failure.  When the arbiter's ``reprice`` verdict says the prices
        moved past ``price_hint_rel`` since issue, the plan **still swaps
        in** — it was solved on fresher demand than whatever it replaces —
        but the same demand is immediately re-solved against live prices
        and the *refined* plan parked as the new pending (swap-and-refine).
        One refine round per replan chain (``PlanHandle.repriced``): the
        refined plan swaps at its own boundary regardless, so continuous
        drift costs at most one extra solve per replan and can never starve
        the dataplane of swaps.  Refines never charge the admission gate —
        they complete an already-admitted replan rather than issuing a new
        one.

        A **pending-plan watchdog** guards the issue-to-swap path: a
        pending whose solve is older than ``pending_deadline_windows``
        describes a fabric that no longer exists (window-clock jumps via
        ``observe_dispatch``, long solve delays), so it is abandoned and
        the live estimate re-solved in its place rather than swapped in
        stale.  Watchdog-issued pendings are exempt from re-abandonment so
        a slow solver degrades to periodic refresh instead of livelock.
        """
        if self._pending is None:
            return False
        handle, ready = self._pending
        deadline = self.cfg.pending_deadline_windows
        if (
            deadline is not None
            and handle.source != "watchdog"
            and window - handle.solved_window > deadline
        ):
            self.stats.watchdog_abandons += 1
            if handle.provenance is not None:
                handle.provenance.mark_abandoned()
            if self._obs is not None:
                self._obs.tracer.instant(
                    "replan", "runtime", self._obs_label,
                    {"window": window, "source": "watchdog",
                     "abandoned_version": handle.version},
                )
            live = (
                self.estimator.predict()
                if self.estimator.initialized
                else handle.solved_demand
            )
            wd_handle, cache_hit = self._solve_handle(
                live, window, "watchdog", trigger="watchdog"
            )
            ready = window + (
                1 if cache_hit else max(1, self.cfg.solve_delay_windows)
            )
            self._pending = (wd_handle, ready)
            if wd_handle.provenance is not None:
                wd_handle.provenance.mark_ready(ready)
            return False
        if ready > window:
            return False
        self._pending = None
        if (
            self._arbiter is not None
            and not handle.repriced
            and handle.solved_demand is not None
        ):
            verdict = self._arbiter.reprice(
                self._tenant, handle.solved_prices
            )
            if verdict.moved:
                re_handle, cache_hit = self._solve_handle(
                    handle.solved_demand, window, "reprice", repriced=True,
                    prices=verdict.prices, trigger="reprice",
                )
                ready = window + (
                    1 if cache_hit else max(1, self.cfg.solve_delay_windows)
                )
                self._pending = (re_handle, ready)
                self.stats.reprices += 1
                if re_handle.provenance is not None:
                    re_handle.provenance.mark_ready(ready)
            if handle.provenance is not None:
                handle.provenance.mark_swapped(
                    window, prices=verdict.prices,
                    rel_change=verdict.rel_change, repriced=verdict.moved,
                )
        elif handle.provenance is not None:
            handle.provenance.mark_swapped(
                window, prices=self._arbiter_prices()
                if self._arbiter is not None else None,
            )
        if self._obs is not None:
            self._obs.tracer.instant(
                "swap", "runtime", self._obs_label,
                {"window": window, "version": handle.version,
                 "source": handle.source, "repriced": handle.repriced},
            )
        self._active = handle
        self.stats.swaps += 1
        # pass the solve provenance: a fabric-pressure hint newer than
        # the swapped plan's solve must survive the swap (the plan was
        # priced before the fabric shifted)
        self.policy.notify_swap(handle.solved_window)
        return True

    def _issue_replan(self, predicted: np.ndarray, window: int,
                      source_hint: str = "solve",
                      trigger: Optional[str] = None) -> Tuple[PlanHandle, bool]:
        handle, cache_hit = self._solve_handle(
            predicted, window, source_hint, trigger=trigger
        )
        # cache hit swaps at the very next boundary (no solve latency);
        # a miss pays the off-hot-path solve delay first
        ready = window + (
            1 if cache_hit else max(1, self.cfg.solve_delay_windows)
        )
        self._pending = (handle, ready)
        self.stats.replans += 1
        if handle.provenance is not None:
            handle.provenance.mark_ready(ready)
        if self._obs is not None:
            self._obs.tracer.instant(
                "replan", "runtime", self._obs_label,
                {"window": window, "reason": trigger or source_hint,
                 "version": handle.version, "cache_hit": cache_hit,
                 "ready": ready},
            )
        return handle, cache_hit

    _OBS_UNSET = object()   # sentinel: "telemetry observed the demand as-is"

    def step(
        self,
        demand: np.ndarray,
        *,
        observed=_OBS_UNSET,
        completion_scale: float = 1.0,
    ) -> WindowReport:
        """Advance one window: execute, observe, predict, decide, buffer.

        ``observed`` is what telemetry *saw* this window when that differs
        from the executed demand (fault drills): ``None`` models a full
        telemetry blackout (the estimator keeps serving its last-good
        prediction with decayed confidence), a partial array may carry NaN
        entries for dropped counters.  ``completion_scale`` inflates the
        measured completion time (straggler windows) without touching the
        routed bytes.

        With a flight recorder attached the window runs inside a
        ``window`` trace span on this tenant's track (with ``fault`` /
        ``swap`` / ``replan`` markers nested inside) and observes the
        completion into the per-tenant latency histogram; without one the
        wrapper is a single ``None`` check.
        """
        if self._obs is None:
            return self._step(
                demand, observed=observed, completion_scale=completion_scale
            )
        tr = self._obs.tracer
        tr.advance_to(self._window * 1000)
        span = tr.begin(
            "window", "runtime", self._obs_label, {"window": self._window}
        )
        report = self._step(
            demand, observed=observed, completion_scale=completion_scale
        )
        tr.end(span, {
            "plan_version": report.plan_version,
            "congestion_ratio": round(report.congestion_ratio, 4),
            "reason": report.replan_reason,
        })
        self._obs.metrics.histogram(
            "nimble_runtime_window_completion_s",
            {"tenant": self._obs_label},
        ).observe(report.completion_s)
        return report

    def _step(
        self,
        demand: np.ndarray,
        *,
        observed=_OBS_UNSET,
        completion_scale: float = 1.0,
    ) -> WindowReport:
        w = self._window
        demand = np.asarray(demand, dtype=np.float64)
        if observed is OrchestrationRuntime._OBS_UNSET:
            observed = demand

        due = self.events.pop_due(w)
        self._fault_context = tuple(ev.describe() for ev in due)
        if due:
            if self._obs is not None:
                for ev in due:
                    self._obs.tracer.instant(
                        "fault", "runtime", self._obs_label,
                        {"window": w, "event": ev.describe(),
                         "kind": ev.kind},
                    )
            self._apply_events(due)
        swapped = self._maybe_swap(w)

        # execute the window under the active plan's split ratios
        dem = demand_dict(demand)
        exec_plan = apply_plan_fractions(
            self._active.plan, dem, topo=self.topo, cost_model=self.cm
        )
        sim = simulate(exec_plan, self.cfg.chunk_bytes)
        # telemetry stores only clean pair observations; partial (NaN) and
        # blackout windows record the resource counters with no pair bytes
        pair_obs = (
            observed
            if observed is not None and np.isfinite(observed).all()
            else None
        )
        self.telemetry.record(
            w, sim, pair_bytes=pair_obs, completion_scale=completion_scale
        )
        if self._arbiter is not None:
            # telemetry export: this window's realized per-resource loads
            # become this tenant's committed load in the shared ledger —
            # window-stamped so peers' recency decay can fade it, and
            # fingerprint-tagged so a commit racing a topology rebuild is
            # rejected by name instead of as an opaque shape error
            self._arbiter.commit(
                self._tenant, exec_plan.resource_bytes,
                window=w + self._fabric_window_offset,
                fingerprint=self.topo.fingerprint,
            )

        # estimate next-window demand and evaluate the triggers (the
        # estimator degrades gracefully on None / NaN-masked observations)
        self.estimator.update(observed)
        predicted = self.estimator.predict()
        ratio = self._ratio(self._active.plan, predicted)
        decision: ReplanDecision = self.policy.decide(
            window=w,
            ratio=ratio,
            baseline_ratio=self._active.baseline_ratio,
            plan_age=w - self._active.solved_window,
            pending=self._pending is not None,
            topology_event=bool(due),
        )
        trigger_reason = decision.reason
        if (
            decision.replan
            and self._arbiter is not None
            and decision.reason != "topology"
        ):
            # replan admission gate: a drift burst on one tenant must not
            # monopolize the shared solver or churn peers' price-keyed
            # caches; topology-forced replans always pass
            verdict = self._arbiter.admit(
                self._tenant, window=w, reason=decision.reason
            )
            if not verdict.admitted:
                decision = dataclasses.replace(
                    decision, replan=False, reason="gated"
                )
                self.stats.gated += 1
                # the fired trigger disarmed the policy but no swap will
                # follow — re-arm so the tenant retries once tokens refill
                self.policy.notify_gated()
                if trigger_reason == "fabric":
                    # the pressure that fired was not relieved (no solve
                    # happened) — restart the soft deadline so the tenant
                    # retries once its tokens refill
                    self.policy.notify_fabric_pressure(w)
        cache_hit = False
        if decision.replan:
            _, cache_hit = self._issue_replan(
                predicted, w, trigger=decision.reason
            )

        self.stats.windows += 1
        self._window += 1
        return WindowReport(
            window=w,
            completion_s=float(sim.completion_time) * completion_scale,
            payload_bytes=float(sim.total_payload),
            bandwidth_gbs=sim.bandwidth_gbs(),
            bottleneck=sim.bottleneck_kind(exec_plan),
            congestion_ratio=float(ratio),
            plan_version=self._active.version,
            plan_source=self._active.source,
            swapped=swapped,
            replan_issued=decision.replan,
            replan_reason=decision.reason,
            cache_hit=cache_hit,
            events=tuple(ev.describe() for ev in due),
            trigger_reason=trigger_reason,
            confidence=float(self.estimator.confidence),
            telemetry_rejected=int(self.telemetry.rejected),
        )

    def run_trace(
        self,
        trace: np.ndarray,                     # [W, n, n]
        events: Optional[EventLog] = None,
    ) -> TraceResult:
        """Replay a multi-window traffic trace through the full loop.

        ``events`` (if given) is merged by copy — the caller's log is left
        intact so the same log can parameterize several replays.
        """
        if events is not None:
            for ev in events.snapshot():
                self.events.schedule(ev)
        reports = [self.step(trace[w]) for w in range(len(trace))]
        return TraceResult(reports, dataclasses.replace(self.stats))

    # -- fabric-pressure hook ---------------------------------------------------
    def notify_fabric_pressure(self) -> None:
        """A fabric "prices moved" hint arrived (arbiter broadcast).

        Peers' committed load shifted materially, so the active plan may
        be priced stale even while this tenant's own demand is flat.
        Forwarded to the policy's soft staleness clock; a no-op unless
        ``PolicyConfig.fabric_staleness`` is set.
        """
        self.policy.notify_fabric_pressure(self._window)

    # -- dataplane / dispatcher hook --------------------------------------------
    def observe_dispatch(self, demand_bytes: np.ndarray) -> None:
        """Feed externally-executed demand (e.g. MoE dispatch rounds) into
        telemetry + estimator without driving the fabsim loop.

        Accepts ``[n, n]`` or ``[B, n, n]``; batched entries are recorded
        as consecutive windows.
        """
        demand_bytes = np.asarray(demand_bytes, dtype=np.float64)
        mats = demand_bytes[None] if demand_bytes.ndim == 2 else demand_bytes
        for D in mats:
            dem = demand_dict(D)
            if dem:
                plan = apply_plan_fractions(
                    self._active.plan, dem, topo=self.topo, cost_model=self.cm
                )
                self.telemetry.record_loads(
                    self._window, plan.resource_bytes, pair_bytes=D
                )
                if self._arbiter is not None:
                    self._arbiter.commit(
                        self._tenant, plan.resource_bytes,
                        window=self._window + self._fabric_window_offset,
                        fingerprint=self.topo.fingerprint,
                    )
            self.estimator.update(D)
            self._window += 1

    @property
    def active_plan(self) -> Plan:
        return self._active.plan

    @property
    def active_version(self) -> int:
        return self._active.version


# -- evaluation bookends ---------------------------------------------------------

def run_static(
    topo: Topology,
    trace: np.ndarray,
    cost_model: CostModel | None = None,
    planner_cfg: PlannerConfig | None = None,
    chunk_bytes: float = float(1 << 20),
    solve_window: int = 0,
    events: Optional[EventLog] = None,
    device="cuda",
) -> TraceResult:
    """One-shot baseline: solve on window ``solve_window``, never replan."""
    pcfg = planner_cfg or PlannerConfig(n_iters=32)
    cur = topo
    plan = solve_plans_batch(
        cur, trace[solve_window][None], cost_model, pcfg, device=device
    )[0]
    reports: List[WindowReport] = []
    ev_log = events.copy() if events is not None else EventLog()
    for w in range(len(trace)):
        due = ev_log.pop_due(w)
        if due:
            cur = cur.with_link_scale(dict(ev_log.overrides(due)))
        dem = demand_dict(np.asarray(trace[w], dtype=np.float64))
        sim = simulate(
            apply_plan_fractions(plan, dem, topo=cur, cost_model=cost_model),
            chunk_bytes,
        )
        reports.append(
            WindowReport(
                window=w,
                completion_s=float(sim.completion_time),
                payload_bytes=float(sim.total_payload),
                bandwidth_gbs=sim.bandwidth_gbs(),
                bottleneck="",
                congestion_ratio=0.0,
                plan_version=1,
                plan_source="static",
                swapped=False,
                replan_issued=False,
                replan_reason="none",
                cache_hit=False,
                events=tuple(ev.describe() for ev in due),
            )
        )
    stats = RuntimeStats(windows=len(trace), solves=1)
    return TraceResult(reports, stats)


def run_oracle(
    topo: Topology,
    trace: np.ndarray,
    cost_model: CostModel | None = None,
    planner_cfg: PlannerConfig | None = None,
    chunk_bytes: float = float(1 << 20),
    device="cuda",
) -> TraceResult:
    """Clairvoyant bound: every window re-solved on its true demand, all
    windows batched through ONE ``plan_flows_batch`` call."""
    pcfg = planner_cfg or PlannerConfig(n_iters=32)
    plans = solve_plans_batch(
        topo, np.asarray(trace, dtype=np.float64), cost_model, pcfg,
        device=device,
    )
    reports: List[WindowReport] = []
    for w, plan in enumerate(plans):
        sim = simulate(plan, chunk_bytes)
        reports.append(
            WindowReport(
                window=w,
                completion_s=float(sim.completion_time),
                payload_bytes=float(sim.total_payload),
                bandwidth_gbs=sim.bandwidth_gbs(),
                bottleneck="",
                congestion_ratio=1.0,
                plan_version=w + 1,
                plan_source="oracle",
                swapped=True,
                replan_issued=True,
                replan_reason="oracle",
                cache_hit=False,
                events=(),
                trigger_reason="oracle",
            )
        )
    stats = RuntimeStats(
        windows=len(trace), replans=len(trace), solves=len(trace),
        swaps=len(trace),
    )
    return TraceResult(reports, stats)
