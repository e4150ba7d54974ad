"""Fabric arbiter — weighted congestion pricing over N tenants (DESIGN.md §4).

Counterpart of ``repro/fabric/arbiter.py`` (numpy and the stdlib only),
without the flight-recorder hooks (``attach_recorder`` and the trace
instants), which come with the port of ``obs/``.

The per-tenant planners (host ``mcf.solve_mwu``, the runtime's jitted
``plan_flows_batch``) are endpoint-greedy: each minimizes *its own* max
normalized load on a fabric it believes is empty.  With several tenants on
one fabric that belief is wrong, and independent replanning stacks every
tenant onto the same cheap paths.  :class:`FabricArbiter` is the thin
coordination layer above those planners:

  * it owns the shared :class:`~repro_torch.fabric.state.FabricState` ledger of
    per-tenant committed load;
  * it exports **prices** — a tenant's external load scaled by its weight —
    which the solvers accept via ``ext_loads`` (priced during the solve,
    excluded from the plan's own accounting);
  * :meth:`arbitrate` iterates sequential-greedy sweeps over all tenants in
    a canonical order until plans stop moving, a best-response dynamic
    whose fixed point is a weighted congestion equilibrium;
  * :meth:`admit` is the replan admission gate (token bucket + QoS), and
    :meth:`broadcast` fans link events out to every registered tenant via
    the shared :class:`~repro_torch.core.topology.LinkEventBus`.

Zero-overhead degradation: with a single registered tenant the external
load is identically zero, :meth:`prices_for` returns ``None``, the gate
admits everything, and every solve takes the exact unarbitrated code path
— plans are bit-identical to today's ``solve_mwu`` /
``OrchestrationRuntime`` output (``tests/test_torch_fabric.py`` holds the
port to the cases of the reference's ``tests/test_fabric.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np

from ..core.cost import CostModel
from ..core.mcf import PairKey, Plan, solve_mwu
from ..core.topology import LinkEventBus, Topology
from ..jsonio import tag
from ..runtime.events import PricesMovedHint, merge_overrides
from .admission import AdmissionConfig, AdmissionDecision, TokenBucket
from .fairness import fairness_report
from .state import FabricState

#: canonical planning/priority order of QoS classes (lower rank first)
QOS_RANK = {"gold": 0, "standard": 1, "scavenger": 2}


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Per-tenant share and service class.

    ``weight`` scales exported prices by ``1/weight``: a weight-2 tenant
    sees peers' load at half price, bids more aggressively for contested
    resources, and converges to roughly twice the share — weighted
    congestion pricing.  ``qos`` orders the greedy sweeps and selects
    admission-gate bypass (``gold``).
    """

    weight: float = 1.0
    qos: str = "standard"
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig
    )

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.qos not in QOS_RANK:
            raise ValueError(
                f"unknown qos class {self.qos!r}; one of {sorted(QOS_RANK)}"
            )


@dataclasses.dataclass(frozen=True)
class ArbiterConfig:
    n_sweeps: int = 3   # max sequential-greedy sweeps per arbitrate() call
    # publish a "prices moved" hint on the bus when a commit shifts the
    # total committed load by more than this fraction of the peak load
    # (the arbiter-aware replan trigger, DESIGN.md §4.3); <= 0 disables —
    # and also disables swap-boundary re-pricing, which reuses this
    # threshold to decide whether a pending plan's prices went stale
    price_hint_rel: float = 0.25
    # recency half-life (windows) for exported prices: a peer's *stamped*
    # committed load is weighted by 0.5 ** (staleness / price_decay) in
    # prices_for, so telemetry that stops refreshing fades out of every
    # other tenant's solve.  None = raw ledger prices, byte-identical to
    # the undecayed arbiter; unstamped (host) commits never decay.
    price_decay: Optional[float] = None
    # crash eviction (DESIGN.md §9): a tenant whose last commit is at
    # least this many fabric windows stale has stopped heartbeating and is
    # unregistered outright — its ledger entry withdrawn so survivors stop
    # pricing around a ghost.  None disables (a silent tenant is only ever
    # faded by price_decay, never dropped).  Unstamped (host) commits have
    # no staleness and are never evicted.
    evict_staleness: Optional[float] = None


@dataclasses.dataclass
class ArbiterStats:
    solves: int = 0        # tenant solves issued by arbitrate()
    sweeps: int = 0        # greedy sweeps executed
    admitted: int = 0      # gate passes (incl. bypasses)
    throttled: int = 0     # gate denials
    broadcasts: int = 0    # link-event batches published
    commits: int = 0       # ledger commits
    price_hints: int = 0   # "prices moved" hints published
    reprices: int = 0      # swap-boundary re-price verdicts (stale pendings)
    evictions: int = 0     # tenants dropped for heartbeat staleness

    def to_json_obj(self) -> dict:
        return tag("fabric_arbiter_stats", dataclasses.asdict(self))


@dataclasses.dataclass(frozen=True)
class RepriceDecision:
    """Verdict of a swap-boundary re-price check (:meth:`FabricArbiter.
    reprice`): whether the prices a pending plan was solved under moved
    materially (past ``price_hint_rel``) since issue, the relative move,
    and the live price vector to re-solve against."""

    moved: bool
    rel_change: float
    prices: Optional[np.ndarray]


def _same_prices(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(a, b)


def _price_rel_change(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> float:
    """Relative movement between two price vectors: peak absolute change
    over the peak price across both (``None`` counts as all-zero), the
    same normalization the publish-side hint uses on committed loads."""
    if a is None and b is None:
        return 0.0
    if a is None:
        a = np.zeros_like(b)
    elif b is None:
        b = np.zeros_like(a)
    scale = max(float(a.max()), float(b.max()))
    if scale <= 0.0:
        return 0.0
    return float(np.max(np.abs(a - b))) / scale


class FabricArbiter:
    """Shared congestion-pricing layer above per-tenant MWU planners."""

    def __init__(
        self,
        topo: Topology,
        cost_model: CostModel | None = None,
        cfg: ArbiterConfig | None = None,
    ):
        self.cfg = cfg or ArbiterConfig()
        self.state = FabricState(topo, cost_model)
        self.bus = LinkEventBus()
        self.stats = ArbiterStats()
        self._tenants: Dict[str, TenantConfig] = {}
        self._gates: Dict[str, TokenBucket] = {}
        self._runtimes: Dict[str, object] = {}
        self._bus_tokens: Dict[str, int] = {}
        self._hinted_load: Optional[np.ndarray] = None

    @classmethod
    def from_session(cls, session) -> "FabricArbiter":
        """Build the shared arbiter for a :class:`repro_torch.api.Session`.

        Narrow construction hook (DESIGN.md §5): duck-typed on
        ``session.topo`` / ``session.cost_model`` / ``session.spec.
        arbiter``, so this module never imports ``repro_torch.api``.  Sessions
        that *join* an existing fabric pass it via ``SessionSpec.fabric``
        instead of constructing one here.  ``spec.arbiter_config()`` folds
        the session-level calibrated ``price_decay`` into the arbiter
        config.
        """
        return cls(
            session.topo, session.cost_model,
            cfg=session.spec.arbiter_config(),
        )

    # -- registration -----------------------------------------------------------
    def register(self, name: str, cfg: TenantConfig | None = None) -> str:
        """Register a tenant by name; returns the name for chaining."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        cfg = cfg or TenantConfig()
        self._tenants[name] = cfg
        self._gates[name] = TokenBucket(cfg.admission)
        return name

    def register_runtime(
        self, name: str, runtime, cfg: TenantConfig | None = None
    ) -> str:
        """Register an :class:`~repro_torch.runtime.OrchestrationRuntime` tenant.

        Binds the runtime to this arbiter (its solves pick up exported
        prices, its replans pass through the gate, its executed loads are
        committed to the ledger every window) and subscribes it to the
        event bus so broadcast link events land in its own event log.
        """
        # structural check: same geometry and base capacities.  The final
        # fingerprint component (per-link degradation scales) is excluded —
        # a broadcast event rebuilds the ledger's scales immediately while
        # runtimes apply theirs at window boundaries, so transient scale
        # divergence between the two views is expected, not an error.
        if runtime.topo.fingerprint[:-1] != self.state.fingerprint[:-1]:
            raise ValueError(
                f"tenant {name!r} topology disagrees with the fabric's — "
                "all tenants must share one fabric geometry"
            )
        self.register(name, cfg)
        runtime.bind_arbiter(self, name)
        self._runtimes[name] = runtime

        def _deliver(events, rt=runtime, me=name):
            # one bus, two payload kinds: LinkEvents land in the tenant's
            # own event log (applied at its window boundaries), while
            # "prices moved" hints go straight to the fabric-pressure
            # clock — skipping the committer itself, whose own commit
            # never moves its own exported prices
            for ev in events:
                if isinstance(ev, PricesMovedHint):
                    if ev.tenant != me:
                        rt.notify_fabric_pressure()
                else:
                    rt.events.schedule(ev)

        self._bus_tokens[name] = self.bus.subscribe(_deliver)
        return name

    def unregister(self, name: str) -> None:
        """Drop a tenant: withdraw its load, unbind, unsubscribe.

        **Idempotent** (the reference pins it in ``tests/test_faults.py``): unregistering
        a name that is unknown — or already unregistered by a racing
        teardown path (session close vs. staleness eviction) — is a no-op
        end to end; every sub-step tolerates the missing entry, including
        ``FabricState.withdraw``.
        """
        self._tenants.pop(name, None)
        self._gates.pop(name, None)
        self.state.withdraw(name)
        runtime = self._runtimes.pop(name, None)
        if runtime is not None:
            runtime.bind_arbiter(None, None)
        token = self._bus_tokens.pop(name, None)
        if token is not None:
            self.bus.unsubscribe(token)
        # a departing tenant's withdrawn load is a price move for every
        # survivor — without this, a demand-stable tenant keeps routing
        # around a peer that is long gone.  ``require_peers=False``: the
        # hint matters even (especially) when one tenant remains.
        self._maybe_publish_price_hint(name, require_peers=False)

    def tenants(self) -> List[str]:
        return list(self._tenants)

    def tenant_order(self, names: Iterable[str] | None = None) -> List[str]:
        """Canonical sweep order: QoS rank, then name.

        Registration order is deliberately *not* part of the key, so two
        arbiters registered in different orders produce identical plans
        (ordering-determinism invariant, ``tests/test_torch_fabric.py``).
        """
        names = self.tenants() if names is None else list(names)
        for t in names:
            if t not in self._tenants:
                raise KeyError(f"tenant {t!r} not registered")
        return sorted(names, key=lambda t: (QOS_RANK[self._tenants[t].qos], t))

    # -- pricing ----------------------------------------------------------------
    def prices_for(self, name: str) -> Optional[np.ndarray]:
        """Exported prices for ``name``: external load over tenant weight.

        ``None`` (not a zero vector) when no peer has committed load, so
        callers can take the exact unarbitrated solve path — the
        single-tenant zero-overhead contract.  Prices are non-negative and
        elementwise monotone in peers' committed load by construction.

        With ``ArbiterConfig.price_decay`` set, each peer's contribution is
        recency-weighted (``FabricState.decay_factor``): stale telemetry
        fades with a ``price_decay``-window half-life instead of steering
        this tenant's solve forever, and the decayed prices are monotone
        non-increasing in staleness.  ``price_decay=None`` exports the raw
        ledger — byte-identical to the pre-recency arbiter.
        """
        if name not in self._tenants:
            raise KeyError(f"tenant {name!r} not registered")
        ext = self.state.external_load(name, half_life=self.cfg.price_decay)
        if not ext.any():
            return None
        return ext / self._tenants[name].weight

    def reprice(
        self, name: str, solved_prices: Optional[np.ndarray]
    ) -> RepriceDecision:
        """Swap-boundary re-price check (DESIGN.md §4.3).

        ``OrchestrationRuntime`` calls this when a pending plan reaches its
        swap boundary, passing the prices the plan was *solved* under.  The
        verdict compares them against the live ``prices_for(name)``: when
        the peak relative move is at least ``price_hint_rel``, the plan is
        priced stale — the fabric shifted inside the issue→swap window —
        and the caller should swap it in anyway (it is fresher than the
        active plan) but immediately re-solve the same demand against
        ``decision.prices`` and park the refinement as the next pending
        (swap-and-refine, see ``OrchestrationRuntime._maybe_swap``).
        ``price_hint_rel <= 0`` disables repricing (never moved),
        mirroring the publish-side hint switch.  Read-only: no ledger or
        gate state changes; only ``stats.reprices`` counts the stale
        verdicts.
        """
        prices = self.prices_for(name)
        rel = _price_rel_change(solved_prices, prices)
        moved = self.cfg.price_hint_rel > 0 and rel >= self.cfg.price_hint_rel
        if moved:
            self.stats.reprices += 1
        return RepriceDecision(moved=moved, rel_change=rel, prices=prices)

    def commit(
        self,
        name: str,
        resource_bytes: np.ndarray,
        window: Optional[int] = None,
        fingerprint: Optional[tuple] = None,
    ) -> None:
        """Telemetry export: replace ``name``'s committed load in the ledger.

        ``window`` stamps the commit for recency decay (runtime tenants
        pass their window counter; host commits stay unstamped/timeless);
        ``fingerprint`` is validated against the fabric's — see
        ``FabricState.commit``.
        """
        if name not in self._tenants:
            raise KeyError(f"tenant {name!r} not registered")
        self.state.commit(
            name, resource_bytes, window=window, fingerprint=fingerprint
        )
        self.stats.commits += 1
        self._maybe_publish_price_hint(name)
        self._maybe_evict()

    def _maybe_evict(self) -> None:
        """Unregister tenants whose heartbeat went stale (DESIGN.md §9).

        Piggybacked on :meth:`commit` — a live tenant's heartbeat is what
        advances the fabric clock, so eviction needs no timer of its own.
        A crashed tenant's committed load first fades under ``price_decay``
        (survivors gradually stop routing around it) and is withdrawn
        outright once ``evict_staleness`` windows pass with no commit;
        ``unregister`` makes a later teardown of the crashed session a
        harmless double-unregister.
        """
        threshold = self.cfg.evict_staleness
        if threshold is None:
            return
        stale = [
            t for t in self._tenants
            if (s := self.state.staleness(t)) is not None and s >= threshold
        ]
        for t in stale:
            self.unregister(t)
            self.stats.evictions += 1

    def _maybe_publish_price_hint(
        self, committer: str, require_peers: bool = True
    ) -> None:
        """Publish a :class:`~repro_torch.runtime.events.PricesMovedHint` when
        the ledger moved materially since the last hint.

        The relative change is measured against the peak committed load
        (``max`` over both snapshots), so a fabric ramping up from idle
        registers as a full move while steady-state telemetry jitter stays
        under the threshold.  With ``require_peers`` (the commit path),
        solo fabrics never hint — part of the single-tenant zero-overhead
        contract; withdrawal passes ``False`` because the survivors of a
        departure must learn about it no matter how few remain.

        A hint with nobody listening is pure noise: when the bus has no
        subscribers (``unregister`` removes the departing tenant's
        subscription *before* hinting, so the last runtime's own departure
        leaves the bus empty), nothing is published, ``stats.price_hints``
        stays put, and the hinted-load watermark is left alone — a
        subscriber arriving later still sees the accumulated move against
        the last snapshot that was actually delivered.
        """
        if self.cfg.price_hint_rel <= 0:
            return
        if require_peers and len(self._tenants) < 2:
            return
        if len(self.bus) == 0:
            return
        total = self.state.total_load()
        rel = _price_rel_change(total, self._hinted_load)
        if rel < self.cfg.price_hint_rel:
            return
        self._hinted_load = total.copy()
        self.stats.price_hints += 1
        self.bus.publish([
            PricesMovedHint(
                tenant=committer, rel_change=rel, clock=self.state.clock
            )
        ])

    # -- admission --------------------------------------------------------------
    def admit(
        self, name: str, window: int, reason: str = "congestion"
    ) -> AdmissionDecision:
        """Gate one replan request (see :mod:`repro_torch.fabric.admission`)."""
        if name not in self._tenants:
            raise KeyError(f"tenant {name!r} not registered")
        gate = self._gates[name]
        if reason == "topology":
            verdict = AdmissionDecision(True, "topology", gate.tokens(window))
        elif len(self._tenants) < 2:
            verdict = AdmissionDecision(True, "solo", gate.tokens(window))
        elif self._tenants[name].qos == "gold":
            verdict = AdmissionDecision(True, "qos", gate.tokens(window))
        elif gate.try_take(window):
            verdict = AdmissionDecision(True, "ok", gate.tokens(window))
        else:
            verdict = AdmissionDecision(False, "throttled", gate.tokens(window))
        if verdict.admitted:
            self.stats.admitted += 1
        else:
            self.stats.throttled += 1
        return verdict

    # -- link events ------------------------------------------------------------
    def broadcast(self, events) -> int:
        """Fan one event (or a batch) out to the fabric and every tenant.

        The arbiter has no window clock, so the ledger's topology rebuilds
        **immediately** regardless of ``LinkEvent.window`` — its capacities
        feed only drain/fairness accounting, where reflecting the latest
        known fabric state is the useful behavior.  Registered runtimes
        receive the events on the bus and apply them **at their own window
        boundaries**, exactly like locally-scheduled events; same-link
        batches compose by the shared last-wins rule
        (:func:`repro_torch.runtime.events.merge_overrides`), so the two views
        converge once the events fall due.  Returns the listener count.
        """
        evs = list(events) if isinstance(events, (list, tuple)) else [events]
        self.state.apply_link_overrides(dict(merge_overrides(evs)))
        self.stats.broadcasts += 1
        return self.bus.publish(evs)

    # -- host-level co-planning -------------------------------------------------
    def arbitrate(
        self,
        demands: Mapping[str, Mapping[PairKey, float]],
        n_sweeps: int | None = None,
    ) -> Dict[str, Plan]:
        """Co-plan all tenants to a priced equilibrium (sequential greedy).

        Each sweep walks the canonical tenant order; a tenant whose prices
        are unchanged since its last solve is at its best response already
        and is skipped.  Converges in practice within 2-3 sweeps (demand
        decays geometrically inside each MWU); capped at ``n_sweeps``.
        """
        order = self.tenant_order(demands)
        plans: Dict[str, Plan] = {}
        solved_prices: Dict[str, Optional[np.ndarray]] = {}
        for _ in range(n_sweeps or self.cfg.n_sweeps):
            moved = False
            for t in order:
                prices = self.prices_for(t)
                if t in plans and _same_prices(prices, solved_prices[t]):
                    continue
                plan = solve_mwu(
                    self.state.topo, demands[t], self.state.cm,
                    ext_loads=prices,
                )
                plans[t] = plan
                solved_prices[t] = prices
                self.commit(t, plan.resource_bytes)
                self.stats.solves += 1
                moved = True
            self.stats.sweeps += 1
            if not moved:
                break
        return plans

    # -- accounting -------------------------------------------------------------
    def weights(self) -> Dict[str, float]:
        return {t: cfg.weight for t, cfg in self._tenants.items()}

    def combined_drain_s(self) -> float:
        return self.state.combined_drain_s()

    def fairness_report(self) -> dict:
        """Tagged ``nimble.fabric_fairness/v1`` record for the current ledger."""
        return fairness_report(self.state, self.weights())

    def to_json_obj(self) -> dict:
        return tag(
            "fabric_arbiter",
            {
                "tenants": self.tenant_order(),
                "weights": {t: w for t, w in sorted(self.weights().items())},
                "stats": self.stats.to_json_obj(),
                "state": self.state.to_json_obj(),
                "fairness": self.fairness_report(),
            },
        )
