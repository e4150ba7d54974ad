"""Replan triggers with hysteresis — the *decide* stage of the runtime loop.

Counterpart of ``repro/runtime/policy.py``, copied as it is (numpy and the
stdlib only).

A replan costs planner time, a plan-cache probe, and (amortized) jit solve
latency, so the policy's job is asymmetric: fire promptly when the active
plan has genuinely degraded, and **never** fire on balanced traffic — the
paper's "matches baseline under balanced traffic" claim is a statement
about this trigger, not about the planner.

The congestion signal is *self-calibrated*: every plan records its own
``baseline_ratio`` — predicted max normalized load Z over the cut lower
bound Z* — at solve time (even a perfect plan sits somewhat above the
bound, and how far depends on topology and skew).  The trigger compares
the current ratio against ``baseline_ratio * degrade_factor`` rather than
an absolute constant, so a plan is replaced when *it* got worse, not when
the workload is intrinsically hard.

Hysteresis has three guards:

  * **patience** — the threshold must be breached ``patience`` consecutive
    windows (raise above 1 when the demand estimator is noisier than the
    default EWMA, at the cost of one extra stale window per drift);
  * **arming** — after a trigger the policy disarms until the ratio falls
    back under ``baseline_ratio * rearm_factor`` (no re-fire storms while
    a replan is being absorbed);
  * **cooldown** — a minimum number of windows between triggers.

Three triggers bypass the congestion hysteresis: a **staleness deadline**
(optional: plans older than ``max_staleness`` windows replan regardless,
for deployments whose drift is slow but unbounded), **topology events**
(link down/degraded — always replan, immediately), and **fabric
pressure** (a "prices moved" hint from the fabric arbiter — peers'
committed load shifted materially — is treated as a *soft staleness
deadline*: within ``fabric_staleness`` windows of the hint the tenant
replans with ``reason="fabric"`` even if its own demand is perfectly
stable, so it re-prices the fabric it actually shares; see
``FabricArbiter`` price hints, DESIGN.md §4.3).  The constructor default
``fabric_staleness=None`` keeps hand-wired runtimes bit-identical to the
pre-hint behavior; **arbitrated sessions** enable it with the calibrated
``repro.api.FABRIC_STALENESS_DEFAULT`` (2 windows — one boundary of
grace so an in-flight replan can absorb the shift, calibrated on the
mutual-drift scenarios in ``benchmarks/bench_fairness.py``).  The trigger
covers tenants with *no* replan in flight; the complementary issue→swap
staleness window is closed by the controller's swap-boundary re-pricing
(``OrchestrationRuntime._maybe_swap`` + ``FabricArbiter.reprice``).

**Flap backoff** (DESIGN.md §9).  "Topology events always replan" is the
right reflex for a single failure and a replan storm under a *flapping*
link: every down/restore pair would force a fresh solve, churning the
plan cache and the fabric's priced equilibrium faster than either can
converge.  Topology triggers therefore carry an exponential backoff:
after a topology-triggered replan at window *w* with backoff *b*,
further topology events before *w + b* are **suppressed** with
``reason="backoff"`` (the controller still rebuilds its tables — the
fabric view stays truthful — it just keeps serving the current plan's
split ratios on the degraded capacities).  Consecutive topology fires
inside ``flap_reset_windows`` of each other grow the backoff
geometrically (``flap_backoff_base * flap_backoff_factor ** level``, cap
``flap_backoff_max``); a quiet stretch resets it, so an isolated failure
months after a flap train replans immediately again.  A suppressed event
is **deferred, never dropped**: the first ``decide`` at or past the
backoff horizon fires a catch-up ``reason="topology"`` replan against
live state, which is how the fabric re-optimizes after the final restore
of a flap train.  The replan count under an F-event flap train is thus
O(log F + duration / cap) instead of F.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    degrade_factor: float = 1.15  # trigger: ratio > baseline * degrade_factor
    rearm_factor: float = 1.05    # re-arm: ratio < baseline * rearm_factor
    patience: int = 1             # consecutive breaching windows to fire
    cooldown_windows: int = 2     # min windows between congestion triggers
    max_staleness: Optional[int] = None  # windows; None = no deadline
    # windows between a fabric "prices moved" hint and a forced replan
    # (soft staleness deadline); None disables the fabric-pressure trigger
    # (hand-wired default — arbitrated Sessions pass the calibrated
    # repro.api.FABRIC_STALENESS_DEFAULT instead)
    fabric_staleness: Optional[int] = None
    # flap-aware exponential backoff on topology triggers: after a
    # topology replan, further topology events inside the backoff window
    # are suppressed (reason="backoff") and deferred.  base=0 disables
    # (every topology event replans immediately — the pre-backoff
    # behavior).  The default base of 1 is invisible to isolated events:
    # a single down (or down+restore a few windows apart) still replans
    # immediately; only rapid-fire trains hit the growing backoff.
    flap_backoff_base: int = 1
    flap_backoff_factor: float = 2.0
    flap_backoff_max: int = 8
    # a topology-quiet stretch of more than this many windows resets the
    # backoff level, so the next isolated event replans immediately again
    flap_reset_windows: int = 16


@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    replan: bool
    # "topology" | "congestion" | "staleness" | "fabric" | "backoff" |
    # "none"; an arbitrated controller may rewrite a positive decision to
    # replan=False with reason "gated" when the fabric admission gate
    # throttles the tenant.  "backoff" marks a topology event suppressed
    # by the flap backoff (replan deferred to the backoff horizon).
    reason: str
    ratio: float
    threshold: float


class ReplanPolicy:
    """Stateful trigger evaluation; one instance per runtime."""

    def __init__(self, cfg: PolicyConfig | None = None):
        self.cfg = cfg or PolicyConfig()
        self._breach = 0
        self._armed = True
        self._last_trigger: Optional[int] = None
        self._pressure_window: Optional[int] = None
        # flap-backoff state: current escalation level, the window until
        # which topology triggers are suppressed, the last topology fire
        # (for quiet-period reset), and whether a suppressed event is
        # waiting for a deferred catch-up replan
        self._flap_level = 0
        self._topo_block_until: Optional[int] = None
        self._last_topo_fire: Optional[int] = None
        self._deferred_topo = False

    def decide(
        self,
        *,
        window: int,
        ratio: float,
        baseline_ratio: float,
        plan_age: int,
        pending: bool,
        topology_event: bool = False,
    ) -> ReplanDecision:
        """Evaluate the triggers for one window.

        ``ratio`` is the active plan's predicted-congestion ratio on the
        estimator's next-window demand; ``baseline_ratio`` its ratio at
        solve time; ``plan_age`` windows since the active plan was solved;
        ``pending`` whether a replan is already in flight (congestion and
        staleness stand down; topology events do not — the controller
        discards the in-flight plan, which was solved for dead geometry).
        """
        cfg = self.cfg
        threshold = baseline_ratio * cfg.degrade_factor
        if topology_event:
            if self._flap_blocked(window):
                # flap backoff: suppress the replan storm, defer the
                # catch-up solve to the backoff horizon
                self._deferred_topo = True
                return ReplanDecision(False, "backoff", ratio, threshold)
            self._fire_topology(window)
            return ReplanDecision(True, "topology", ratio, threshold)
        if self._deferred_topo and not self._flap_blocked(window):
            # the backoff horizon passed with a suppressed event on the
            # books: catch-up replan against live state (this is how the
            # fabric re-optimizes after a flap train's final restore)
            self._deferred_topo = False
            self._fire_topology(window)
            return ReplanDecision(True, "topology", ratio, threshold)
        if pending:
            return ReplanDecision(False, "none", ratio, threshold)
        if cfg.max_staleness is not None and plan_age >= cfg.max_staleness:
            self._fired(window)
            return ReplanDecision(True, "staleness", ratio, threshold)
        if (
            cfg.fabric_staleness is not None
            and self._pressure_window is not None
            and window - self._pressure_window >= cfg.fabric_staleness
        ):
            # fabric pressure: peers' prices moved while this tenant's own
            # demand stayed flat — re-price even though nothing congested
            self._pressure_window = None
            self._fired(window)
            return ReplanDecision(True, "fabric", ratio, threshold)

        # congestion trigger with hysteresis
        if not self._armed and ratio < baseline_ratio * cfg.rearm_factor:
            self._armed = True
            self._breach = 0
        if self._armed and ratio > threshold:
            self._breach += 1
        else:
            self._breach = 0
        cooled = (
            self._last_trigger is None
            or window - self._last_trigger >= cfg.cooldown_windows
        )
        if self._armed and self._breach >= cfg.patience and cooled:
            self._fired(window)
            return ReplanDecision(True, "congestion", ratio, threshold)
        return ReplanDecision(False, "none", ratio, threshold)

    def _fired(self, window: int) -> None:
        self._armed = False
        self._breach = 0
        self._last_trigger = window

    def state_snapshot(self) -> dict:
        """The trigger state machine as one numeric-only dict (DESIGN.md
        §11) — armed/breach/backoff internals that previously had no
        outward-facing surface, for the flight recorder's gauges and for
        post-mortem "why didn't it replan?" queries."""
        return {
            "armed": bool(self._armed),
            "breach": int(self._breach),
            "last_trigger": self._last_trigger,
            "pressure_window": self._pressure_window,
            "flap_level": int(self._flap_level),
            "topo_block_until": self._topo_block_until,
            "deferred_topo": bool(self._deferred_topo),
        }

    # -- flap backoff ----------------------------------------------------------
    def _flap_blocked(self, window: int) -> bool:
        """Inside the topology-trigger backoff window?"""
        return (
            self.cfg.flap_backoff_base > 0
            and self._topo_block_until is not None
            and window < self._topo_block_until
        )

    def _fire_topology(self, window: int) -> None:
        """Record a topology-triggered replan and arm the next backoff.

        Fires inside ``flap_reset_windows`` of the previous one escalate
        the backoff level (geometric growth toward ``flap_backoff_max``);
        a longer quiet period resets to the base, so isolated failures
        keep replanning immediately.
        """
        cfg = self.cfg
        if cfg.flap_backoff_base > 0:
            if (
                self._last_topo_fire is not None
                and window - self._last_topo_fire <= cfg.flap_reset_windows
            ):
                self._flap_level += 1
            else:
                self._flap_level = 0
            backoff = min(
                cfg.flap_backoff_base
                * cfg.flap_backoff_factor ** self._flap_level,
                float(cfg.flap_backoff_max),
            )
            self._topo_block_until = window + int(round(backoff))
        self._last_topo_fire = window
        # a direct fire subsumes any deferred catch-up: the solve it
        # triggers already sees the latest topology
        self._deferred_topo = False
        self._fired(window)

    def notify_swap(self, solved_window: Optional[int] = None) -> None:
        """Re-arm when a new plan becomes active.

        Disarming exists to stop re-fire storms *while the triggering
        plan is still active*; once the swap lands, the new plan is judged
        against its own baseline from a clean state.  Without this, a plan
        solved on transitional (mid-drift) demand whose ratio never falls
        below the re-arm watermark would pin the policy disarmed forever.

        A swap also satisfies a pending fabric-pressure deadline — but
        only one the incoming plan could actually have seen: the plan was
        priced at ``solved_window``, so a hint that arrived *after* the
        solve was issued describes a fabric shift the plan missed, and its
        clock must keep running.  ``solved_window=None`` (callers without
        solve provenance) conservatively clears.
        """
        self._armed = True
        self._breach = 0
        if (
            solved_window is None
            or self._pressure_window is None
            or self._pressure_window <= solved_window
        ):
            self._pressure_window = None

    def notify_gated(self) -> None:
        """Re-arm when the fabric admission gate cancels a fired trigger.

        :meth:`decide` disarmed on firing, but the gate suppressed the
        replan — no solve, no swap, so :meth:`notify_swap` will never run.
        Without re-arming here, a congestion trigger under persistent
        drift (ratio never falls below the re-arm watermark) would stay
        disarmed forever and the tenant would never replan again even
        after its tokens refill.  The trigger cooldown still spaces the
        retries.
        """
        self._armed = True
        self._breach = 0

    def notify_fabric_pressure(self, window: int) -> None:
        """Start (or keep) the soft fabric-staleness clock at ``window``.

        Called by the controller when a :class:`~repro.runtime.events.
        PricesMovedHint` arrives from the fabric arbiter.  The earliest
        hint wins — repeated hints while the deadline is already running
        must not push it out, or a chatty fabric would starve the trigger.
        No-op unless ``PolicyConfig.fabric_staleness`` is set (the default
        keeps arbitrated runtimes byte-identical to pre-hint behavior).
        """
        if self._pressure_window is None:
            self._pressure_window = window


class NeverReplan(ReplanPolicy):
    """Static one-shot baseline: plan once, never again (topology included)."""

    def decide(self, *, window, ratio, baseline_ratio, plan_age, pending,
               topology_event=False) -> ReplanDecision:
        return ReplanDecision(
            False, "none", ratio, baseline_ratio * self.cfg.degrade_factor
        )
