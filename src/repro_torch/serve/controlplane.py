"""Continuous-traffic control plane over the NIMBLE stack.

Counterpart of ``repro/serve/controlplane.py``.  Every runtime solve of a
run — each adaptive tenant's ``Session`` and each static tenant's one-shot
plan — runs on the run's ``device``: the card unless the caller names the
CPU, and asking for the card on a host without one raises.

:class:`ControlPlane` turns a declarative :class:`~repro_torch.serve.scenario.
ScenarioSpec` into a *running service*: it owns one shared fabric, spawns
and retires tenant sessions on the scenario's churn schedule, advances
every live tenant window-by-window through ``Session.step`` while
streaming the embedded fault schedule in via the ``step(observed=,
completion_scale=)`` drill hooks (DESIGN.md §9), and keeps **online** SLO
accounting as it goes — ring-buffer latency percentiles, per-tenant drain
ledgers, availability against the healthy-median baseline.  The outcome is
a tagged ``nimble.serve/v1`` :class:`ServeReport`.

Two arms, one loop: ``mode="adaptive"`` runs each tenant as an arbitrated
:class:`~repro_torch.api.Session` on a shared congestion-pricing
:class:`~repro_torch.fabric.FabricArbiter` (calibrated price recency on);
``mode="static"`` runs each tenant as a one-shot plan solved at join and
never revisited — the unpriced baseline every drain SLO is measured
against.  :func:`evaluate_slo` applies a scenario's :class:`~repro_torch.serve.
scenario.SloSpec` gates to an (adaptive, static) report pair.

Cluster latency is the **stacked** per-window drain — every live tenant's
executed per-resource load summed, drained at the *current* (possibly
degraded) capacities — the same contention metric the fairness bench
gates, not the per-tenant solo simulation (which feeds the per-tenant
ledgers instead).  Fault-window event timing is translated per tenant: a
scenario-window event reaches a churned tenant shifted into its *local*
window clock, so a tenant that joined at window 12 sees a window-20 flap
exactly 8 windows into its own life.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.session import Session
from ..api.spec import PRICE_DECAY_DEFAULT, SessionSpec
from ..core.cost import ResourceModel
from ..core.fabsim import simulate
from ..core.mcf import apply_plan_fractions
from ..core.planner import PlannerConfig
from ..fabric import ArbiterConfig, FabricArbiter
from ..faults.injector import FaultInjector, FaultSchedule
from ..jsonio import schema_kind, tag
from ..runtime.controller import demand_dict, solve_device, solve_plans_batch
from ..runtime.events import LinkEvent, merge_overrides
from .scenario import ScenarioSpec, SloSpec, TenantSpec

#: control-plane arms
SERVE_MODES = ("adaptive", "static")

#: recovery threshold: cluster latency back within this factor of the
#: healthy median counts as recovered (matches the fault-drill harness)
RECOVERY_FACTOR = 1.5


class RingPercentiles:
    """Bounded online latency window: percentiles over the last N samples.

    The control plane never holds the full history hostage to the horizon
    — a week-long scenario keeps O(capacity) floats per ring, and the SLO
    percentiles are over the trailing window, which is what a serving p99
    means anyway.
    """

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    def add(self, value: float) -> None:
        self._ring.append(float(value))

    def __len__(self) -> int:
        return len(self._ring)

    def percentile(self, p: float) -> float:
        if not self._ring:
            return 0.0
        return float(np.percentile(np.asarray(self._ring), p))

    def median(self) -> float:
        return self.percentile(50.0)

    def values(self) -> List[float]:
        """The retained trailing samples, oldest first."""
        return list(self._ring)


@dataclasses.dataclass
class TenantLedger:
    """Per-tenant online drain accounting (one per spawned session)."""

    name: str
    qos: str
    weight: float
    joined: int
    left: Optional[int] = None
    crashed: bool = False
    windows: int = 0
    payload_bytes: float = 0.0
    completion_s: float = 0.0
    replans: int = 0
    ring: RingPercentiles = dataclasses.field(
        default_factory=lambda: RingPercentiles()
    )

    def record(self, completion_s: float, payload_bytes: float,
               replan_issued: bool) -> None:
        self.windows += 1
        self.completion_s += completion_s
        self.payload_bytes += payload_bytes
        self.replans += int(replan_issued)
        self.ring.add(completion_s)

    def throughput_gbs(self) -> float:
        if self.completion_s <= 0:
            return 0.0
        return self.payload_bytes / self.completion_s / 1e9

    def to_json_obj(self) -> dict:
        return {
            "qos": self.qos,
            "weight": self.weight,
            "joined": self.joined,
            "left": self.left,
            "crashed": self.crashed,
            "windows": self.windows,
            "payload_bytes": self.payload_bytes,
            "completion_s": self.completion_s,
            "mean_completion_s": (
                self.completion_s / self.windows if self.windows else 0.0
            ),
            "p99_completion_s": self.ring.percentile(99.0),
            "replans": self.replans,
            "throughput_gbs": self.throughput_gbs(),
        }


class _StaticTenant:
    """Baseline arm: one plan solved at join, followed forever.

    Mirrors ``runtime.run_static`` — the solve happens once on the
    join-window demand and join-time (possibly already degraded) fabric;
    every later window executes under those frozen split ratios on
    whatever the fabric has become.  No telemetry, no pricing, no replan.
    """

    def __init__(self, topo, demand0: np.ndarray,
                 pcfg: Optional[PlannerConfig] = None, device="cuda"):
        self._pcfg = pcfg or PlannerConfig(n_iters=32)
        self._plan = solve_plans_batch(
            topo, demand0[None], None, self._pcfg, device=device
        )[0]
        self._chunk_bytes = float(1 << 20)

    def step(self, demand: np.ndarray, topo, completion_scale: float = 1.0):
        """(completion_s, payload_bytes, resource_bytes) for one window."""
        dem = demand_dict(np.asarray(demand, dtype=np.float64))
        exec_plan = apply_plan_fractions(self._plan, dem, topo=topo)
        sim = simulate(exec_plan, self._chunk_bytes)
        return (
            float(sim.completion_time) * completion_scale,
            float(sim.total_payload),
            exec_plan.resource_bytes,
        )

    def close(self) -> None:
        pass


@dataclasses.dataclass
class ServeReport:
    """Outcome of one control-plane run (``nimble.serve/v1``)."""

    scenario: str
    mode: str
    windows: int
    n_devices: int
    seed: int
    tenants: Dict[str, TenantLedger]
    window_latency_s: List[float]       # per-window stacked cluster drain
    healthy_median_s: float
    fault_start: Optional[int]
    last_event_window: Optional[int]
    recovery_windows: Optional[int]
    availability: float
    jain_index: float
    fault_digest: Optional[str] = None
    fairness: Optional[dict] = None     # fabric fairness (adaptive arm)
    metrics: Optional[dict] = None      # nimble.metrics/v1 (recorder runs)

    @property
    def total_completion_s(self) -> float:
        """Cluster service time: sum of the stacked per-window drains."""
        return float(sum(self.window_latency_s))

    def median_latency_s(self) -> float:
        if not self.window_latency_s:
            return 0.0
        return float(np.median(np.asarray(self.window_latency_s)))

    def p99_latency_s(self) -> float:
        if not self.window_latency_s:
            return 0.0
        return float(np.percentile(np.asarray(self.window_latency_s), 99.0))

    def tenant_completion(self, name: str) -> float:
        return self.tenants[name].completion_s

    def to_json_obj(self) -> dict:
        med = self.median_latency_s()
        p99 = self.p99_latency_s()
        payload = {
            "scenario": self.scenario,
            "mode": self.mode,
            "windows": self.windows,
            "n_devices": self.n_devices,
            "seed": self.seed,
            "tenants": {
                t: led.to_json_obj() for t, led in sorted(self.tenants.items())
            },
            "cluster": {
                "total_completion_s": self.total_completion_s,
                "median_latency_s": med,
                "p99_latency_s": p99,
                "p99_over_median": (p99 / med) if med > 0 else 1.0,
                "healthy_median_s": self.healthy_median_s,
                "availability": self.availability,
                "jain_index": self.jain_index,
                "fault_start": self.fault_start,
                "last_event_window": self.last_event_window,
                "recovery_windows": self.recovery_windows,
            },
        }
        if self.fault_digest is not None:
            payload["fault_digest"] = self.fault_digest
        if self.fairness is not None:
            payload["fairness"] = self.fairness
        if self.metrics is not None:
            payload["metrics"] = self.metrics
        return tag("serve", payload)


class ControlPlane:
    """Run one scenario end-to-end: spawn → serve → drill → retire."""

    def __init__(self, spec: ScenarioSpec, mode: str = "adaptive",
                 recorder=None, device="cuda"):
        if mode not in SERVE_MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {SERVE_MODES}")
        self.spec = spec
        self.mode = mode
        # every tenant's solves run here; the card unless the CPU is named,
        # and no card raises now rather than at the first spawn
        self.device = solve_device(device)
        # flight recorder (repro_torch.obs.FlightRecorder, duck-typed): threaded
        # down to every spawned Session so the whole scenario records under
        # one correlation id; None / disabled keeps this path byte-free
        self._obs = (
            recorder
            if recorder is not None and getattr(recorder, "enabled", False)
            else None
        )
        self.topo_base = spec.topology.build()
        self.schedule: Optional[FaultSchedule] = (
            FaultInjector(self.topo_base).compile(spec.faults)
            if spec.faults is not None
            else None
        )
        self.roster: Tuple[TenantSpec, ...] = spec.roster()
        # background elephant flows are injected into exactly one tenant's
        # executed demand — the first base tenant (the scenario's victim) —
        # so the extra bytes hit the fabric once, not once per tenant
        self._elephant_target = spec.tenants[0].name

    # -- the loop ----------------------------------------------------------------
    def run(self) -> ServeReport:
        spec, schedule = self.spec, self.schedule
        n = self.topo_base.n_devices
        adaptive = self.mode == "adaptive"

        arbiter: Optional[FabricArbiter] = None
        if adaptive:
            arbiter = FabricArbiter(
                self.topo_base,
                cfg=ArbiterConfig(price_decay=PRICE_DECAY_DEFAULT),
            )
        topo_now = self.topo_base
        overrides: Dict[Tuple[int, int], float] = {}
        static_rm = ResourceModel(topo_now)

        events_by_window: Dict[int, List[LinkEvent]] = {}
        if schedule is not None:
            for ev in schedule.events:
                events_by_window.setdefault(ev.window, []).append(ev)

        live: Dict[str, object] = {}
        joined_at: Dict[str, int] = {}
        ledgers: Dict[str, TenantLedger] = {}
        window_latency: List[float] = []
        cluster_ring = RingPercentiles()

        def spawn(t: TenantSpec, w: int) -> None:
            demand0 = t.traffic.demand(w, n)
            if self._obs is not None:
                self._obs.tracer.instant(
                    "spawn", "serve", "cluster",
                    {"tenant": t.name, "window": w, "mode": self.mode},
                )
            if adaptive:
                sess = Session(SessionSpec(
                    topology=self.topo_base,
                    adaptivity="arbitrated",
                    tenant=t.name,
                    qos=t.qos,
                    weight=t.weight,
                    fabric=arbiter,
                    initial_demand=demand0,
                    device=str(self.device),
                ), recorder=self._obs)
                # a tenant joining a degraded fabric must degrade *now*:
                # replay the cumulative overrides into its local window 0
                for (src, dst), scale in sorted(overrides.items()):
                    if scale != 1.0:
                        sess.runtime.events.schedule(
                            LinkEvent(0, src, dst, scale)
                        )
                live[t.name] = sess
            else:
                live[t.name] = _StaticTenant(
                    topo_now, demand0, device=self.device
                )
            joined_at[t.name] = w
            ledgers[t.name] = TenantLedger(
                name=t.name, qos=t.qos, weight=t.weight, joined=w
            )

        def retire(name: str, w: int, crashed: bool = False) -> None:
            live.pop(name).close()
            led = ledgers[name]
            led.left = w
            led.crashed = crashed
            if self._obs is not None:
                self._obs.tracer.instant(
                    "retire", "serve", "cluster",
                    {"tenant": name, "window": w, "crashed": crashed},
                )

        for w in range(spec.windows):
            if self._obs is not None:
                tr = self._obs.tracer
                tr.advance_to(w * 1000)
                w_span = tr.begin(
                    "scenario-window", "serve", "cluster",
                    {"window": w, "scenario": spec.name, "mode": self.mode},
                )
            else:
                w_span = None
            # retire: scheduled departures, then crash-silenced tenants
            for t in self.roster:
                if t.leave_window == w and t.name in live:
                    retire(t.name, w)
                elif (
                    t.name in live
                    and schedule is not None
                    and schedule.crashed(t.name, w)
                ):
                    retire(t.name, w, crashed=True)
            # spawn this window's joiners (skip tenants already crashed)
            for t in self.roster:
                if t.join_window == w and (
                    schedule is None or not schedule.crashed(t.name, w)
                ):
                    spawn(t, w)
            # fault events due at this scenario window
            due = events_by_window.get(w)
            if due:
                if self._obs is not None:
                    for ev in due:
                        self._obs.tracer.instant(
                            "fault", "serve", "cluster",
                            {"event": ev.describe(), "kind": ev.kind,
                             "window": w},
                        )
                batch = dict(merge_overrides(due))
                overrides.update(batch)
                topo_now = self.topo_base.with_link_scale(overrides)
                static_rm = ResourceModel(topo_now)
                if arbiter is not None:
                    # ledger capacities follow immediately (the broadcast
                    # rule); runtimes get the events shifted into their own
                    # window clocks instead of the shared bus, which only
                    # speaks absolute windows
                    arbiter.state.apply_link_overrides(batch)
                    for name, sess in live.items():
                        for ev in due:
                            sess.runtime.events.schedule(
                                dataclasses.replace(
                                    ev, window=w - joined_at[name]
                                )
                            )

            # serve: advance every live tenant, stacking executed loads
            scale = schedule.completion_scale(w) if schedule else 1.0
            stacked = np.zeros(static_rm.capacity.shape, dtype=np.float64)
            stepped = False
            for t in self.roster:
                handle = live.get(t.name)
                if handle is None:
                    continue
                D = t.traffic.demand(w, n)
                if schedule is not None and t.name == self._elephant_target:
                    D = schedule.perturbed_demand(w, D)
                if adaptive:
                    obs = schedule.observed_demand(w, D) if schedule else D
                    rep = handle.step(
                        D, observed=obs, completion_scale=scale
                    )
                    comp, payload = rep.completion_s, rep.payload_bytes
                    replanned = rep.replan_issued
                    loads = arbiter.state.committed_load(t.name)
                    if loads is not None:
                        stacked += loads
                else:
                    comp, payload, loads = handle.step(
                        D, topo_now, completion_scale=scale
                    )
                    replanned = False
                    stacked += loads
                ledgers[t.name].record(comp, payload, replanned)
                stepped = True
            if stepped:
                if adaptive:
                    lat = arbiter.state.drain_time_s(stacked) * scale
                else:
                    lat = float(np.max(stacked / static_rm.capacity)) * scale
                window_latency.append(lat)
                cluster_ring.add(lat)
            else:
                lat = 0.0
                window_latency.append(0.0)
            if w_span is not None:
                obs = self._obs
                obs.tracer.instant(
                    "drain", "serve", "cluster",
                    {"window": w, "latency_s": round(lat, 6),
                     "tenants": len(live)},
                )
                obs.tracer.end(w_span, {"latency_s": round(lat, 6)})
                obs.metrics.histogram(
                    "nimble_serve_window_latency_s",
                    {"scenario": spec.name, "mode": self.mode},
                ).observe(lat)
                obs.metrics.gauge(
                    "nimble_serve_live_tenants",
                    {"scenario": spec.name, "mode": self.mode},
                ).set(len(live))

        # fairness snapshot BEFORE teardown — unregister withdraws loads;
        # same for the metrics registry, which pulls from live runtimes
        fairness = arbiter.fairness_report() if arbiter is not None else None
        metrics = self._collect_metrics(live, arbiter)
        for name in list(live):
            retire(name, spec.windows)

        return self._finalize(window_latency, ledgers, fairness, metrics)

    def _collect_metrics(self, live: Dict[str, object],
                         arbiter: Optional[FabricArbiter]) -> Optional[dict]:
        """Pull every live layer into the recorder's registry and snapshot
        it (``nimble.metrics/v1``) — ``None`` without a recorder, keeping
        ``nimble.serve/v1`` byte-identical to the pre-obs schema."""
        if self._obs is None:
            return None
        from ..obs import collect_arbiter, collect_runtime

        reg = self._obs.metrics
        if self.mode == "adaptive":
            for name, sess in live.items():
                if getattr(sess, "runtime", None) is not None:
                    collect_runtime(reg, sess.runtime, tenant=name)
        if arbiter is not None:
            collect_arbiter(reg, arbiter)
        return reg.snapshot()

    # -- accounting --------------------------------------------------------------
    def _finalize(
        self,
        window_latency: List[float],
        ledgers: Dict[str, TenantLedger],
        fairness: Optional[dict],
        metrics: Optional[dict] = None,
    ) -> ServeReport:
        spec, schedule = self.spec, self.schedule
        lats = np.asarray(window_latency, dtype=np.float64)
        served = lats[lats > 0]

        fault_start: Optional[int] = None
        last_event: Optional[int] = None
        if schedule is not None:
            touched = (
                [ev.window for ev in schedule.events]
                + list(schedule.blackout_prob)
                + list(schedule.straggler_scale)
                + list(schedule.elephant_bytes)
                + list(schedule.crash_windows.values())
            )
            if touched:
                fault_start = min(touched)
            if schedule.events:
                last_event = max(ev.window for ev in schedule.events)

        if fault_start is not None and fault_start > 0:
            healthy = lats[:fault_start]
            healthy = healthy[healthy > 0]
        else:
            healthy = served
        healthy_median = float(np.median(healthy)) if len(healthy) else 0.0

        availability = 1.0
        if len(served) and healthy_median > 0:
            limit = spec.slo.availability_factor * healthy_median
            availability = float((served <= limit).mean())

        recovery: Optional[int] = None
        if last_event is not None and healthy_median > 0:
            for w in range(last_event, len(lats)):
                if 0 < lats[w] <= RECOVERY_FACTOR * healthy_median:
                    recovery = w - last_event
                    break

        # weighted service fairness: throughput per unit weight — a
        # weight-2 tenant is entitled to twice the bytes/s before the
        # index reads it as favored
        from ..fabric.fairness import jains_index

        shares = [
            led.throughput_gbs() / led.weight
            for led in ledgers.values()
            if led.windows > 0
        ]
        jain = jains_index(shares)

        return ServeReport(
            scenario=spec.name,
            mode=self.mode,
            windows=spec.windows,
            n_devices=self.topo_base.n_devices,
            seed=spec.seed,
            tenants=ledgers,
            window_latency_s=window_latency,
            healthy_median_s=healthy_median,
            fault_start=fault_start,
            last_event_window=last_event,
            recovery_windows=recovery,
            availability=availability,
            jain_index=jain,
            fault_digest=(
                schedule.digest() if schedule is not None else None
            ),
            fairness=fairness,
            metrics=metrics,
        )


# -- entry points -----------------------------------------------------------------

def run_scenario(spec: ScenarioSpec, mode: str = "adaptive",
                 recorder=None, device="cuda") -> ServeReport:
    """One arm of one scenario, end to end (optionally flight-recorded),
    every solve on ``device``."""
    return ControlPlane(spec, mode=mode, recorder=recorder, device=device).run()


def evaluate_scenario(spec: ScenarioSpec, recorder=None,
                      device="cuda") -> dict:
    """Both arms plus the SLO verdict — the serve_slo gate's unit of work.

    A recorder, when given, records the **adaptive** arm only: the static
    arm is the unpriced baseline and must stay untouched by observability.
    """
    adaptive = run_scenario(spec, "adaptive", recorder=recorder, device=device)
    static = run_scenario(spec, "static", device=device)
    return {
        "scenario": spec.name,
        "adaptive": adaptive,
        "static": static,
        "slo": evaluate_slo(adaptive, spec.slo, baseline=static),
    }


# -- SLO gating -------------------------------------------------------------------

def evaluate_slo(
    report: ServeReport,
    slo: SloSpec,
    baseline: Optional[ServeReport] = None,
) -> dict:
    """Apply an :class:`SloSpec`'s gates to a run (vs its static baseline).

    Every gate reports ``{ok, value, limit}``; ``pass`` is their
    conjunction.  Baseline-relative gates (combined and per-tenant drain)
    are skipped when no baseline is given — a single-arm run can only be
    judged on its own latency, availability, fairness, and recovery.
    """
    gates: Dict[str, dict] = {}

    # tail latency is judged over *served* windows — those inside the
    # availability envelope (within availability_factor x the healthy
    # median).  A hard link-down window has effectively unbounded stacked
    # drain; that is an outage, charged to the availability and recovery
    # gates, not a latency sample (a request you never served has no p99).
    lats = np.asarray(report.window_latency_s, dtype=np.float64)
    lats = lats[lats > 0]
    if report.healthy_median_s > 0:
        served = lats[
            lats <= slo.availability_factor * report.healthy_median_s
        ]
        if not len(served):
            served = lats
    else:
        served = lats
    med = float(np.median(served)) if len(served) else 0.0
    p99 = float(np.percentile(served, 99.0)) if len(served) else 0.0
    factor = (p99 / med) if med > 0 else 1.0
    gates["p99_latency"] = {
        "ok": factor <= slo.p99_latency_factor,
        "value": factor,
        "limit": slo.p99_latency_factor,
    }
    if slo.p99_latency_s is not None:
        gates["p99_latency_abs"] = {
            "ok": p99 <= slo.p99_latency_s,
            "value": p99,
            "limit": slo.p99_latency_s,
        }

    gates["availability"] = {
        "ok": report.availability >= slo.availability_floor,
        "value": report.availability,
        "limit": slo.availability_floor,
    }
    gates["jain"] = {
        "ok": report.jain_index >= slo.jain_floor,
        "value": report.jain_index,
        "limit": slo.jain_floor,
    }

    if slo.max_recovery_windows is not None:
        rec = report.recovery_windows
        gates["recovery"] = {
            "ok": rec is not None and rec <= slo.max_recovery_windows,
            "value": rec,
            "limit": slo.max_recovery_windows,
        }

    if baseline is not None:
        total = report.total_completion_s
        win = (baseline.total_completion_s / total) if total > 0 else 0.0
        gates["combined_drain"] = {
            "ok": win >= slo.combined_win_floor,
            "value": win,
            "limit": slo.combined_win_floor,
        }
        ratios = []
        for name, led in report.tenants.items():
            ref = baseline.tenants.get(name)
            if ref is None or led.completion_s <= 0:
                continue
            ratios.append(ref.completion_s / led.completion_s)
        worst = min(ratios) if ratios else 1.0
        gates["tenant_drain"] = {
            "ok": worst >= slo.min_drain_ratio,
            "value": worst,
            "limit": slo.min_drain_ratio,
        }

    return {"pass": all(g["ok"] for g in gates.values()), "gates": gates}


# -- record validation (selfcheck) ------------------------------------------------

def validate_serve_record(rec: dict) -> None:
    """Raise ``ValueError`` naming the first violated ``nimble.serve/v1``
    invariant (the shape the selfcheck's check 6 trusts)."""
    if schema_kind(rec) != "serve":
        raise ValueError(
            f"expected a nimble.serve record, got {rec.get('schema')!r}"
        )
    for key in ("scenario", "mode", "windows", "tenants", "cluster"):
        if key not in rec:
            raise ValueError(f"serve record missing {key!r}")
    if rec["mode"] not in SERVE_MODES:
        raise ValueError(f"serve record mode {rec['mode']!r} invalid")
    if rec["windows"] < 1:
        raise ValueError("serve record windows must be >= 1")
    if not rec["tenants"]:
        raise ValueError("serve record has no tenants")
    cl = rec["cluster"]
    for key in ("total_completion_s", "median_latency_s", "p99_latency_s",
                "availability", "jain_index"):
        if key not in cl:
            raise ValueError(f"serve record cluster missing {key!r}")
    if not 0.0 <= cl["availability"] <= 1.0:
        raise ValueError(
            f"availability {cl['availability']} outside [0, 1]"
        )
    if not 0.0 <= cl["jain_index"] <= 1.0 + 1e-9:
        raise ValueError(f"jain_index {cl['jain_index']} outside [0, 1]")
    if cl["total_completion_s"] < 0:
        raise ValueError("total_completion_s must be >= 0")
    for name, t in rec["tenants"].items():
        for key in ("completion_s", "payload_bytes", "windows"):
            if t.get(key, -1) < 0:
                raise ValueError(f"tenant {name!r}: {key} must be >= 0")
