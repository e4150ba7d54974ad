"""Fault drills, the flight recorder's cost and the serve scenarios, through the port.

    python -m repro_torch.launch.drills [--device cpu] [--sections NAME ...]

The sections of the reference's ``benchmarks/bench_faults.py``,
``bench_obs.py`` and ``bench_serve.py`` on a 2-group/8-device fabric, with
every runtime solve on ``device`` (the card unless ``cpu`` is named):

  * **flap** — a flap train on one rail link, with and without the
    policy's flap backoff: topology replans, suppressed windows, recovery
    after the final restore, availability;
  * **blackout** — a full telemetry blackout across a drift-phase change:
    adaptive completion against the static one-shot plan;
  * **tenant_crash** — a co-tenant stops committing on a shared arbitrated
    fabric: staleness eviction, the survivor's tail against a fabric the
    crashed tenant never joined, double teardown;
  * **perturb** — stragglers, a background elephant and partial telemetry
    dropout on one run;
  * **obs** — the drift run flight-recorded and not: the two runs' reports
    must be identical; the recorded trace, provenance and wall-clock cost;
  * **steady**, **elephant_victim**, **flap_under_load** — both control
    plane arms of the built-in scenario and its SLO verdict;
  * **churn** — ``churn_storm`` against the same scenario without churn.

Each section returns the reference's dict, figure for figure (the wall-clock
figures of ``obs`` aside); with ``reports=`` (a dict) it also stores the
``to_json_obj()`` of every ``DrillResult`` and ``ServeReport`` it made.  The
command prints each section's figures and, on the card, the count and median
time of the runtime's solves, each synchronized.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np

from ..api import Session, SessionSpec
from ..core.topology import Topology
from ..fabric import ArbiterConfig, FabricArbiter
from ..faults import (
    ElephantFlowSpec,
    FaultInjector,
    FaultScenario,
    LinkFlapSpec,
    StragglerSpec,
    TelemetryBlackoutSpec,
    TenantCrashSpec,
    run_drill,
)
from ..obs import FlightRecorder, validate_trace
from ..runtime import PolicyConfig, balanced_trace, drifting_skew_trace
from ..serve import evaluate_scenario, get_scenario, run_scenario
from .fairness import solve_summary, timed_solves

N = 8
GROUP = 4
MB = 1 << 20

#: the recorder's wall-clock budget against the unrecorded loop
OVERHEAD_LIMIT = 1.03
#: alternated reps of each arm, and the deeper sample a breach retries with
REPS = 5
ESCALATION_REPS = 10


def _keep(reports: Optional[dict], label: str, obj) -> None:
    if reports is not None:
        reports[label] = obj.to_json_obj()


def _adaptive(topo, device, **kw) -> Session:
    return Session(SessionSpec(topology=topo, adaptivity="adaptive",
                               device=device, **kw))


# -- benchmarks/bench_faults.py ----------------------------------------------------

def flap(windows: int = 28, start: int = 8, cycles: int = 4, device: str = "cuda",
         reports: Optional[dict] = None) -> dict:
    """Flap train on one rail link; backoff arm vs. no-backoff arm."""
    topo = Topology(N, group_size=GROUP)
    trace = balanced_trace(N, windows)
    sched = FaultInjector(topo).compile(
        FaultScenario(
            name="flap",
            flaps=[
                LinkFlapSpec(
                    src=0, dst=GROUP, start=start, cycles=cycles,
                    down_windows=1, up_windows=1,
                )
            ],
        )
    )
    restore = max(ev.window for ev in sched.events)

    with _adaptive(topo, device) as sess:
        backoff = run_drill(sess, trace, sched)
    with _adaptive(topo, device, policy=PolicyConfig(flap_backoff_base=0)) as sess:
        storm = run_drill(sess, trace, sched)
    _keep(reports, "flap backoff", backoff)
    _keep(reports, "flap storm", storm)

    pre = backoff.healthy_median_s(start)
    rec = backoff.recovery_window(after=restore, threshold_s=1.5 * pre)
    topo_backoff = backoff.replans_by_reason().get("topology", 0)
    topo_storm = storm.replans_by_reason().get("topology", 0)
    avail = backoff.availability(pre)
    return {
        "windows": windows,
        "digest": sched.digest(),
        "flap_events": len(sched.events),
        "restore_window": int(restore),
        "recovered_window": rec,
        "recovery_windows": (rec - restore) if rec is not None else None,
        "topology_replans_backoff": int(topo_backoff),
        "topology_replans_storm": int(topo_storm),
        "suppressed_windows": len(backoff.backoff_windows),
        "availability": float(avail),
        "prefault_completion_s": float(pre),
    }


def blackout(windows: int = 48, dwell: int = 12, device: str = "cuda",
             reports: Optional[dict] = None) -> dict:
    """Full telemetry blackout spanning a drift-phase change."""
    topo = Topology(N, group_size=GROUP)
    trace = drifting_skew_trace(N, windows, dwell=dwell)
    start, duration = 2 * dwell - 4, 8   # straddles the phase flip
    sched = FaultInjector(topo).compile(
        FaultScenario(
            name="blackout",
            blackouts=[TelemetryBlackoutSpec(start=start, duration=duration)],
        )
    )
    with Session(SessionSpec(topology=topo, device=device)) as static_sess:
        static = static_sess.run_trace(trace)
    with _adaptive(topo, device) as sess:
        drill = run_drill(sess, trace, sched)
        rt = sess.runtime
        missing = rt.estimator.missing_windows
        confidence = rt.estimator.confidence
    _keep(reports, "blackout", drill)
    pre = drill.healthy_median_s(start)
    ratio = drill.total_completion_s / static.total_completion_s
    avail = drill.availability(pre)
    return {
        "windows": windows,
        "digest": sched.digest(),
        "blackout_start": start,
        "blackout_windows": duration,
        "adaptive_completion_s": drill.total_completion_s,
        "static_completion_s": static.total_completion_s,
        "adaptive_static_ratio": float(ratio),
        "missing_windows": int(missing),
        "confidence_end": float(confidence),
        "availability": float(avail),
    }


def tenant_crash(windows: int = 36, dwell: int = 12, crash_at: int = 14,
                 device: str = "cuda", reports: Optional[dict] = None) -> dict:
    """Co-tenant crash on a shared fabric; staleness eviction + recovery."""
    topo = Topology(N, group_size=GROUP)
    trace = drifting_skew_trace(N, windows, dwell=dwell)
    tail = windows - 2 * dwell   # windows after the post-crash phase flip
    acfg = ArbiterConfig(price_decay=2.0, evict_staleness=6.0)
    sched = FaultInjector(topo).compile(
        FaultScenario(
            name="tenant_crash",
            crashes=[TenantCrashSpec(tenant="B", window=crash_at)],
        )
    )

    def tail_median(reps) -> float:
        return float(np.median([r.completion_s for r in reps[-tail:]]))

    # reference: the survivor on a fabric tenant B never joined
    with Session(SessionSpec(
        topology=topo, adaptivity="arbitrated", tenant="A",
        arbiter=acfg, device=device,
    )) as solo:
        solo_reports = [solo.step(trace[w]) for w in range(windows)]
    solo_tail = tail_median(solo_reports)

    arb = FabricArbiter(topo, cfg=acfg)
    sess_a = Session(SessionSpec(
        topology=topo, adaptivity="arbitrated", tenant="A", fabric=arb,
        device=device,
    ))
    sess_b = Session(SessionSpec(
        topology=topo, adaptivity="arbitrated", tenant="B", fabric=arb,
        device=device,
    ))
    a_reports = []
    for w in range(windows):
        a_reports.append(sess_a.step(trace[w]))
        if not sched.crashed("B", w):
            sess_b.step(trace[w])
    evictions = arb.stats.evictions
    survivors = arb.tenants()
    # double teardown: the crashed session's close runs *after* the
    # arbiter already evicted it — every sub-step must be a no-op
    sess_b.close()
    sess_b.close()
    arb.state.withdraw("B")          # withdraw of an unknown tenant: no-op
    double_teardown_ok = "B" not in arb.tenants() and "A" in arb.tenants()
    sess_a.close()
    if reports is not None:
        reports["tenant_crash survivor"] = [r.to_json_obj() for r in a_reports]
        reports["tenant_crash solo"] = [r.to_json_obj() for r in solo_reports]

    crash_tail = tail_median(a_reports)
    ratio = crash_tail / solo_tail if solo_tail > 0 else 1.0
    return {
        "windows": windows,
        "digest": sched.digest(),
        "crash_window": crash_at,
        "evictions": int(evictions),
        "survivors": survivors,
        "survivor_tail_s": crash_tail,
        "solo_tail_s": solo_tail,
        "survivor_solo_ratio": float(ratio),
        "double_teardown_ok": bool(double_teardown_ok),
    }


def perturb(windows: int = 20, device: str = "cuda",
            reports: Optional[dict] = None) -> dict:
    """Stragglers + background elephant + partial dropout, composed."""
    topo = Topology(N, group_size=GROUP)
    trace = balanced_trace(N, windows)
    sched = FaultInjector(topo).compile(
        FaultScenario(
            name="perturb",
            seed=7,
            stragglers=[StragglerSpec(start=8, duration=4, inflation=3.0)],
            elephants=[
                ElephantFlowSpec(
                    src=1, dst=GROUP + 1, start=4, duration=12,
                    bytes_per_window=256.0 * MB, jitter=0.2,
                )
            ],
            blackouts=[
                TelemetryBlackoutSpec(start=6, duration=8, drop_prob=0.3)
            ],
        )
    )
    with _adaptive(topo, device) as sess:
        drill = run_drill(sess, trace, sched)
        rejected = sess.runtime.telemetry.rejected
        confidence = sess.runtime.estimator.confidence
    _keep(reports, "perturb", drill)
    comps = drill.completions()
    straggler_ratio = float(
        np.median(comps[8:12]) / max(np.median(comps[:8]), 1e-12)
    )
    return {
        "windows": windows,
        "digest": sched.digest(),
        "straggler_ratio": straggler_ratio,
        "telemetry_rejected": int(rejected),
        "confidence_end": float(confidence),
        "total_completion_s": drill.total_completion_s,
    }


# -- benchmarks/bench_obs.py -------------------------------------------------------

#: the obs section's wall-clock figures (they differ from run to run)
OBS_WALL_KEYS = ("overhead_ratio", "wall_us_per_window_traced",
                 "wall_us_per_window_plain")


def _run_arm(topo, trace, device, recorder=None):
    """(result_json_str, wall_s) for one full drift run."""
    with Session(
        SessionSpec(topology=topo, adaptivity="adaptive", device=device),
        recorder=recorder,
    ) as sess:
        t0 = time.perf_counter()
        res = sess.run_trace(trace)
        wall = time.perf_counter() - t0
    return json.dumps(res.to_json_obj(), sort_keys=True), wall


def obs(windows: int = 48, dwell: int = 12, device: str = "cuda",
        reports: Optional[dict] = None, recorder=None) -> dict:
    """The drift run recorded and unrecorded: identical reports, the trace,
    the provenance, and the recorder's wall-clock cost.  ``recorder`` (a
    ``FlightRecorder``) is the one the kept recorded run uses; a fresh one
    by default."""
    topo = Topology(N, group_size=GROUP)
    trace = drifting_skew_trace(N, windows, dwell=dwell)

    # one traced run kept for artifact validation (its recorder outlives
    # the session — provenance is an audit trail)
    recorder = recorder if recorder is not None else FlightRecorder()
    traced_json, _ = _run_arm(topo, trace, device, recorder=recorder)
    plain_json, _ = _run_arm(topo, trace, device)
    identical = traced_json == plain_json
    if reports is not None:
        reports["obs traced"] = json.loads(traced_json)
        reports["obs plain"] = json.loads(plain_json)

    # alternate the arms so drift in machine load hits both equally
    plain_walls, traced_walls = [], []

    def sample(reps: int) -> float:
        for _ in range(reps):
            _, w_plain = _run_arm(topo, trace, device)
            _, w_traced = _run_arm(topo, trace, device, recorder=FlightRecorder())
            plain_walls.append(w_plain)
            traced_walls.append(w_traced)
        # the smaller of the ratio of per-arm minima and the best
        # back-to-back pair: load bursts cancel inside a pair, while a real
        # instrumentation cost shows in every pair
        ratio_of_mins = min(traced_walls) / min(plain_walls)
        best_pair = min(t / p for t, p in zip(traced_walls, plain_walls))
        return min(ratio_of_mins, best_pair)

    overhead = sample(REPS)
    if overhead > OVERHEAD_LIMIT:
        overhead = sample(ESCALATION_REPS)

    info = validate_trace(recorder.export_trace())
    swaps = len(recorder.provenance.swapped())
    unswapped = sum(
        1 for p in recorder.provenance
        if not p.swapped and not p.abandoned and p.trigger != "initial"
    )
    return {
        "windows": windows,
        "overhead_ratio": float(overhead),
        "identical": bool(identical),
        "trace_events": int(info["events"]),
        "trace_spans": int(info["spans"]),
        "layers": sorted(info["cats"]),
        "plans_issued": len(recorder.provenance),
        "plans_swapped": swaps,
        "plans_pending_or_lost": unswapped,
        "wall_us_per_window_traced": min(traced_walls) * 1e6 / windows,
        "wall_us_per_window_plain": min(plain_walls) * 1e6 / windows,
    }


# -- benchmarks/bench_serve.py -----------------------------------------------------

def _scenario_section(name: str, device: str, reports: Optional[dict]) -> dict:
    """Both arms + SLO verdict for one registry scenario, summarized."""
    spec = get_scenario(name)
    res = evaluate_scenario(spec, device=device)
    adaptive, static, slo = res["adaptive"], res["static"], res["slo"]
    _keep(reports, f"{name} adaptive", adaptive)
    _keep(reports, f"{name} static", static)
    win = slo["gates"]["combined_drain"]["value"]
    return {
        "windows": spec.windows,
        "tenants": len(adaptive.tenants),
        "slo_pass": bool(slo["pass"]),
        "gates": {k: v["value"] for k, v in slo["gates"].items()},
        "adaptive_total_s": adaptive.total_completion_s,
        "static_total_s": static.total_completion_s,
        "win": float(win),
        "jain": float(adaptive.jain_index),
        "availability": float(adaptive.availability),
        "recovery_windows": adaptive.recovery_windows,
        "fault_digest": adaptive.fault_digest,
        "report": adaptive.to_json_obj(),
    }


def steady(device: str = "cuda", reports: Optional[dict] = None) -> dict:
    return _scenario_section("steady", device, reports)


def elephant_victim(device: str = "cuda", reports: Optional[dict] = None) -> dict:
    return _scenario_section("elephant_victim", device, reports)


def flap_under_load(device: str = "cuda", reports: Optional[dict] = None) -> dict:
    return _scenario_section("flap_under_load", device, reports)


def churn(device: str = "cuda", reports: Optional[dict] = None) -> dict:
    """``churn_storm`` vs its never-churned control, same adaptive arm."""
    spec = get_scenario("churn_storm")
    churned = run_scenario(spec, "adaptive", device=device)
    control = run_scenario(spec.without_churn(), "adaptive", device=device)
    _keep(reports, "churn churned", churned)
    _keep(reports, "churn control", control)
    survivor = spec.tenants[0].name
    last_leave = max(
        t.leave_window for t in spec.roster() if t.leave_window is not None
    )
    vc = churned.tenants[survivor].ring.values()
    v0 = control.tenants[survivor].ring.values()
    tail_c = float(np.median(vc[last_leave:]))
    tail_0 = float(np.median(v0[last_leave:]))
    tail_ratio = tail_c / tail_0 if tail_0 > 0 else 1.0
    total_ratio = (
        churned.tenants[survivor].completion_s
        / control.tenants[survivor].completion_s
    )
    churners = [n for n in churned.tenants if n != survivor]
    return {
        "windows": spec.windows,
        "survivor": survivor,
        "churned_tenants": len(churners),
        "last_leave_window": int(last_leave),
        "survivor_tail_s": tail_c,
        "control_tail_s": tail_0,
        "tail_ratio": float(tail_ratio),
        "total_ratio": float(total_ratio),
    }


#: section name -> section function
SECTIONS = {
    "flap": flap,
    "blackout": blackout,
    "tenant_crash": tenant_crash,
    "perturb": perturb,
    "obs": obs,
    "steady": steady,
    "elephant_victim": elephant_victim,
    "flap_under_load": flap_under_load,
    "churn": churn,
}
FAULT_SECTIONS = ("flap", "blackout", "tenant_crash", "perturb")
SERVE_SECTIONS = ("steady", "elephant_victim", "flap_under_load", "churn")


def metrics(device: str = "cuda", reports: Optional[dict] = None,
            sections=tuple(SECTIONS)) -> dict:
    """Every named section's record."""
    return {name: SECTIONS[name](device=device, reports=reports)
            for name in sections}


def describe(name: str, rec: dict) -> str:
    """One line of a section's figures, as the reference's benches print them."""
    if name == "flap":
        return (f"topology replans {rec['topology_replans_backoff']} (no backoff "
                f"{rec['topology_replans_storm']}), suppressed "
                f"{rec['suppressed_windows']}, recovered at w{rec['recovered_window']} "
                f"(restore w{rec['restore_window']}), availability "
                f"{rec['availability']!r}, pre-fault completion "
                f"{rec['prefault_completion_s']!r} s, digest {rec['digest']}")
    if name == "blackout":
        return (f"adaptive/static {rec['adaptive_static_ratio']!r} (adaptive "
                f"{rec['adaptive_completion_s']!r} s), missing "
                f"{rec['missing_windows']}/{rec['blackout_windows']}, confidence "
                f"{rec['confidence_end']!r}, availability {rec['availability']!r}, "
                f"digest {rec['digest']}")
    if name == "tenant_crash":
        return (f"survivor/solo {rec['survivor_solo_ratio']!r}, evictions "
                f"{rec['evictions']}, survivors {rec['survivors']}, double teardown "
                f"{'ok' if rec['double_teardown_ok'] else 'FAILED'}, digest "
                f"{rec['digest']}")
    if name == "perturb":
        return (f"straggler ratio {rec['straggler_ratio']!r}, total "
                f"{rec['total_completion_s']!r} s, rejected "
                f"{rec['telemetry_rejected']}, confidence {rec['confidence_end']!r}, "
                f"digest {rec['digest']}")
    if name == "obs":
        return (f"identical {rec['identical']}, {rec['trace_events']} trace events "
                f"({rec['trace_spans']} spans, layers {rec['layers']}), "
                f"{rec['plans_issued']} plans issued, {rec['plans_swapped']} swapped; "
                f"recorder overhead {rec['overhead_ratio']:.4f}x "
                f"({rec['wall_us_per_window_traced']:.0f} vs "
                f"{rec['wall_us_per_window_plain']:.0f} us a window)")
    if name == "churn":
        return (f"survivor tail {rec['tail_ratio']!r}x the control, whole run "
                f"{rec['total_ratio']!r}x, {rec['churned_tenants']} churners")
    return (f"SLO {'PASS' if rec['slo_pass'] else 'FAIL'}, win {rec['win']!r}, Jain "
            f"{rec['jain']!r}, availability {rec['availability']!r}, recovery "
            f"{rec['recovery_windows']}, adaptive {rec['adaptive_total_s']!r} s, static "
            f"{rec['static_total_s']!r} s"
            + (f", fault digest {rec['fault_digest']}" if rec["fault_digest"] else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sections", nargs="+", default=list(SECTIONS),
                    choices=list(SECTIONS))
    args = ap.parse_args(argv)
    with timed_solves() as solves:
        for name in args.sections:
            t0 = time.perf_counter()
            rec = SECTIONS[name](device=args.device)
            print(f"[drills] {name} ({time.perf_counter() - t0:.2f} s): "
                  f"{describe(name, rec)}", flush=True)
    if args.device != "cpu":
        print(f"[drills] runtime solves on the card (each synchronized): "
              f"{solve_summary(solves)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
