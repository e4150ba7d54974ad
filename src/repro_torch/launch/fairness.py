"""Fabric-arbiter fairness scenarios through the port's ``Session``.

    python -m repro_torch.launch.fairness [--device cpu] [--sections NAME ...]

The five sections of the reference's ``benchmarks/bench_fairness.py`` on a
2-group/8-device fabric (DESIGN.md §4), every arbitrated stack wired
through :class:`repro_torch.api.Session` and every runtime replan solved on
``device`` (the card unless ``cpu`` is named):

  * **host_coplan** — a skewed All-to-Allv tenant sharing the fabric with a
    pinned (direct-routed) elephant background: independent planning
    stacks the skew tenant onto the elephant rails, arbitrated planning
    prices the committed background into the solve;
  * **weights_sweep** — the same contention with the skew tenant's weight
    swept (prices scale by ``1/weight``);
  * **runtime_adaptive** — an arbitrated runtime tenant replanning a
    drifting-skew trace against the committed background, against an
    oblivious adaptive one;
  * **four_tenant** — two skewed MWU tenants plus two pinned elephants,
    co-planned to the priced equilibrium by ``FabricArbiter.arbitrate``;
  * **mutual_drift** — two runtime tenants whose hotspots rotate out of
    phase, in three arms: unpriced (adaptive), legacy (raw ledger prices,
    no hints, no re-pricing) and calibrated (the arbitrated-session
    defaults).

Each section returns the reference's dict, figure for figure; with
``reports=`` (a dict) it also stores every session's ``report()`` before
closing it.  The command prints each section's figures and, on the card,
the count and median time of the priced solves (``ext_loads`` set) and of
the unpriced ones, each call synchronized.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import Session, SessionSpec
from ..core.cost import CostModel
from ..core.mcf import solve_direct, solve_mwu
from ..core.topology import Topology
from ..fabric import ArbiterConfig, jains_index
from ..runtime import controller, drifting_skew_trace

MB = float(1 << 20)
N = 8
GROUP = 4


def _skew_demand(bytes_per_src: float = 64 * MB, hot: int = 0,
                 hot_frac: float = 0.7) -> dict:
    """Skewed All-to-Allv: ``hot_frac`` of every source's bytes to ``hot``."""
    D = {}
    for s in range(N):
        for d in range(N):
            if s != d:
                D[(s, d)] = bytes_per_src * (
                    hot_frac if d == hot else (1.0 - hot_frac) / (N - 2)
                )
    return D


def _elephant_demand(mb: float, rails=(0, 1)) -> dict:
    """Bidirectional elephants pinned rail-matched across the groups."""
    D = {}
    for r in rails:
        D[(r, r + GROUP)] = mb * MB
        D[(r + GROUP, r)] = mb * MB
    return D


def _stacked_drain(rm, *loads) -> float:
    total = np.zeros_like(rm.capacity)
    for l in loads:
        total = total + l
    return float(np.max(total / rm.capacity))


def _keep(reports: Optional[dict], label: str, sess: Session) -> None:
    if reports is not None:
        reports[label] = sess.report()


def host_coplan(bg_mb: float = 128.0, device: str = "cuda",
                reports: Optional[dict] = None) -> dict:
    """Arbitrated co-planning against independent planning, host solves."""
    cm = CostModel()
    topo = Topology(N, group_size=GROUP)
    D = _skew_demand()
    bg = solve_direct(topo, _elephant_demand(bg_mb), cm)

    # independent: the skew tenant plans as if the fabric were empty
    ind = solve_mwu(topo, D, cm)
    ind_combined = _stacked_drain(ind.rm, ind.resource_bytes, bg.resource_bytes)

    spec = SessionSpec(topology=topo, cost=cm, adaptivity="arbitrated",
                       tenant="skew", device=device)
    with Session(spec) as sess:
        sess.join_static_tenant("bg", bg)
        sess.plan(D)  # priced solve; commits the tenant's load
        arb_combined = sess.fabric.combined_drain_s()
        fairness = sess.fabric.fairness_report()
        _keep(reports, "host_coplan", sess)
    return {
        "bg_mb": bg_mb,
        "independent_combined_drain_s": ind_combined,
        "arbitrated_combined_drain_s": arb_combined,
        "win": ind_combined / arb_combined,
        "jain_index": fairness["jain_index"],
        "maxmin_violation": fairness["maxmin_violation"],
        "drain_s": fairness["drain_s"],
    }


def weights_sweep(bg_mb: float = 128.0, weights=(0.5, 1.0, 2.0, 4.0),
                  device: str = "cuda", reports: Optional[dict] = None) -> dict:
    """Sweep the skew tenant's weight against a fixed elephant background."""
    cm = CostModel()
    topo = Topology(N, group_size=GROUP)
    D = _skew_demand()
    bg = solve_direct(topo, _elephant_demand(bg_mb), cm)

    points = []
    for w in weights:
        spec = SessionSpec(topology=topo, cost=cm, adaptivity="arbitrated",
                           tenant="skew", weight=w, device=device)
        with Session(spec) as sess:
            sess.join_static_tenant("bg", bg)
            sess.plan(D)
            fairness = sess.fabric.fairness_report()
            _keep(reports, f"weights_sweep w={w:g}", sess)
        points.append(
            {
                "weight": w,
                "skew_drain_s": fairness["drain_s"]["skew"],
                "combined_drain_s": fairness["combined_drain_s"],
                "jain_index": fairness["jain_index"],
            }
        )
    return {"bg_mb": bg_mb, "points": points}


def runtime_adaptive(bg_mb: float = 192.0, windows: int = 32,
                     device: str = "cuda", reports: Optional[dict] = None) -> dict:
    """Execution-time view: an arbitrated runtime vs an oblivious one."""
    topo = Topology(N, group_size=GROUP)
    trace = drifting_skew_trace(N, windows, dwell=8)
    bg = solve_direct(topo, _elephant_demand(bg_mb))
    bg_time = bg.resource_bytes / bg.rm.capacity

    def replay(arbitrated: bool):
        spec = SessionSpec(
            topology=topo,
            adaptivity="arbitrated" if arbitrated else "adaptive",
            tenant="skew",
            device=device,
        )
        with Session(spec) as sess:
            if arbitrated:
                sess.join_static_tenant("bg", bg)
            combined = own = 0.0
            reps = []
            for w in range(windows):
                reps.append(sess.step(trace[w]))
                t = sess.runtime.telemetry.latest(1)[0].per_resource_time
                combined += float(np.max(t + bg_time))
                own += float(t.max())
            replans = sess.runtime.stats.replans
            throttled = sess.fabric.stats.throttled if arbitrated else 0
            _keep(reports, "runtime_adaptive "
                  + ("arbitrated" if arbitrated else "independent"), sess)
        return combined, own, replans, throttled, reps

    ind_combined, _, _, _, _ = replay(False)
    arb_combined, arb_own, replans, throttled, reps = replay(True)
    bg_total = float(bg_time.max()) * windows
    # gated vs no-trigger accounting (WindowReport.trigger_reason): a
    # "gated" window fired a real trigger that the fabric gate suppressed
    return {
        "windows": windows,
        "bg_mb": bg_mb,
        "independent_combined_drain_s": ind_combined,
        "arbitrated_combined_drain_s": arb_combined,
        "win": ind_combined / arb_combined,
        "replans": replans,
        "throttled": throttled,
        "gated_windows": [r.window for r in reps if r.replan_reason == "gated"],
        "gated_triggers": dict(collections.Counter(
            r.trigger_reason for r in reps if r.replan_reason == "gated"
        )),
        "jain_index": jains_index([arb_own, bg_total]),
        "drain_s": {"skew": arb_own, "bg": bg_total},
    }


MUTUAL_DRIFT_ARMS = ("unpriced", "legacy", "calibrated")


def mutual_drift_arm(mode: str, windows: int = 48, dwell: int = 8,
                     device: str = "cuda", reports: Optional[dict] = None) -> dict:
    """One arm of :func:`mutual_drift`: two runtime tenants a and b whose
    hotspot rotations land, out of phase, on rails the other just left."""
    topo = Topology(N, group_size=GROUP)
    traces = {
        "a": drifting_skew_trace(
            N, windows, bytes_per_src=128 * MB, dwell=dwell,
            hot_seq=(0, 4, 1, 5), seed=1,
        ),
        "b": drifting_skew_trace(
            N, windows, bytes_per_src=128 * MB, dwell=dwell,
            hot_seq=(4, 1, 5, 0), seed=2,
        ),
    }
    knobs = {"device": device}
    if mode == "unpriced":
        knobs["adaptivity"] = "adaptive"
    else:
        knobs["adaptivity"] = "arbitrated"
        if mode == "legacy":
            # raw ledger prices, no hints, no swap-boundary re-pricing, no
            # soft deadline
            knobs.update(price_decay=None, fabric_staleness=None)
    arb_cfg = ArbiterConfig(price_hint_rel=0.0) if mode == "legacy" else None
    sess_a = Session(SessionSpec(topology=topo, tenant="a", arbiter=arb_cfg, **knobs))
    join = {"fabric": sess_a.fabric} if mode != "unpriced" else {}
    sess_b = Session(SessionSpec(topology=topo, tenant="b",
                                 **{**knobs, **join, "arbiter": None}))
    combined = 0.0
    own = {"a": 0.0, "b": 0.0}
    with sess_a, sess_b:
        for w in range(windows):
            times = {}
            for name, sess in (("a", sess_a), ("b", sess_b)):
                sess.step(traces[name][w])
                times[name] = sess.runtime.telemetry.latest(1)[0].per_resource_time
                own[name] += float(times[name].max())
            combined += float(np.max(times["a"] + times["b"]))
        _keep(reports, f"mutual_drift {mode} a", sess_a)
        _keep(reports, f"mutual_drift {mode} b", sess_b)
        return {
            "combined_drain_s": combined,
            "drain_s": dict(own),
            "jain_index": jains_index(own.values()),
            "replans": {
                "a": sess_a.runtime.stats.replans,
                "b": sess_b.runtime.stats.replans,
            },
            "reprices": 0 if mode == "unpriced" else sess_a.fabric.stats.reprices,
            "price_hints": (
                0 if mode == "unpriced" else sess_a.fabric.stats.price_hints
            ),
        }


def mutual_drift_summary(arms: Dict[str, dict], windows: int = 48,
                         dwell: int = 8) -> dict:
    """The section's record from its three arms."""
    base = arms["unpriced"]["combined_drain_s"]
    return {
        "windows": windows,
        "dwell": dwell,
        "arms": arms,
        "win_legacy": base / arms["legacy"]["combined_drain_s"],
        "win": base / arms["calibrated"]["combined_drain_s"],
    }


def mutual_drift(windows: int = 48, dwell: int = 8, device: str = "cuda",
                 reports: Optional[dict] = None) -> dict:
    """Two mutually drifting runtime tenants: legacy prices lose, recency
    wins.  Combined drain for the unpriced baseline, the raw-ledger
    ("legacy") arbiter, and the calibrated recency defaults."""
    arms = {m: mutual_drift_arm(m, windows, dwell, device, reports)
            for m in MUTUAL_DRIFT_ARMS}
    return mutual_drift_summary(arms, windows, dwell)


def four_tenant(bg_mb: float = 96.0, device: str = "cuda",
                reports: Optional[dict] = None) -> dict:
    """2 arbitrated skew tenants + 2 pinned elephants on disjoint rails."""
    cm = CostModel()
    topo = Topology(N, group_size=GROUP)
    demands = {
        "skew0": _skew_demand(48 * MB, hot=0),
        "skew4": _skew_demand(48 * MB, hot=4),
    }
    pinned = {
        "ele01": solve_direct(topo, _elephant_demand(bg_mb, rails=(0, 1)), cm),
        "ele23": solve_direct(topo, _elephant_demand(bg_mb, rails=(2, 3)), cm),
    }

    # independent: every tenant oblivious of every other
    ind_loads = [solve_mwu(topo, D, cm).resource_bytes for D in demands.values()]
    ind_loads += [p.resource_bytes for p in pinned.values()]
    ind_combined = _stacked_drain(pinned["ele01"].rm, *ind_loads)

    # one session owns the fabric; the second MWU tenant and the pinned
    # elephants join it as plain ledger tenants, then co-plan to the
    # priced equilibrium via the fabric's arbitrate()
    spec = SessionSpec(topology=topo, cost=cm, adaptivity="arbitrated",
                       tenant="skew0", device=device)
    with Session(spec) as sess:
        arb = sess.fabric
        arb.register("skew4")
        for name, plan in pinned.items():
            sess.join_static_tenant(name, plan)
        arb.arbitrate(demands)
        arb_combined = arb.combined_drain_s()
        fairness = arb.fairness_report()
        solves = arb.stats.solves
        _keep(reports, "four_tenant", sess)
    return {
        "independent_combined_drain_s": ind_combined,
        "arbitrated_combined_drain_s": arb_combined,
        "win": ind_combined / arb_combined,
        "jain_index": fairness["jain_index"],
        "drain_s": fairness["drain_s"],
        "solves": solves,
    }


SECTIONS = {
    "host_coplan": host_coplan,
    "weights_sweep": weights_sweep,
    "runtime_adaptive": runtime_adaptive,
    "four_tenant": four_tenant,
    "mutual_drift": mutual_drift,
}


def metrics(device: str = "cuda", reports: Optional[dict] = None,
            sections=tuple(SECTIONS)) -> dict:
    """Every named section's record (the reference's ``metrics()``)."""
    return {name: SECTIONS[name](device=device, reports=reports) for name in sections}


@contextlib.contextmanager
def timed_solves():
    """Time each runtime solve on the card while active.

    Yields a list that collects ``(priced, ms)`` per ``plan_flows_batch``
    call of the runtime on a CUDA tensor, synchronized before and after;
    CPU solves pass through untimed.
    """
    plan = controller.plan_flows_batch
    out: List[tuple] = []

    def timed(d, tables, cfg, **kw):
        if d.device.type != "cuda":
            return plan(d, tables, cfg, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan(d, tables, cfg, **kw)
        torch.cuda.synchronize()
        out.append((kw.get("ext_loads") is not None, (time.perf_counter() - t0) * 1e3))
        return res

    controller.plan_flows_batch = timed
    try:
        yield out
    finally:
        controller.plan_flows_batch = plan


def solve_summary(solves) -> str:
    """``priced N, median m ms; unpriced N, median m ms``."""
    parts = []
    for label, priced in (("priced", True), ("unpriced", False)):
        ms = [t for p, t in solves if p == priced]
        med = f", median {statistics.median(ms):.3f} ms" if ms else ""
        parts.append(f"{label} {len(ms)}{med}")
    return "; ".join(parts)


def describe(name: str, rec: dict) -> str:
    """One line of a section's figures, as the reference's bench prints them."""
    if name == "weights_sweep":
        return " ".join(
            f"w={p['weight']:g}: own {p['skew_drain_s'] * 1e3:.4f} ms / combined "
            f"{p['combined_drain_s'] * 1e3:.4f} ms, jain {p['jain_index']:.7f}"
            for p in rec["points"])
    if name == "mutual_drift":
        arms = rec["arms"]
        return (f"win {rec['win']:.7f}, legacy {rec['win_legacy']:.7f}; " + "; ".join(
            f"{m}: combined {a['combined_drain_s'] * 1e3:.4f} ms, jain "
            f"{a['jain_index']:.7f}, replans {a['replans']}, reprices {a['reprices']}, "
            f"price hints {a['price_hints']}" for m, a in arms.items()))
    extra = ""
    if name == "runtime_adaptive":
        extra = (f", replans {rec['replans']}, throttled {rec['throttled']}, gated "
                 f"windows {rec['gated_windows']}")
    if name == "four_tenant":
        extra = f", solves {rec['solves']}"
    return (f"independent {rec['independent_combined_drain_s'] * 1e3:.4f} ms, "
            f"arbitrated {rec['arbitrated_combined_drain_s'] * 1e3:.4f} ms, win "
            f"{rec['win']:.7f}, jain {rec['jain_index']:.7f}{extra}")


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
            print(f"[fairness] {name} ({time.perf_counter() - t0:.2f} s): "
                  f"{describe(name, rec)}", flush=True)
    if args.device != "cpu":
        print(f"[fairness] runtime solves on the card (each synchronized): "
              f"{solve_summary(solves)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
