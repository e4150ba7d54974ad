"""Session facade selfcheck — ``python -m repro_torch.api.selfcheck [--device cpu]``.

Counterpart of ``repro/api/selfcheck.py``: a fast verification that the
endpoint API's guarantees hold in this environment, with every runtime
solve on ``--device`` (the card unless ``cpu`` is named):

  1. **static**     — ``Session.plan`` is bit-identical to hand-wired
     ``solve_mwu`` / ``solve_direct`` / ``solve_static_striping``;
  2. **adaptive**   — ``Session.run_trace`` reproduces a hand-wired
     ``OrchestrationRuntime`` window stream exactly;
  3. **arbitrated** — one two-tenant window runs through the facade and
     the exported fairness record validates against the
     ``nimble.fabric_fairness/v1`` schema;
  4. **pressure**   — a demand-stable arbitrated tenant picks up a peer's
     committed-load shift via the prices-moved hint (``reason="fabric"``);
  5. **decay**      — price recency: stamped peer loads fade
     monotonically as the fabric clock runs past them, unstamped (host)
     commits never decay, and ``price_decay=None`` exports the raw ledger
     byte-identically;
  6. **serve**      — the serving control plane runs the registry's
     ``minimal`` two-tenant scenario end-to-end through both arms, the
     scenario survives a JSON round-trip bit-exactly, and the exported
     report validates against the ``nimble.serve/v1`` schema;
  7. **obs**        — the flight recorder: the ``minimal`` scenario rerun
     with tracing attached exports a valid ``nimble.trace/v1`` Chrome trace
     spanning all four layers under one correlation id, every swap has a
     provenance record, and the serve report embeds a
     ``nimble.metrics/v1`` snapshot;
  8. **lint**       — the port's static checker (``repro_torch.analysis``)
     over ``src/repro_torch``: zero live findings with the shipped
     baseline, a strict-parsing ``nimble.lint/v1`` report, and both locks
     (``schemas.lock.json``, the ``host-sync`` inventory's
     ``retrace.lock.json``) fresh.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

MB = float(1 << 20)

#: required fields of a ``nimble.fabric_fairness/v1`` record
FAIRNESS_SCHEMA = "nimble.fabric_fairness/v1"
_FAIRNESS_FIELDS = {
    "tenants": list,
    "drain_s": dict,
    "weights": dict,
    "weighted_drain_s": dict,
    "jain_index": float,
    "maxmin_violation": float,
    "combined_drain_s": float,
}


def validate_fairness_record(rec: dict) -> None:
    """Raise ``ValueError`` unless ``rec`` is a well-formed
    ``nimble.fabric_fairness/v1`` record (schema tag, field types/ranges,
    cross-field tenant consistency)."""
    if not isinstance(rec, dict):
        raise ValueError(f"fairness record is {type(rec).__name__}, not dict")
    if rec.get("schema") != FAIRNESS_SCHEMA:
        raise ValueError(
            f"schema {rec.get('schema')!r} != {FAIRNESS_SCHEMA!r}"
        )
    for field, typ in _FAIRNESS_FIELDS.items():
        if field not in rec:
            raise ValueError(f"missing field {field!r}")
        if not isinstance(rec[field], typ):
            raise ValueError(
                f"field {field!r} is {type(rec[field]).__name__}, "
                f"expected {typ.__name__}"
            )
    tenants = set(rec["tenants"])
    for field in ("drain_s", "weights", "weighted_drain_s"):
        if set(rec[field]) != tenants:
            raise ValueError(
                f"{field!r} keys {sorted(rec[field])} != tenants "
                f"{sorted(tenants)}"
            )
        for t, v in rec[field].items():
            if not isinstance(v, float) or v < 0:
                raise ValueError(f"{field}[{t!r}] = {v!r} not a float >= 0")
    if not 0.0 <= rec["jain_index"] <= 1.0:
        raise ValueError(f"jain_index {rec['jain_index']} outside [0, 1]")
    if not 0.0 <= rec["maxmin_violation"] <= 1.0:
        raise ValueError(
            f"maxmin_violation {rec['maxmin_violation']} outside [0, 1]"
        )
    if rec["combined_drain_s"] < 0:
        raise ValueError("combined_drain_s < 0")


def _skew_demand(n: int = 8, hot: int = 0, hot_frac: float = 0.7,
                 bytes_per_src: float = 64 * MB) -> dict:
    return {
        (s, d): bytes_per_src * (
            hot_frac if d == hot else (1.0 - hot_frac) / (n - 2)
        )
        for s in range(n)
        for d in range(n)
        if s != d
    }


def check_static(device: str = "cuda") -> str:
    """Session.plan vs hand-wired solvers — bit-identical, all modes."""
    from ..core.mcf import solve_direct, solve_mwu, solve_static_striping
    from ..core.topology import Topology
    from . import Session, SessionSpec, TopologySpec

    D = _skew_demand()
    topo = Topology(8, group_size=4)
    refs = {
        "nimble": solve_mwu(topo, D),
        "direct": solve_direct(topo, D),
        "stripe": solve_static_striping(topo, D),
    }
    with Session(SessionSpec(topology=TopologySpec(8, group_size=4),
                             device=device)) as sess:
        for mode, ref in refs.items():
            plan = sess.plan(D, mode=mode)
            if not (
                np.array_equal(plan.resource_bytes, ref.resource_bytes)
                and np.array_equal(plan.link_bytes, ref.link_bytes)
            ):
                raise AssertionError(f"static {mode} plan diverged")
    return "static: 3 modes bit-identical to hand-wired solvers"


def check_adaptive(windows: int = 10, device: str = "cuda") -> str:
    """Session.run_trace vs hand-wired OrchestrationRuntime — identical."""
    from ..core.topology import Topology
    from ..runtime import OrchestrationRuntime, drifting_skew_trace
    from . import Session, SessionSpec

    topo = Topology(8, group_size=4)
    trace = drifting_skew_trace(8, windows, dwell=4)
    ref = OrchestrationRuntime(topo, device=device).run_trace(trace)
    with Session(SessionSpec(topology=topo, adaptivity="adaptive",
                             device=device)) as sess:
        got = sess.run_trace(trace)
    for a, b in zip(ref.reports, got.reports):
        if a != b:
            raise AssertionError(f"adaptive window {a.window} diverged")
    return f"adaptive: {windows} windows report-identical to hand-wired"


def check_arbitrated(device: str = "cuda") -> dict:
    """One arbitrated two-tenant window through the facade; returns the
    validated fairness record (the ``--smoke`` session_api gate)."""
    from ..core.mcf import solve_direct
    from ..core.topology import Topology
    from ..runtime import drifting_skew_trace
    from . import Session, SessionSpec

    topo = Topology(8, group_size=4)
    bg = solve_direct(
        topo, {(0, 4): 128 * MB, (4, 0): 128 * MB, (1, 5): 128 * MB}
    )
    with Session(SessionSpec(
        topology=topo, adaptivity="arbitrated", tenant="smoke", device=device,
    )) as sess:
        sess.join_static_tenant("bg", bg)
        trace = drifting_skew_trace(8, 1, dwell=1)
        sess.step(trace[0])
        rec = sess.report()
    fairness = rec.get("fairness")
    validate_fairness_record(fairness)
    if rec.get("schema") != "nimble.session/v1":
        raise AssertionError(f"session schema {rec.get('schema')!r}")
    return fairness


def check_fabric_pressure(windows: int = 8, device: str = "cuda") -> str:
    """A demand-stable arbitrated tenant replans (reason="fabric") after a
    peer's commit moves the shared prices."""
    from ..core.mcf import solve_direct
    from ..core.topology import Topology
    from ..runtime import PolicyConfig, balanced_trace
    from . import Session, SessionSpec

    topo = Topology(8, group_size=4)
    trace = balanced_trace(8, windows)
    with Session(SessionSpec(
        topology=topo, adaptivity="arbitrated", tenant="stable",
        policy=PolicyConfig(fabric_staleness=2), device=device,
    )) as sess:
        reasons = []
        for w in range(windows):
            if w == 3:
                # a peer elephants onto the fabric mid-trace
                sess.join_static_tenant(
                    "peer",
                    solve_direct(topo, {(0, 4): 512 * MB, (4, 0): 512 * MB}),
                )
            reasons.append(sess.step(trace[w]).replan_reason)
    if "fabric" not in reasons:
        raise AssertionError(
            f"no fabric-pressure replan in {reasons} — prices-moved hint "
            "did not reach the policy"
        )
    return f"pressure: fabric replan at w{reasons.index('fabric')} of {windows}"


def check_price_decay(device: str = "cuda") -> str:
    """Decayed ledger prices: monotone fade for stamped commits, identity
    for unstamped commits and for ``price_decay=None`` (host arithmetic
    only: ``device`` is accepted for a uniform signature)."""
    from ..core.mcf import solve_direct
    from ..core.topology import Topology
    from ..fabric import ArbiterConfig, FabricArbiter

    topo = Topology(8, group_size=4)
    bg = solve_direct(
        topo, {(0, 4): 256 * MB, (4, 0): 256 * MB}
    ).resource_bytes

    arb = FabricArbiter(topo, cfg=ArbiterConfig(price_decay=2.0))
    raw = FabricArbiter(topo)  # price_decay=None: the raw-ledger control
    for a in (arb, raw):
        a.register("fresh")
        a.register("stale")
        a.register("host")
    for a in (arb, raw):
        a.commit("stale", bg, window=0)     # stamped, then never refreshed
        a.commit("host", bg)                # unstamped: timeless
    prices = []
    for w in range(0, 8, 2):
        for a in (arb, raw):
            a.commit("fresh", bg, window=w)  # advances the fabric clock
        decayed = arb.state.external_load("fresh", half_life=2.0)
        stale_part = decayed - bg  # host's undecayed share subtracted
        prices.append(stale_part)
        if not np.allclose(
            raw.state.external_load("fresh"), 2.0 * bg
        ):
            raise AssertionError("price_decay=None no longer raw ledger")
        if arb.state.decay_factor("host", 2.0) != 1.0:
            raise AssertionError("unstamped commit decayed")
    for older, newer in zip(prices, prices[1:]):
        if not (newer <= older + 1e-12).all() or not (newer < older).any():
            raise AssertionError(
                "decayed prices not monotone decreasing in staleness"
            )
    half = arb.state.decay_factor("stale", 2.0)
    expect = 0.5 ** (arb.state.clock / 2.0)
    if abs(half - expect) > 1e-12:
        raise AssertionError(f"decay factor {half} != 0.5^(stale/hl) {expect}")
    return (
        f"decay: stamped peer faded to {half:.3f}x over "
        f"{arb.state.clock} windows (hl=2); unstamped + decay=None exact"
    )


def check_serve(device: str = "cuda") -> str:
    """Minimal two-tenant scenario end-to-end through the control plane:
    registry round-trip is bit-exact, both arms run, the adaptive report
    is a valid ``nimble.serve/v1`` record with every roster tenant served
    for the full horizon."""
    from ..serve import (
        ScenarioSpec,
        get_scenario,
        run_scenario,
        validate_serve_record,
    )

    spec = get_scenario("minimal")
    back = ScenarioSpec.from_json_obj(spec.to_json_obj())
    if back != spec:
        raise AssertionError("minimal scenario JSON round-trip diverged")
    adaptive = run_scenario(spec, "adaptive", device=device)
    static = run_scenario(spec, "static", device=device)
    rec = adaptive.to_json_obj()
    validate_serve_record(rec)
    names = {t.name for t in spec.roster()}
    if set(adaptive.tenants) != names or set(static.tenants) != names:
        raise AssertionError(
            f"control plane served {sorted(adaptive.tenants)}, "
            f"roster {sorted(names)}"
        )
    for name, led in adaptive.tenants.items():
        if led.windows != spec.windows:
            raise AssertionError(
                f"tenant {name!r} served {led.windows}/{spec.windows} windows"
            )
    return (
        f"serve: minimal scenario round-trips; both arms ran "
        f"{spec.windows} windows x {len(names)} tenants, report schema "
        f"{rec['schema']} valid"
    )


def check_obs(device: str = "cuda") -> str:
    """Flight-recorded minimal scenario: valid four-layer Chrome trace
    under one correlation id, provenance for every swap, metrics embedded
    in the serve record."""
    from ..jsonio import schema_kind, schema_version
    from ..obs import FlightRecorder, validate_trace
    from ..serve import get_scenario, run_scenario

    spec = get_scenario("minimal")
    recorder = FlightRecorder()
    report = run_scenario(spec, "adaptive", recorder=recorder, device=device)

    trace = recorder.export_trace()
    info = validate_trace(trace)  # schema, ts order, nesting, one corr id
    missing = {"serve", "runtime", "fabric", "planner"} - set(info["cats"])
    if missing:
        raise AssertionError(f"trace has no spans from layers {sorted(missing)}")
    if info["correlation_id"] != recorder.correlation_id:
        raise AssertionError("trace lost its correlation id")

    # the sessions are already retired — provenance is the audit trail
    swapped = recorder.provenance.swapped()
    if not swapped:
        raise AssertionError("no swap acquired a provenance record")
    for p in swapped:
        if p.swapped_window is None or not p.trigger or p.signature is None:
            raise AssertionError(
                f"swapped plan v{p.version} has an incomplete provenance "
                f"record: {p.to_json_obj()}"
            )

    rec = report.to_json_obj()
    metrics = rec.get("metrics")
    if metrics is None or schema_kind(metrics) != "metrics":
        raise AssertionError("serve record did not embed a metrics snapshot")
    if schema_version(metrics) != 1:
        raise AssertionError(f"metrics schema version {metrics.get('schema')}")
    if not metrics["metrics"]:
        raise AssertionError("metrics snapshot is empty")
    return (
        f"obs: trace {info['events']} events across 4 layers "
        f"(corr={info['correlation_id']}); {len(recorder.provenance)} plans "
        f"issued, {len(swapped)} swaps all provenanced; "
        f"{len(metrics['metrics'])} metrics embedded"
    )


def check_lint(device: str = "cuda") -> str:
    """The static checker over src/repro_torch: zero live findings with the
    shipped baseline, a strict-parsing ``nimble.lint/v1`` report, and both
    locks fresh (host-only: ``device`` is accepted for a uniform
    signature)."""
    import os

    from ..analysis import (
        AnalysisEngine,
        RULES,
        default_baseline_path,
        default_lock_path,
        default_retrace_lock_path,
        load_baseline,
        lock_is_fresh,
        retrace_lock_is_fresh,
    )
    from ..analysis.engine import build_contexts
    from ..analysis.rules import HostSyncRule
    from ..jsonio import parse_schema_id

    src_pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    contexts = build_contexts([src_pkg], rel_to=os.path.dirname(src_pkg))
    engine = AnalysisEngine(RULES, load_baseline(default_baseline_path()))
    report = engine.run(contexts, root=src_pkg)
    if not report.clean:
        head = "; ".join(str(f) for f in report.findings[:3])
        raise AssertionError(
            f"{len(report.findings)} live finding(s) over src/repro_torch "
            f"(first: {head}) — run `python -m repro_torch.analysis`"
        )
    obj = report.to_json_obj()
    if parse_schema_id(obj["schema"]) != ("lint", 1):
        raise AssertionError(f"lint report schema {obj['schema']!r}")
    if not lock_is_fresh(default_lock_path(), contexts):
        raise AssertionError(
            "schemas.lock.json is stale — "
            "`python -m repro_torch.analysis --write-lock` and commit"
        )
    host_sync = next(r for r in engine.rules if isinstance(r, HostSyncRule))
    if not retrace_lock_is_fresh(default_retrace_lock_path(), engine.program,
                                 host_sync.analysis):
        raise AssertionError(
            "retrace.lock.json is stale: the host-sync inventory changed — "
            "`python -m repro_torch.analysis --write-lock` and commit"
        )
    return (
        f"lint: {report.files} files clean "
        f"({len(report.suppressed)} suppressed, "
        f"{len(report.baselined)} baselined); schema lock fresh; "
        f"{len(host_sync.sites)} host-sync sites, lock fresh"
    )


CHECKS = (
    check_static,
    check_adaptive,
    check_arbitrated,
    check_fabric_pressure,
    check_price_decay,
    check_serve,
    check_obs,
    check_lint,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the runtime solves (default: the card)")
    args = ap.parse_args(argv)
    failed = 0
    for check in CHECKS:
        try:
            out = check(device=args.device)
            msg = out if isinstance(out, str) else (
                f"arbitrated: fairness schema valid, "
                f"jain={out['jain_index']:.3f}"
            )
            print(f"[selfcheck] OK   {msg}")
        except Exception as e:  # noqa: BLE001 — selfcheck reports, not raises
            failed += 1
            print(f"[selfcheck] FAIL {check.__name__}: {e}")
    print(
        f"[selfcheck] {len(CHECKS) - failed}/{len(CHECKS)} checks passed "
        f"on {args.device}"
    )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
