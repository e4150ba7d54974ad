"""Port flight recorder against the JAX package's: the same observations.

Every case of the reference's ``tests/test_obs.py`` is written once as a
scenario over a package namespace and run on both packages (the port's
runtimes solve on the CPU, ``device="cpu"``).  A scenario returns what it
observed — the exported trace event for event, validator verdicts, the
provenance log, metrics snapshots, window reports, serve reports — and the
two packages' observations must be equal.  Recorders get explicit
correlation ids: the default id counts the recorders a process has built.
The reference's own assertions run inside each scenario, on both packages.
"""

import copy
import json
import types

import numpy as np
import pytest

import repro.fabric as jfab
import repro.obs as jobs
import repro.runtime as jrt
import repro.serve as jserve
from repro.api import Session as JSession, SessionSpec as JSessionSpec
from repro.core.topology import Topology as JTopology
from repro.jsonio import read_json_file as jread, schema_kind as jkind
from repro.jsonio import schema_version as jversion, write_json_file as jwrite
from repro_torch import fabric as tfab
from repro_torch import obs as tobs
from repro_torch import runtime as trt
from repro_torch import serve as tserve
from repro_torch.api import Session as TSession, SessionSpec as TSessionSpec
from repro_torch.core.topology import Topology as TTopology
from repro_torch.jsonio import read_json_file as tread, schema_kind as tkind
from repro_torch.jsonio import schema_version as tversion, write_json_file as twrite

from test_torch_fabric import norm, raised

pytestmark = pytest.mark.torch_port

N = 8
GROUP = 4

JAX = types.SimpleNamespace(
    obs=jobs, rt=jrt, serve=jserve, fab=jfab, Topology=JTopology, Session=JSession,
    Spec=JSessionSpec, Runtime=jrt.OrchestrationRuntime, kind=jkind,
    version=jversion, read=jread, write=jwrite,
    run_scenario=jserve.run_scenario)
PORT = types.SimpleNamespace(
    obs=tobs, rt=trt, serve=tserve, fab=tfab, Topology=TTopology, Session=TSession,
    Spec=lambda **kw: TSessionSpec(device="cpu", **kw),
    Runtime=lambda topo, **kw: trt.OrchestrationRuntime(topo, device="cpu", **kw),
    kind=tkind, version=tversion, read=tread, write=twrite,
    run_scenario=lambda *a, **kw: tserve.run_scenario(*a, device="cpu", **kw))


def _pair(scenario):
    got, want = norm(scenario(PORT)), norm(scenario(JAX))
    assert got == want
    return got


def _topo(P):
    return P.Topology(N, group_size=GROUP)


def _run_drift(P, recorder=None, windows=24):
    rt = P.Runtime(_topo(P), recorder=recorder)
    res = rt.run_trace(P.rt.drifting_skew_trace(N, windows, dwell=8))
    return rt, res


def recorded(rec):
    """Everything a recorder holds: trace, provenance, metrics."""
    return [rec.export_trace(), rec.provenance.to_json_obj(), rec.metrics_snapshot(),
            len(rec.tracer), len(rec.metrics), len(rec.provenance), rec.enabled]


# -- trace validity ----------------------------------------------------------------

def drift_trace_is_valid(P):
    rec = P.obs.FlightRecorder("t-corr")
    _, res = _run_drift(P, rec)
    info = P.obs.validate_trace(rec.export_trace())
    assert info["events"] > 0 and info["correlation_id"] == "t-corr"
    assert {"runtime", "planner"} <= set(info["cats"])
    return [info, res.to_json_obj(), recorded(rec)]


def timestamps_sorted_and_x_spans_have_durations(P):
    rec = P.obs.FlightRecorder("ts")
    _run_drift(P, rec)
    events = rec.export_trace()["traceEvents"]
    ts = [e["ts"] for e in events if e["ph"] != "M"]
    assert ts == sorted(ts)
    assert all(e["dur"] >= 0 for e in events if e["ph"] == "X")
    return events


def every_event_carries_the_correlation_id(P):
    rec = P.obs.FlightRecorder("corr-7")
    _run_drift(P, rec)
    events = rec.export_trace()["traceEvents"]
    assert all(e["args"]["corr"] == "corr-7" for e in events if e["ph"] != "M")
    return events


def window_spans_align_to_window_clock(P):
    rec = P.obs.FlightRecorder("w")
    _run_drift(P, rec, windows=6)
    windows = [e for e in rec.export_trace()["traceEvents"]
               if e["ph"] == "X" and e["name"] == "window"]
    assert len(windows) == 6
    assert all(e["ts"] >= e["args"]["window"] * 1000 for e in windows)
    return windows


def export_is_tagged_and_json_native(P):
    rec = P.obs.FlightRecorder("j")
    _run_drift(P, rec, windows=4)
    trace = rec.export_trace()
    assert P.kind(trace) == "trace" and P.version(trace) == 1
    return json.dumps(trace)


# -- trace validator ---------------------------------------------------------------

def _minimal(P):
    tr = P.obs.Tracer("v")
    with tr.span("solve", "planner", "t0", {"window": 0}):
        pass
    tr.instant("swap", "runtime", "t0", {"window": 1})
    return tr.export()


def validator_verdicts(P):
    """The validator's summary of a minimal trace and its verdict on each
    class of malformed trace."""
    out = [_minimal(P), P.obs.validate_trace(_minimal(P))]

    def broken(fix):
        bad = copy.deepcopy(_minimal(P))
        fix(bad)
        return raised(lambda: P.obs.validate_trace(bad))

    def schema(bad):
        bad["schema"] = "nimble.metrics/v1"

    def unsorted(bad):
        [e for e in bad["traceEvents"] if e["ph"] != "M"][0]["ts"] = 10**9

    def unmatched(bad):
        bad["traceEvents"].append({"name": "window", "cat": "runtime", "ph": "B",
                                   "ts": 10**6, "pid": 1, "tid": 2,
                                   "args": {"corr": "v"}})

    def mixed(bad):
        next(e for e in bad["traceEvents"] if e["ph"] != "M")["args"]["corr"] = "other"

    def negative(bad):
        for e in bad["traceEvents"]:
            if e["ph"] == "X":
                e["dur"] = -5

    def empty(bad):
        bad["traceEvents"] = []

    def no_corr(bad):
        next(e for e in bad["traceEvents"] if e["ph"] != "M")["args"].pop("corr")

    def bad_phase(bad):
        next(e for e in bad["traceEvents"] if e["ph"] != "M")["ph"] = "Q"

    def overlap(bad):
        xs = [e for e in bad["traceEvents"] if e["ph"] == "X"]
        bad["traceEvents"].append(dict(xs[0], ts=xs[0]["ts"], dur=xs[0]["dur"] + 5))

    errs = {f.__name__: broken(f) for f in (schema, unsorted, unmatched, mixed,
                                            negative, empty, no_corr, bad_phase,
                                            overlap)}
    assert "trace" in str(errs["schema"]) and "sorted" in str(errs["unsorted"])
    assert "nmatched" in str(errs["unmatched"])
    assert "correlation" in str(errs["mixed"]) and "dur" in str(errs["negative"])
    return out + [errs]


def open_begin_is_never_exported(P):
    tr = P.obs.Tracer("v")
    tr.begin("window", "runtime", "t0", {})
    tr.instant("swap", "runtime", "t0", {})
    info = P.obs.validate_trace(tr.export())
    assert info["spans"] == 0 and info["events"] == 1
    return [info, tr.export()]


def tracer_clock_and_capacity(P):
    """The causal clock (ticks, ``advance_to`` never backwards, a span's
    minimum duration), ``end`` idempotent, and the capacity's drop count."""
    tr = P.obs.Tracer("c", capacity=3)
    s = tr.begin("a", "x", "t")
    tr.advance_to(50)
    tr.advance_to(10)
    tr.end(s, {"k": 1})
    tr.end(s)
    for i in range(4):
        tr.instant(f"i{i}", "x", "u", {"i": i})
    return [tr.export(), tr.dropped, len(tr)]


# -- correlation propagation -------------------------------------------------------

def session_runtime_arbiter_share_one_id(P):
    rec = P.obs.FlightRecorder("one-id")
    with P.Session(P.Spec(topology=_topo(P), adaptivity="arbitrated", tenant="t0"),
                   recorder=rec) as sess:
        assert sess.recorder is rec
        trace = P.rt.drifting_skew_trace(N, 8, dwell=4)
        reports = [sess.step(trace[w]) for w in range(8)]
        report = sess.report()
    info = P.obs.validate_trace(rec.export_trace())
    assert info["correlation_id"] == "one-id"
    assert {"runtime", "planner", "fabric"} <= set(info["cats"])
    report.pop("topology")
    return [info, reports, report, recorded(rec)]


def serve_scenario_covers_all_four_layers(P):
    rec = P.obs.FlightRecorder("serve")
    rep = P.run_scenario(P.serve.get_scenario("minimal"), "adaptive", recorder=rec)
    info = P.obs.validate_trace(rec.export_trace())
    assert {"serve", "runtime", "fabric", "planner"} <= set(info["cats"])
    return [info, rep.to_json_obj(), recorded(rec)]


def spans_nest_within_the_window_span(P):
    rec = P.obs.FlightRecorder("nest")
    _run_drift(P, rec)
    events = rec.export_trace()["traceEvents"]
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e["ph"] == "X" and e["name"] == "window"]
    solves = [e for e in events if e["ph"] == "X" and e["name"] == "solve"]
    for s in solves[1:]:
        assert any(lo <= s["ts"] and s["ts"] + s["dur"] <= hi for lo, hi in windows)
    return [windows, solves]


def disabled_recorder_records_nothing(P):
    rec = P.obs.FlightRecorder.disabled()
    rt, res = _run_drift(P, rec)
    assert rt._obs is None and len(rec.tracer) == 0 and len(rec.provenance) == 0
    with P.Session(P.Spec(topology=_topo(P), adaptivity="arbitrated"),
                   recorder=rec) as sess:
        assert sess.recorder is None and sess.fabric._obs is None
    return [res.to_json_obj(), recorded(rec), rec.correlation_id]


def arbiter_hooks(P):
    """The arbiter's instants and span: ``arbitrate``, ``admit``,
    ``broadcast`` faults, ``commit``, ``evict``; detach stops them."""
    rec = P.obs.FlightRecorder("fab")
    topo = _topo(P)
    arb = P.fab.FabricArbiter(topo, cfg=P.fab.ArbiterConfig(evict_staleness=2.0))
    arb.attach_recorder(rec)
    arb.register("a")
    arb.register("b")
    arb.arbitrate({"a": {(0, GROUP): 64.0 * 2**20}, "b": {(1, GROUP + 1): 32.0 * 2**20}})
    arb.admit("a", window=0, reason="congestion")
    arb.broadcast(P.rt.link_down(3, 0, GROUP))
    loads = np.ones(arb.state.n_resources)
    for w in range(4):
        arb.commit("a", loads, window=w)
    arb.reprice("a", None)
    arb.attach_recorder(None)
    arb.commit("a", loads, window=5)
    return [recorded(rec), arb.stats]


# -- metrics -----------------------------------------------------------------------

def snapshot_round_trips_through_jsonio(P, tmp_path):
    rt, _ = _run_drift(P)
    reg = P.obs.MetricsRegistry()
    P.obs.collect_runtime(reg, rt, tenant="t0")
    snap = reg.snapshot()
    assert P.kind(snap) == "metrics"
    path = str(tmp_path / f"metrics-{id(P)}.json")
    P.write(path, snap)
    back = P.read(path)
    assert back == snap
    with open(path, "rb") as fh:
        raw = fh.read()
    return [snap, raw]


def snapshot_is_deterministic(P):
    rt, _ = _run_drift(P)
    reg1, reg2 = P.obs.MetricsRegistry(), P.obs.MetricsRegistry()
    P.obs.collect_runtime(reg1, rt, tenant="t0")
    P.obs.collect_runtime(reg2, rt, tenant="t0")
    assert reg1.snapshot() == reg2.snapshot()
    return reg1.snapshot()


def absorbs_scattered_stats(P):
    rt, _ = _run_drift(P)
    reg = P.obs.MetricsRegistry()
    P.obs.collect_runtime(reg, rt, tenant="t0")
    by_name = {m["name"]: m for m in reg.snapshot()["metrics"]}
    assert by_name["nimble_runtime_replans_total"]["value"] == float(rt.stats.replans)
    assert by_name["nimble_runtime_reprices_total"]["value"] == float(rt.stats.reprices)
    assert by_name["nimble_estimator_confidence"]["value"] == float(rt.estimator.confidence)
    assert by_name["nimble_telemetry_rejected_records_total"]["value"] == float(
        rt.telemetry.rejected)
    assert by_name["nimble_runtime_replans_total"]["labels"] == {"tenant": "t0"}
    return by_name


def counter_rejects_negative_and_kind_conflicts(P):
    reg = P.obs.MetricsRegistry()
    c = reg.counter("nimble_x_total")
    return [raised(lambda: c.inc(-1)), raised(lambda: reg.gauge("nimble_x_total")),
            raised(lambda: reg.counter("Bad-Name")), reg.snapshot()]


def histogram_buckets_and_stats(P):
    reg = P.obs.MetricsRegistry()
    h = reg.histogram("nimble_lat_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    (rec,) = reg.snapshot()["metrics"]
    assert rec["count"] == 3 and rec["min"] == 0.05 and rec["max"] == 5.0
    assert rec["buckets"] == [[0.1, 1], [1.0, 1], ["+inf", 1]]
    return rec


def session_report_embeds_metrics(P):
    with P.Session(P.Spec(topology=_topo(P), adaptivity="adaptive")) as sess:
        trace = P.rt.balanced_trace(N, 3)
        for w in range(3):
            sess.step(trace[w])
        rep = sess.report()
    assert P.kind(rep["metrics"]) == "metrics"
    assert "nimble_estimator_confidence" in {m["name"] for m in rep["metrics"]["metrics"]}
    return rep["metrics"]


def window_report_carries_confidence_and_rejections(P):
    _, res = _run_drift(P)
    last = res.reports[-1]
    assert last.confidence == 1.0 and last.telemetry_rejected == 0
    return last


# -- provenance --------------------------------------------------------------------

def every_swap_has_a_record(P):
    rec = P.obs.FlightRecorder("swaps")
    rt, _ = _run_drift(P, rec)
    swapped = rec.provenance.swapped()
    assert len(swapped) == rt.stats.swaps
    for p in swapped:
        assert p.swapped_window is not None and p.signature
        assert p.trigger in ("initial", "congestion", "topology", "staleness",
                             "fabric", "watchdog", "reprice")
        assert p.source in ("solve", "cache")
    return [rec.provenance.to_json_obj(), [p.to_json_obj() for p in swapped]]


def initial_plan_is_recorded_but_not_swapped(P):
    rec = P.obs.FlightRecorder("init")
    P.Runtime(_topo(P), recorder=rec)
    (first,) = rec.provenance.records()
    assert first.trigger == "initial" and not first.swapped
    return first.to_json_obj()


def cache_hit_flag(P):
    rec = P.obs.FlightRecorder("cache")
    rt, _ = _run_drift(P, rec, windows=36)
    if rt.stats.cache_hits:
        assert any(p.cache_hit for p in rec.provenance)
    assert any(not p.cache_hit for p in rec.provenance)
    return [rt.stats, [p.cache_hit for p in rec.provenance]]


def topology_trigger_carries_fault_context(P):
    rec = P.obs.FlightRecorder("topo")
    rt = P.Runtime(_topo(P), recorder=rec)
    res = rt.run_trace(P.rt.balanced_trace(N, 12),
                       events=P.rt.EventLog([P.rt.link_down(4, 0, GROUP)]))
    topo_plans = [p for p in rec.provenance if p.trigger == "topology"]
    assert topo_plans
    assert any("link_down" in ctx for p in topo_plans for ctx in p.fault_context)
    return [res.to_json_obj(), recorded(rec)]


def attach_recorder_backfills_the_active_plan(P):
    """``attach_recorder`` on a built runtime records its active plan as the
    initial one; a later ``None`` detaches."""
    rt = P.Runtime(_topo(P))
    trace = P.rt.drifting_skew_trace(N, 16, dwell=4)
    for w in range(6):
        rt.step(trace[w])
    rec = P.obs.FlightRecorder("late")
    rt.attach_recorder(rec, tenant="late")
    for w in range(6, 12):
        rt.step(trace[w])
    rt.attach_recorder(None)
    reports = [rt.step(trace[w]) for w in range(12, 16)]
    return [recorded(rec), reports, rt._obs_label]


def lifecycle_marks(P):
    log = P.obs.ProvenanceLog()
    p = log.issue(tenant="t", version=3, source="solve", trigger="congestion",
                  cache_hit=False, issued_window=5, signature="abc123",
                  demand_bytes=1e9, baseline_ratio=1.2, planner={"engine": "mwu"})
    assert not p.swapped
    p.mark_ready(6)
    p.mark_swapped(7, prices=np.array([0.0, 1.0]), rel_change=0.25, repriced=True)
    assert p.swapped and p.ready_window == 6 and p.swapped_window == 7
    assert p.repriced and p.reprice_rel_change == 0.25
    assert p.prices_at_swap["max"] == 1.0
    obj = p.to_json_obj()
    assert P.kind(obj) == "plan_provenance"
    return [obj, json.dumps(obj), P.obs.price_summary(None),
            P.obs.price_summary(np.zeros(0)), P.obs.price_summary([3.0, 0.0, 1.5])]


def queryable_after_run(P):
    rec = P.obs.FlightRecorder("q")
    _run_drift(P, rec)
    log = rec.provenance
    assert log.for_tenant("runtime")
    v = log.for_tenant("runtime")[0].version
    assert log.find(version=v)
    assert P.kind(log.to_json_obj()) == "provenance_log"
    return [[r.to_json_obj() for r in log.find(tenant="runtime", version=v)],
            len(log.find()), len(list(iter(log))), repr(rec)]


def watchdog_abandonment(P):
    log = P.obs.ProvenanceLog()
    p = log.issue(tenant="t", version=1, source="solve", trigger="congestion",
                  cache_hit=False, issued_window=0, signature="s",
                  demand_bytes=1.0, baseline_ratio=1.0, planner={})
    p.mark_abandoned()
    assert p.abandoned is True and not p.swapped
    # and on a runtime whose pending plan goes stale in flight
    rec = P.obs.FlightRecorder("wd")
    rt = P.Runtime(_topo(P), recorder=rec,
                   cfg=P.rt.RuntimeConfig(solve_delay_windows=12,
                                          pending_deadline_windows=4),
                   events=P.rt.EventLog([P.rt.link_down(2, 0, GROUP)]))
    reports = [rt.step(d) for d in P.rt.balanced_trace(N, 24)]
    assert any(r.abandoned for r in rec.provenance)
    return [p.to_json_obj(), reports, recorded(rec)]


# -- the disabled path is bit-identical --------------------------------------------

def no_recorder_matches_recorder_run_exactly(P):
    trace = P.rt.drifting_skew_trace(N, 24, dwell=8)
    plain = P.Runtime(_topo(P)).run_trace(trace)
    traced = P.Runtime(_topo(P), recorder=P.obs.FlightRecorder("t")).run_trace(trace)
    assert json.dumps(plain.to_json_obj(), sort_keys=True) == json.dumps(
        traced.to_json_obj(), sort_keys=True)
    assert all(a == b for a, b in zip(plain.reports, traced.reports))
    return plain.to_json_obj()


def session_reports_identical_modulo_metrics(P):
    trace = P.rt.drifting_skew_trace(N, 12, dwell=4)

    def run(recorder):
        with P.Session(P.Spec(topology=_topo(P), adaptivity="adaptive"),
                       recorder=recorder) as sess:
            res = sess.run_trace(trace)
            rep = sess.report()
        return res, rep

    res_a, rep_a = run(None)
    rec = P.obs.FlightRecorder("s")
    res_b, rep_b = run(rec)
    assert json.dumps(res_a.to_json_obj(), sort_keys=True) == json.dumps(
        res_b.to_json_obj(), sort_keys=True)
    metrics = [rep_a.pop("metrics"), rep_b.pop("metrics")]
    assert rep_a == rep_b
    rep_a.pop("topology")
    return [rep_a, metrics, recorded(rec)]


def serve_report_identical_with_recorder(P):
    spec = P.serve.get_scenario("minimal")
    rec = P.obs.FlightRecorder("m")
    with_rec = P.run_scenario(spec, "adaptive", recorder=rec).to_json_obj()
    without = P.run_scenario(spec, "adaptive").to_json_obj()
    assert "metrics" not in without
    metrics = with_rec.pop("metrics")
    assert json.dumps(with_rec, sort_keys=True) == json.dumps(without, sort_keys=True)
    return [without, metrics, recorded(rec)]


SCENARIOS = {f.__name__: f for f in (
    drift_trace_is_valid, timestamps_sorted_and_x_spans_have_durations,
    every_event_carries_the_correlation_id, window_spans_align_to_window_clock,
    export_is_tagged_and_json_native, validator_verdicts, open_begin_is_never_exported,
    tracer_clock_and_capacity, session_runtime_arbiter_share_one_id,
    serve_scenario_covers_all_four_layers, spans_nest_within_the_window_span,
    disabled_recorder_records_nothing, arbiter_hooks, snapshot_is_deterministic,
    absorbs_scattered_stats, counter_rejects_negative_and_kind_conflicts,
    histogram_buckets_and_stats, session_report_embeds_metrics,
    window_report_carries_confidence_and_rejections, every_swap_has_a_record,
    initial_plan_is_recorded_but_not_swapped, cache_hit_flag,
    topology_trigger_carries_fault_context, attach_recorder_backfills_the_active_plan,
    lifecycle_marks, queryable_after_run, watchdog_abandonment,
    no_recorder_matches_recorder_run_exactly, session_reports_identical_modulo_metrics,
    serve_report_identical_with_recorder,
)}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_scenario_equals_reference(case):
    _pair(SCENARIOS[case])


def test_snapshot_round_trips_through_jsonio_equals_reference(tmp_path):
    got = norm(snapshot_round_trips_through_jsonio(PORT, tmp_path))
    want = norm(snapshot_round_trips_through_jsonio(JAX, tmp_path))
    assert got == want


def test_default_correlation_ids_count_recorders():
    """The default id is ``nimble-<k>`` from a process-wide counter, on both
    packages; ``disabled()`` takes the fixed id and does not count."""
    first = tobs.FlightRecorder().correlation_id
    k = int(first.split("-")[1])
    tobs.FlightRecorder.disabled()
    assert tobs.FlightRecorder().correlation_id == f"nimble-{k + 1}"
    jfirst = jobs.FlightRecorder().correlation_id
    jk = int(jfirst.split("-")[1])
    jobs.FlightRecorder.disabled()
    assert jobs.FlightRecorder().correlation_id == f"nimble-{jk + 1}"


# -- launch/drills.py's obs section against benchmarks/bench_obs.py ----------------

def test_obs_section_equals_reference():
    import os
    import sys

    from repro_torch.launch import drills

    root = os.path.join(os.path.dirname(__file__), "..")
    sys.path.insert(0, root)
    try:
        from benchmarks import bench_obs
    finally:
        sys.path.remove(root)
    reports = {}
    trec, jrec = tobs.FlightRecorder("bench"), jobs.FlightRecorder("bench")
    got = drills.obs(device="cpu", reports=reports, recorder=trec)
    real = bench_obs.FlightRecorder
    made = iter([jrec])
    bench_obs.FlightRecorder = lambda: next(made, None) or real()
    try:
        want = bench_obs.obs_section()
    finally:
        bench_obs.FlightRecorder = real
    for key in drills.OBS_WALL_KEYS:
        assert got.pop(key) > 0 and want.pop(key) > 0
    assert got == want
    assert got["identical"] and got["trace_events"] == 70
    assert got["plans_issued"] == 8 and got["plans_swapped"] == 7
    assert recorded(trec) == recorded(jrec)
    assert reports["obs traced"] == reports["obs plain"]
    bench_obs.validate_obs({**got, "overhead_ratio": 1.0})
