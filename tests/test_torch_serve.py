"""Port serve control plane against the JAX package's: the same observations.

Every case of the reference's ``tests/test_serve_scenarios.py`` is written
once as a scenario over a package namespace and run on both packages (the
port's control plane solves on the CPU, ``device="cpu"``): scenario specs
and their JSON bytes, validation errors, traffic matrices, churn schedules,
``ServeReport``\\ s and SLO verdicts must be equal.  Then all six built-in
scenarios through both arms, ``launch/drills.py``'s serve sections against
the reference's ``benchmarks/bench_serve.py`` (every figure equal), the
scenario mode of ``launch/serve.py`` and the selfcheck's checks (the
reference's seven, and check 8: the port's static checker).
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:
    from hypothesis_compat import given, settings, st

    def example(**pinned):
        """Stand-in for ``hypothesis.example``: the pinned case runs before the draws."""
        def deco(fn):
            def run(*drawn):
                if not run.done:
                    run.done = True
                    fn(**pinned)
                fn(*drawn)
            run.done = False
            run.__name__, run.__qualname__ = fn.__name__, fn.__qualname__
            return run
        return deco

import repro.serve as jserve
from repro_torch import serve as tserve
from repro_torch.launch import drills

from test_torch_fabric import norm, raised

pytestmark = pytest.mark.torch_port

ROOT = os.path.join(os.path.dirname(__file__), "..")
MB = float(1 << 20)

JAX = types.SimpleNamespace(
    s=jserve, run=jserve.run_scenario, evaluate=jserve.evaluate_scenario,
    ControlPlane=jserve.ControlPlane)
PORT = types.SimpleNamespace(
    s=tserve,
    run=lambda *a, **kw: tserve.run_scenario(*a, device="cpu", **kw),
    evaluate=lambda *a, **kw: tserve.evaluate_scenario(*a, device="cpu", **kw),
    ControlPlane=lambda *a, **kw: tserve.ControlPlane(*a, device="cpu", **kw))


def _pair(scenario):
    got, want = norm(scenario(PORT)), norm(scenario(JAX))
    assert got == want
    return got


def _two_tenant(P, windows=8, **slo_kw):
    s = P.s
    return s.ScenarioSpec(
        name="t",
        topology=s.get_scenario("minimal").topology,
        windows=windows,
        tenants=(
            s.TenantSpec("a", s.TrafficProgram("steady", seed=1)),
            s.TenantSpec("b", s.TrafficProgram("steady", bytes_per_src=128 * MB,
                                               seed=2), qos="scavenger"),
        ),
        slo=s.SloSpec(**slo_kw),
    )


# -- registry round trip -------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tserve.BUILTIN_SCENARIOS))
def test_builtin_round_trips_bit_exact_and_equals_reference(name):
    def scenario(P):
        spec = P.s.get_scenario(name)
        obj = spec.to_json_obj()
        assert obj["schema"] == "nimble.serve_scenario/v1"
        assert P.s.ScenarioSpec.from_json_obj(obj) == spec
        data = spec.to_json()
        again = P.s.ScenarioSpec.from_json(data)
        assert again == spec and again.to_json() == data
        return [obj, data, spec.roster()]

    _pair(scenario)
    # each package reads the other's bytes back to its own equal spec
    tdata, jdata = tserve.get_scenario(name).to_json(), jserve.get_scenario(name).to_json()
    assert tdata == jdata
    assert tserve.ScenarioSpec.from_json(jdata) == tserve.get_scenario(name)


def registry_surface(P):
    s = P.s
    assert s.scenario_names() == sorted(s.BUILTIN_SCENARIOS)
    assert {"steady", "diurnal", "churn_storm", "flap_under_load",
            "elephant_victim", "minimal"} <= set(s.BUILTIN_SCENARIOS)
    assert s.get_scenario("steady") is not s.get_scenario("steady")
    return [s.scenario_names(), raised(lambda: s.get_scenario("nope"))]


def load_scenario_from_file(P, tmp_path):
    spec = P.s.get_scenario("flap_under_load")
    path = tmp_path / f"scn-{id(P)}.json"
    path.write_bytes(spec.to_json())
    assert P.s.load_scenario(str(path)) == spec
    assert P.s.load_scenario("minimal") == P.s.get_scenario("minimal")
    err = raised(lambda: P.s.load_scenario(str(tmp_path / "missing.json")))
    return [P.s.load_scenario(str(path)).to_json_obj(), str(err).replace(str(tmp_path), "")]


UNKNOWN_KEYS = {
    "scenario": lambda o: o.__setitem__("turbo", 1),
    "topology": lambda o: o["topology"].__setitem__("n_racks", 2),
    "tenant": lambda o: o["tenants"][0].__setitem__("priority", 9),
    "traffic": lambda o: o["tenants"][0]["traffic"].__setitem__("burst", 2),
    "slo": lambda o: o["slo"].__setitem__("p50_latency_s", 1.0),
    "schema": lambda o: o.__setitem__("schema", "nimble.serve_scenario/v2"),
    "not-a-dict": lambda o: o["tenants"].__setitem__(0, 3),
}


@pytest.mark.parametrize("case", list(UNKNOWN_KEYS))
def test_unknown_keys_raise_naming_offender_equal_reference(case):
    def scenario(P):
        obj = P.s.get_scenario("steady").to_json_obj()
        UNKNOWN_KEYS[case](obj)
        return raised(lambda: P.s.ScenarioSpec.from_json_obj(obj))

    err = _pair(scenario)
    assert err[0] == "ValueError"


def unknown_keys_in_churn_and_faults(P):
    out = []
    obj = P.s.get_scenario("churn_storm").to_json_obj()
    obj["churn"]["burstiness"] = 3
    out.append(raised(lambda: P.s.ScenarioSpec.from_json_obj(obj)))
    obj = P.s.get_scenario("churn_storm").to_json_obj()
    obj["churn"]["template"]["burst"] = 3
    out.append(raised(lambda: P.s.ScenarioSpec.from_json_obj(obj)))
    obj = P.s.get_scenario("flap_under_load").to_json_obj()
    obj["faults"]["meteors"] = []
    out.append(raised(lambda: P.s.ScenarioSpec.from_json_obj(obj)))
    obj = P.s.get_scenario("flap_under_load").to_json_obj()
    obj["faults"]["flaps"][0]["severity"] = 2
    out.append(raised(lambda: P.s.ScenarioSpec.from_json_obj(obj)))
    assert "churn: unknown key 'burstiness'" in str(out[0])
    assert "faults: unknown key 'meteors'" in str(out[2])
    assert "faults.flaps[0]: unknown key 'severity'" in str(out[3])
    return out


def spec_validation_rejects_bad_values(P):
    s = P.s
    base = _two_tenant(P)
    topo = s.get_scenario("minimal").topology
    return [
        raised(lambda: s.TrafficProgram("bursty")),
        raised(lambda: s.TrafficProgram("steady", bytes_per_src=0.0)),
        raised(lambda: s.TrafficProgram("steady", hot_frac=0.0)),
        raised(lambda: s.TrafficProgram("diurnal", period=1)),
        raised(lambda: s.TrafficProgram("diurnal", swell=0.5)),
        raised(lambda: s.TrafficProgram("flips", n_hot=0)),
        raised(lambda: s.TrafficProgram("steady", jitter=1.0)),
        raised(lambda: s.TenantSpec("x", s.TrafficProgram("steady"), join_window=5,
                                    leave_window=5)),
        raised(lambda: s.TenantSpec("", s.TrafficProgram("steady"))),
        raised(lambda: s.TenantSpec("x", s.TrafficProgram("steady"), join_window=-1)),
        raised(lambda: s.ChurnSpec(s.TrafficProgram("steady"), n_tenants=0)),
        raised(lambda: s.ChurnSpec(s.TrafficProgram("steady"), lifetime=0)),
        raised(lambda: s.ChurnSpec(s.TrafficProgram("steady"), jitter=-1)),
        raised(lambda: s.SloSpec(p99_latency_factor=0.5)),
        raised(lambda: s.SloSpec(p99_latency_s=0.0)),
        raised(lambda: s.SloSpec(combined_win_floor=0.0)),
        raised(lambda: s.SloSpec(jain_floor=1.5)),
        raised(lambda: s.SloSpec(max_recovery_windows=-1)),
        raised(lambda: s.SloSpec(availability_floor=2.0)),
        raised(lambda: s.SloSpec(availability_factor=0.5)),
        raised(lambda: s.ScenarioSpec(name="empty", topology=topo, windows=4,
                                      tenants=())),
        raised(lambda: s.ScenarioSpec(name="w", topology=topo, windows=0,
                                      tenants=base.tenants)),
        raised(lambda: dataclasses.replace(base, tenants=(
            s.TenantSpec("a", s.TrafficProgram("steady")),
            s.TenantSpec("a", s.TrafficProgram("steady", seed=9))))),
        raised(lambda: dataclasses.replace(
            base, topology=dataclasses.replace(topo, link_scale={(0, 4): 0.5})
        ).to_json_obj()),
        s.ScenarioSpec(name="lists", topology=topo, windows=2,
                       tenants=list(base.tenants)).tenants,
    ]


# -- determinism -------------------------------------------------------------------

def traffic_is_stateless_in_window(P):
    out = []
    for kind in ("steady", "diurnal", "drift", "flips"):
        prog = P.s.TrafficProgram(kind, seed=5)
        fresh = prog.demand(7, 8)
        for w in (0, 3, 11, 7):
            again = prog.demand(w, 8)
            assert again.shape == (8, 8) and float(np.diag(again).sum()) == 0.0
            assert (again >= 0).all()
            out.append(again)
        np.testing.assert_array_equal(prog.demand(7, 8), fresh)
        out.append(P.s.TrafficProgram(kind, seed=5, jitter=0.0).demand(13, 6))
    return out


def diurnal_swells_and_phase_shifts(P):
    prog = P.s.TrafficProgram("diurnal", hot=0, period=12, swell=2.0, jitter=0.0, seed=0)
    trough, peak = prog.demand(0, 8), prog.demand(6, 8)
    assert peak.sum() > 1.9 * trough.sum()
    assert peak[1:, 0].sum() > 0.6 * peak[1:].sum()
    shifted = P.s.TrafficProgram("diurnal", hot=0, period=12, swell=2.0, jitter=0.0,
                                 phase=6, seed=0)
    np.testing.assert_array_equal(shifted.demand(0, 8), peak)
    return [trough, peak, [prog.demand(w, 8) for w in range(12)]]


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 6), st.integers(1, 5), st.integers(1, 4),
       st.integers(0, 2), st.integers(0, 2 ** 16), st.integers(6, 40))
# slot 3 draws join window 6, past this 7-window horizon, while slot 4's
# jitter pulls it to window 5: a longer horizon inserts slot 3 before it
@example(n_tenants=5, lifetime=1, spacing=1, jitter=1, seed=1, windows=7)
def test_churn_compiles_deterministically_equal_reference(n_tenants, lifetime, spacing,
                                                          jitter, seed, windows):
    """Both packages compile the same churn schedule, deterministically.

    A longer horizon keeps every tenant that joins before ``windows - 1``,
    in order, and adds only tenants that join later: with jitter a later
    slot can join earlier than one that falls past the shorter horizon, so
    the shorter schedule need not be a prefix of the longer one.
    """
    def scenario(P):
        spec = P.s.ChurnSpec(
            template=P.s.TrafficProgram("steady", bytes_per_src=32 * MB),
            n_tenants=n_tenants, lifetime=lifetime, spacing=spacing,
            jitter=jitter, seed=seed,
        )
        a = P.s.compile_churn(spec, windows)
        assert a == P.s.compile_churn(spec, windows)
        assert len({t.name for t in a}) == len(a)
        for t in a:
            assert t.qos == "scavenger"
            assert 0 <= t.join_window < windows - 1 and t.leave_window > t.join_window
        longer = P.s.compile_churn(spec, windows + 10)
        assert tuple(t for t in longer if t.join_window < windows - 1) == a
        return [a, longer]

    _pair(scenario)


def scenario_roster_and_without_churn(P):
    spec = P.s.get_scenario("churn_storm")
    roster = spec.roster()
    assert roster == spec.roster()
    assert len([t for t in roster if t.name.startswith("churn-")]) >= 3
    control = spec.without_churn()
    assert control.churn is None and control.roster() == spec.tenants
    assert control.windows == spec.windows
    return [roster, control.to_json_obj()]


# -- control plane -----------------------------------------------------------------

def serve_report(rep):
    """A ``ServeReport`` whole: its record, every latency and ring sample."""
    return [rep.to_json_obj(), rep.window_latency_s,
            {n: led.ring.values() for n, led in rep.tenants.items()},
            rep.median_latency_s(), rep.p99_latency_s()]


def control_plane_serves_full_roster_both_arms(P):
    spec = _two_tenant(P, windows=8)
    out = []
    for mode in ("adaptive", "static"):
        rep = P.run(spec, mode)
        assert rep.mode == mode and set(rep.tenants) == {"a", "b"}
        for led in rep.tenants.values():
            assert led.windows == spec.windows
            assert led.completion_s > 0 and led.payload_bytes > 0
        assert len(rep.window_latency_s) == spec.windows
        assert min(rep.window_latency_s) > 0
        P.s.validate_serve_record(rep.to_json_obj())
        out.append(serve_report(rep))
    return out + [raised(lambda: P.ControlPlane(spec, mode="oracle"))]


def control_plane_replays_bit_identically(P):
    spec = _two_tenant(P, windows=6)
    a, b = P.run(spec, "adaptive"), P.run(spec, "adaptive")
    assert a.window_latency_s == b.window_latency_s
    for name in a.tenants:
        assert a.tenants[name].completion_s == b.tenants[name].completion_s
        assert a.tenants[name].replans == b.tenants[name].replans
    return [serve_report(a), serve_report(b)]


def churned_tenants_spawn_and_retire(P):
    spec = dataclasses.replace(P.s.get_scenario("churn_storm"), windows=16,
                               slo=P.s.SloSpec(jain_floor=0.0))
    rep = P.run(spec, "adaptive")
    assert any(n.startswith("churn-") for n in rep.tenants)
    for t in spec.roster():
        led = rep.tenants[t.name]
        assert led.joined == t.join_window
        expect_left = (t.leave_window if t.leave_window is not None
                       and t.leave_window <= spec.windows else spec.windows)
        assert led.left == expect_left and led.windows == led.left - led.joined
    return serve_report(rep)


def evaluate_scenario_minimal_passes_slo(P):
    res = P.evaluate(P.s.get_scenario("minimal"))
    assert res["slo"]["pass"], res["slo"]["gates"]
    gates = res["slo"]["gates"]
    assert {"p99_latency", "availability", "jain", "combined_drain",
            "tenant_drain"} <= set(gates)
    assert all(set(g) == {"ok", "value", "limit"} for g in gates.values())
    return [res["scenario"], serve_report(res["adaptive"]),
            serve_report(res["static"]), res["slo"]]


def evaluate_slo_gate_semantics(P):
    rep = P.run(_two_tenant(P, windows=6), "adaptive")
    solo = P.s.evaluate_slo(rep, P.s.SloSpec())
    assert not {"combined_drain", "tenant_drain", "recovery"} & set(solo["gates"])
    budgeted = P.s.evaluate_slo(rep, P.s.SloSpec(max_recovery_windows=2))
    assert budgeted["gates"]["recovery"]["value"] is None
    assert not budgeted["gates"]["recovery"]["ok"]
    strict = P.s.evaluate_slo(rep, P.s.SloSpec(jain_floor=1.0))
    assert strict["gates"]["jain"]["ok"] == (rep.jain_index >= 1.0)
    absolute = P.s.evaluate_slo(rep, P.s.SloSpec(p99_latency_s=1e-9))
    return [solo, budgeted, strict, absolute]


def validate_serve_record_names_violation(P):
    rec = P.run(P.s.get_scenario("minimal"), "static").to_json_obj()
    P.s.validate_serve_record(rec)
    out = []
    for fix in (lambda r: r.__setitem__("schema", "nimble.other/v1"),
                lambda r: r.__setitem__("cluster", dict(rec["cluster"], availability=1.5)),
                lambda r: r.pop("tenants"),
                lambda r: r.__setitem__("mode", "oracle"),
                lambda r: r.__setitem__("windows", 0),
                lambda r: r.__setitem__("tenants", {}),
                lambda r: r["cluster"].pop("jain_index"),
                lambda r: r.__setitem__("cluster", dict(rec["cluster"], jain_index=2.0)),
                lambda r: r.__setitem__("cluster", dict(rec["cluster"],
                                                        total_completion_s=-1.0)),
                lambda r: r.__setitem__("tenants", {"a": {"completion_s": -1.0}})):
        bad = json.loads(json.dumps(rec))
        fix(bad)
        out.append(raised(lambda: P.s.validate_serve_record(bad)))
    assert "nimble.serve" in str(out[0]) and "availability" in str(out[1])
    assert "tenants" in str(out[2])
    return out


def ring_percentiles_and_ledger(P):
    ring = P.s.RingPercentiles(capacity=4)
    empty = [ring.percentile(99.0), ring.median(), len(ring)]
    for v in (3.0, 1.0, 4.0, 1.5, 9.0, 2.6):
        ring.add(v)
    led = P.s.TenantLedger(name="x", qos="standard", weight=2.0, joined=1)
    idle = led.to_json_obj()
    for c, b, r in ((0.5, 1e9, True), (0.25, 2e9, False)):
        led.record(c, b, r)
    return [empty, ring.values(), ring.percentile(99.0), ring.median(), len(ring),
            raised(lambda: P.s.RingPercentiles(capacity=0)), idle, led.to_json_obj(),
            led.throughput_gbs()]


SCENARIOS = {f.__name__: f for f in (
    registry_surface, unknown_keys_in_churn_and_faults,
    spec_validation_rejects_bad_values, traffic_is_stateless_in_window,
    diurnal_swells_and_phase_shifts, scenario_roster_and_without_churn,
    control_plane_serves_full_roster_both_arms, control_plane_replays_bit_identically,
    churned_tenants_spawn_and_retire, evaluate_scenario_minimal_passes_slo,
    evaluate_slo_gate_semantics, validate_serve_record_names_violation,
    ring_percentiles_and_ledger,
)}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_scenario_equals_reference(case):
    _pair(SCENARIOS[case])


def test_load_scenario_from_file_equals_reference(tmp_path):
    got = norm(load_scenario_from_file(PORT, tmp_path))
    want = norm(load_scenario_from_file(JAX, tmp_path))
    assert got == want


# -- the six built-in scenarios, both arms -------------------------------------------

@pytest.mark.parametrize("name", sorted(tserve.BUILTIN_SCENARIOS))
def test_builtin_scenario_both_arms_equal_reference(name):
    def scenario(P):
        res = P.evaluate(P.s.get_scenario(name))
        return [res["scenario"], serve_report(res["adaptive"]),
                serve_report(res["static"]), res["slo"]]

    got = _pair(scenario)
    assert got[3]["pass"]


def test_recorded_scenario_equals_reference():
    """``flap_under_load`` flight-recorded on both packages: the trace event
    for event, the provenance log, the metrics snapshot."""
    from repro.obs import FlightRecorder as JRec
    from repro_torch.obs import FlightRecorder as TRec, validate_trace

    trec, jrec = TRec("flap"), JRec("flap")
    tres = tserve.evaluate_scenario(tserve.get_scenario("flap_under_load"),
                                    recorder=trec, device="cpu")
    jres = jserve.evaluate_scenario(jserve.get_scenario("flap_under_load"), recorder=jrec)
    assert tres["adaptive"].to_json_obj() == jres["adaptive"].to_json_obj()
    assert tres["static"].to_json_obj() == jres["static"].to_json_obj()
    assert trec.export_trace() == jrec.export_trace()
    assert trec.provenance.to_json_obj() == jrec.provenance.to_json_obj()
    assert trec.metrics_snapshot() == jrec.metrics_snapshot()
    info = validate_trace(trec.export_trace())
    assert {"serve", "runtime", "fabric", "planner"} <= set(info["cats"])
    assert info["correlation_id"] == "flap"


# -- launch/drills.py against benchmarks/bench_serve.py ----------------------------

def _bench_serve():
    sys.path.insert(0, ROOT)
    try:
        from benchmarks import bench_serve
    finally:
        sys.path.remove(ROOT)
    return bench_serve


#: the reference code's figures (its bench, rerun with JAX on a CPU)
SERVE_FIGURES = {
    "steady": {"win": 1.0087846045090592},
    "elephant_victim": {
        "win": 1.3643284145043393, "jain": 0.9777513524608447,
        "fault_digest": "3cda2f17a57e2727a90f0466d36a97eba23591165820e183897ecda986fd7c95"},
    "flap_under_load": {
        "win": 2.750643360569997,
        "fault_digest": "a7329c1364ba6572ee49552aa6e420a292700fa9f9c981ae1aa128b0d611f4ad"},
    "churn": {"tail_ratio": 0.9991283258421211, "total_ratio": 0.9556493285421601},
}


@pytest.fixture(scope="module")
def serve_sections():
    reports = {}
    got = {name: drills.SECTIONS[name](device="cpu", reports=reports)
           for name in drills.SERVE_SECTIONS}
    return got, reports


@pytest.mark.parametrize("section", drills.SERVE_SECTIONS)
def test_serve_section_equals_reference(serve_sections, section):
    got, reports = serve_sections
    bench = _bench_serve()
    want = (bench.churn_section() if section == "churn"
            else bench._scenario_section(section))
    assert got[section] == want
    for key, val in SERVE_FIGURES[section].items():
        assert got[section][key] == val, key
    if section != "churn":
        assert reports[f"{section} adaptive"] == got[section]["report"]


def test_serve_sections_pass_the_reference_gate_and_digests(serve_sections):
    got, _ = serve_sections
    _bench_serve().validate_serve(got)
    with open(os.path.join(ROOT, "BENCH_serve.json")) as fh:
        bench = json.load(fh)
    for name in ("elephant_victim", "flap_under_load"):
        assert got[name]["fault_digest"] == bench[name]["fault_digest"]
    # the degenerate absolute totals of flap_under_load, reproduced as they are
    assert got["flap_under_load"]["adaptive_total_s"] > 1e11


# -- the launcher's scenario mode and the selfcheck ---------------------------------

def test_serve_launcher_scenario_mode_on_cpu(capsys, tmp_path):
    from repro_torch.jsonio import read_json_file
    from repro_torch.launch import serve
    from repro_torch.obs import validate_trace

    trace, metrics, report = (str(tmp_path / f) for f in ("t.json", "m.json", "r.json"))
    rc = serve.main(["--scenario", "flap_under_load", "--mode", "both", "--device", "cpu",
                     "--trace-out", trace, "--metrics-out", metrics, "--json", report])
    out = capsys.readouterr().out
    assert rc == 0 and "[serve] SLO: PASS" in out
    assert "gate combined_drain: PASS (value 2.751, limit 1.0)" in out
    assert "layers=['fabric', 'planner', 'runtime', 'serve']" in out
    validate_trace(read_json_file(trace))
    rec = read_json_file(report)
    tserve.validate_serve_record(rec)
    assert rec["slo"]["pass"] and read_json_file(metrics)["schema"] == "nimble.metrics/v1"
    assert serve.main(["--scenario", "minimal", "--mode", "static",
                       "--device", "cpu"]) == 0
    assert serve.main(["--list-scenarios"]) == 0
    out = capsys.readouterr().out
    assert "mode=static, solves on cpu" in out
    assert out.rstrip().endswith("\n".join(tserve.scenario_names()))


def test_selfcheck_runs_seven_checks_on_cpu(capsys):
    from repro_torch.api import selfcheck

    assert selfcheck.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[selfcheck] 8/8 checks passed on cpu" in out
    assert "OK   serve: minimal scenario round-trips" in out
    assert "OK   lint: " in out and "lock fresh" in out
    assert "OK   obs: trace 52 events across 4 layers" in out
    from repro.api.selfcheck import check_obs, check_serve

    assert selfcheck.check_serve(device="cpu") == check_serve()
    got, want = selfcheck.check_obs(device="cpu"), check_obs()
    strip = lambda s: s.split("(corr=")[0] + s.split(")", 1)[1]
    assert strip(got) == strip(want)
