"""Port runtime against the JAX runtime: the same WindowReport stream.

The acceptance scenarios of the reference's runtime (drifting skew,
balanced, link-down, skew burst) replay through both packages in the same
test; the port solves on the CPU here (``device="cpu"``) and its
``TraceResult.to_json_obj()``, stats and totals must equal the reference's.
The telemetry, estimator, policy, event and trace modules are held against
the reference on the cases of ``tests/test_runtime.py`` and
``tests/test_policies.py``.
"""

import dataclasses

import numpy as np
import pytest

import repro.runtime as jrt
from repro import jsonio as jjson
from repro.core import fabsim as jfab
from repro.core import mcf as jmcf
from repro.core.topology import Topology as JTopology
from repro_torch import jsonio as tjson
from repro_torch import runtime as trt
from repro_torch.core import fabsim as tfab
from repro_torch.core import mcf as tmcf
from repro_torch.core.topology import Topology as TTopology

pytestmark = pytest.mark.torch_port

MB = float(1 << 20)
N, G = 8, 4


def _topos(n=N):
    return JTopology(n, group_size=G), TTopology(n, group_size=G)


def _plans_equal(a, b):
    def key(p):
        return {k: [(f.path.nodes, f.bytes) for f in v] for k, v in p.flows.items()}
    assert key(a) == key(b)
    np.testing.assert_array_equal(a.resource_bytes, b.resource_bytes)


def assert_traces_equal(got, want):
    assert got.to_json_obj() == want.to_json_obj()
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.total_completion_s == want.total_completion_s
    assert got.replan_windows == want.replan_windows


#: name -> (n, trace, link-down events as (window, src, dst))
SCENARIOS = {
    "drift": (8, lambda: jrt.drifting_skew_trace(8, 48, dwell=12), ()),
    "balanced": (8, lambda: jrt.balanced_trace(8, 30), ()),
    "link-down": (8, lambda: jrt.balanced_trace(8, 24), ((8, 0, G),)),
    "skew-burst": (8, lambda: jrt.skew_burst_trace(8, 16, burst_window=5), ()),
    "returning-phase": (8, lambda: jrt.drifting_skew_trace(
        8, 60, dwell=10, hot_seq=[0, G], jitter=0.01), ()),
    "drift-n32": (32, lambda: jrt.drifting_skew_trace(32, 48, dwell=12), ()),
}
BOOKENDS = ("drift", "balanced", "link-down")


def _events(pkg, evs):
    return pkg.EventLog([pkg.link_down(*e) for e in evs])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_trace_equals_reference(name):
    n, make, evs = SCENARIOS[name]
    jt, tt = _topos(n)
    trace = make()
    jr = jrt.OrchestrationRuntime(jt, events=_events(jrt, evs))
    tr = trt.OrchestrationRuntime(tt, events=_events(trt, evs), device="cpu")
    want, got = jr.run_trace(trace), tr.run_trace(trace)
    assert_traces_equal(got, want)
    _plans_equal(tr.active_plan, jr.active_plan)
    assert tr.topo.fingerprint == jr.topo.fingerprint
    assert tr.cache_info() == jr.cache_info()
    assert tr.telemetry.to_json_obj() == jr.telemetry.to_json_obj()
    if name == "returning-phase":
        assert got.stats.cache_hits >= 1
    if name == "link-down":
        assert got.reports[8].replan_reason == "topology"
        assert got.reports[9].swapped


@pytest.mark.parametrize("name", BOOKENDS)
def test_bookends_equal_reference(name):
    n, make, evs = SCENARIOS[name]
    jt, tt = _topos(n)
    trace = make()
    assert_traces_equal(
        trt.run_static(tt, trace, events=_events(trt, evs), device="cpu"),
        jrt.run_static(jt, trace, events=_events(jrt, evs)))
    assert_traces_equal(trt.run_oracle(tt, trace, device="cpu"),
                        jrt.run_oracle(jt, trace))


def test_adaptive_beats_static_on_drift_and_matches_on_balanced():
    """The reference's acceptance numbers, on the port alone."""
    _, tt = _topos()
    drift = jrt.drifting_skew_trace(N, 48, dwell=12)
    static = trt.run_static(tt, drift, device="cpu")
    adaptive = trt.OrchestrationRuntime(tt, device="cpu").run_trace(drift)
    oracle = trt.run_oracle(tt, drift, device="cpu")
    assert static.total_completion_s / adaptive.total_completion_s >= 1.3
    assert adaptive.replan_fraction <= 0.25
    assert oracle.total_completion_s <= adaptive.total_completion_s * 1.01
    for w, rep in enumerate(adaptive.reports):
        assert rep.payload_bytes == pytest.approx(drift[w].sum(), rel=1e-6)
    bal = jrt.balanced_trace(N, 30)
    a = trt.OrchestrationRuntime(tt, device="cpu").run_trace(bal)
    assert a.total_completion_s / trt.run_static(tt, bal, device="cpu").total_completion_s <= 1.02
    assert all(w < 2 for w in a.replan_windows)


def test_observe_dispatch_stack_equals_reference():
    jt, tt = _topos()
    stack = jrt.drifting_skew_trace(N, 6, dwell=2, seed=3)
    jr = jrt.OrchestrationRuntime(jt)
    tr = trt.OrchestrationRuntime(tt, device="cpu")
    jr.observe_dispatch(stack)
    tr.observe_dispatch(stack)
    tr.observe_dispatch(stack[0])                     # one [n, n] matrix
    jr.observe_dispatch(stack[0])
    assert tr.telemetry.to_json_obj() == jr.telemetry.to_json_obj()
    np.testing.assert_array_equal(tr.estimator.predict(), jr.estimator.predict())
    np.testing.assert_array_equal(tr.telemetry.observed_demand(),
                                  jr.telemetry.observed_demand())
    # the loop continues from the dispatch-driven window clock
    more = jrt.skew_burst_trace(N, 8, burst_window=2)
    assert_traces_equal(tr.run_trace(more), jr.run_trace(more))


def _configured(pkg, topo, case):
    kw = {}
    if case == "never-replan":
        kw["policy"] = pkg.NeverReplan()
    elif case == "patient-stale":
        kw["policy"] = pkg.ReplanPolicy(pkg.PolicyConfig(patience=2, max_staleness=6))
    elif case == "watchdog":
        kw["cfg"] = pkg.RuntimeConfig(solve_delay_windows=4, pending_deadline_windows=2)
    elif case == "estimator-initial":
        kw["estimator"] = pkg.DemandEstimator(N, pkg.EstimatorConfig(alpha=0.25,
                                                                     burst_ratio=2.0))
        kw["initial_demand"] = jrt.drifting_skew_trace(N, 1, seed=9)[0]
    if pkg is trt:
        kw["device"] = "cpu"
    return pkg.OrchestrationRuntime(topo, **kw)


@pytest.mark.parametrize("case", ["never-replan", "patient-stale", "watchdog",
                                  "estimator-initial"])
def test_runtime_options_equal_reference(case):
    jt, tt = _topos()
    trace = jrt.drifting_skew_trace(N, 30, dwell=6, ramp=1)
    jr, tr = _configured(jrt, jt, case), _configured(trt, tt, case)
    want, got = jr.run_trace(trace), tr.run_trace(trace)
    assert_traces_equal(got, want)
    if case == "never-replan":
        assert got.replan_windows == [] and got.stats.swaps == 0
    if case == "watchdog":
        assert got.stats.watchdog_abandons >= 1


def test_fault_drill_step_inputs_equal_reference():
    """Blackout (observed=None), partial (NaN) telemetry and a straggler
    window, through ``step``'s keyword inputs."""
    jt, tt = _topos()
    trace = jrt.drifting_skew_trace(N, 12, dwell=4, ramp=1)
    jr = jrt.OrchestrationRuntime(jt)
    tr = trt.OrchestrationRuntime(tt, device="cpu")
    for w, D in enumerate(trace):
        kw = {}
        if w in (3, 4):
            kw["observed"] = None
        elif w == 6:
            part = D.copy()
            part[1, :3] = np.nan
            kw["observed"] = part
        elif w == 8:
            kw["completion_scale"] = 2.5
        assert tr.step(D, **kw).to_json_obj() == jr.step(D, **kw).to_json_obj()
    assert tr.estimator.missing_windows == jr.estimator.missing_windows == 2


def test_swap_is_deferred_to_boundary_and_tables_rebuild():
    _, tt = _topos()
    res = trt.OrchestrationRuntime(tt, device="cpu").run_trace(
        jrt.drifting_skew_trace(N, 20, dwell=6, ramp=1))
    assert res.stats.swaps >= 1
    for prev, cur in zip(res.reports, res.reports[1:]):
        if cur.plan_version != prev.plan_version:
            assert cur.swapped and cur.plan_version > prev.plan_version
    rt = trt.OrchestrationRuntime(tt, device="cpu")
    before = rt.tables
    rt.events.schedule(trt.link_down(0, 0, G))
    rt.step(jrt.balanced_trace(N, 1)[0])
    assert rt.tables is not before and rt.stats.events == 1
    assert rt.topo.fingerprint != tt.fingerprint


def test_prefill_cache_equals_reference():
    jt, tt = _topos()
    phases = [jrt.drifting_skew_trace(N, 1, dwell=1, hot_seq=[h], jitter=0.0)[0]
              for h in (0, 2, 5)]
    jr = jrt.OrchestrationRuntime(jt)
    tr = trt.OrchestrationRuntime(tt, device="cpu")
    assert tr.prefill_cache(phases) == jr.prefill_cache(phases) == 3
    assert tr.prefill_cache(phases) == 0
    assert tr.cache_info() == {"size": 4, "hits": 0, "solves": 4}
    for D in phases:
        sig = tr.demand_signature(D)
        assert sig == jr.demand_signature(D)
        _plans_equal(tr._cache[sig], jr._cache[sig])
    z = np.zeros((N, N))
    assert tr.demand_signature(z) == jr.demand_signature(z)


@pytest.mark.parametrize("b", [1, 5])
def test_solve_plans_batch_equals_reference(b):
    jt, tt = _topos()
    D = jrt.drifting_skew_trace(N, b, dwell=1, seed=b)
    ext = np.random.default_rng(b).uniform(0, 256 * MB, (b, jmcf.ResourceModel(jt).n_resources))
    for kw in ({}, {"ext_loads": ext}):
        for p, q in zip(trt.solve_plans_batch(tt, D, device="cpu", **kw),
                        jrt.solve_plans_batch(jt, D, **kw)):
            _plans_equal(p, q)
            assert p.iterations == q.iterations == 24


# -- components -----------------------------------------------------------------

def test_telemetry_equals_reference():
    caps = np.array([100.0, 200.0, 400.0])
    tels = [pkg.LinkTelemetry(caps, window_capacity=4) for pkg in (jrt, trt)]
    for tel in tels:
        for w in range(6):
            tel.record_loads(w, np.array([100.0, 100.0, 0.0]) * (w + 1),
                             pair_bytes=np.full((2, 2), float(w)))
        tel.record_loads(None, np.array([np.nan, 1.0, 1.0]))       # rejected
        tel.record_loads(None, np.array([-1.0, 1.0, 1.0]))         # rejected
        with pytest.raises(ValueError, match="loads shape"):
            tel.record_loads(0, np.ones(2))
    j, t = tels
    assert t.to_json_obj() == j.to_json_obj()
    assert t.health() == j.health() and t.rejected == 2
    assert [w.window for w in t.latest(4)] == [2, 3, 4, 5]
    np.testing.assert_array_equal(t.mean_util(2), j.mean_util(2))
    np.testing.assert_array_equal(t.observed_demand(), j.observed_demand())
    assert t.utilization_imbalance(3) == j.utilization_imbalance(3)
    # harvesting a fabsim result
    jt, tt = _topos()
    dem = jrt.demand_dict(jrt.balanced_trace(N, 1)[0])
    sj = jfab.simulate(jmcf.solve_direct(jt, dem))
    st = tfab.simulate(tmcf.solve_direct(tt, dem))
    jtel = jrt.LinkTelemetry(jmcf.ResourceModel(jt).capacity)
    ttel = trt.LinkTelemetry(tmcf.ResourceModel(tt).capacity)
    jtel.record(0, sj, completion_scale=1.5)
    ttel.record(0, st, completion_scale=1.5)
    assert ttel.to_json_obj() == jtel.to_json_obj()
    with pytest.raises(ValueError):
        trt.LinkTelemetry(caps, window_capacity=0)


def test_estimator_equals_reference():
    rng = np.random.default_rng(0)
    base = np.full((4, 4), 8.0 * MB)
    np.fill_diagonal(base, 0.0)
    burst = base.copy()
    burst[0, 1] = 200.0 * MB
    part = base.copy()
    part[2, 3] = np.nan
    obs = [base * rng.uniform(0.9, 1.1, (4, 4)) for _ in range(4)]
    obs += [burst, None, part, np.full((4, 4), np.nan), base]
    ests = [pkg.DemandEstimator(4, pkg.EstimatorConfig(alpha=0.25, burst_ratio=2.0))
            for pkg in (jrt, trt)]
    for o in obs:
        for e in ests:
            e.update(o)
        j, t = ests
        np.testing.assert_array_equal(t.predict(), j.predict())
        np.testing.assert_array_equal(t.burst_pairs(), j.burst_pairs())
        assert t.confidence == j.confidence
    assert ests[1].missing_windows == 2
    with pytest.raises(ValueError, match="observed shape"):
        ests[1].update(np.zeros((3, 3)))
    ests[1].reset()
    assert not ests[1].initialized and not ests[1].predict().any()


def _policy_script(pkg, cfg_kw):
    """A fixed script of decide / notify calls; returns every decision."""
    pol = pkg.ReplanPolicy(pkg.PolicyConfig(**cfg_kw))
    rng = np.random.default_rng(1)
    out = []
    for w in range(40):
        ratio = float(rng.choice([0.9, 1.0, 1.3, 2.0]))
        topo = w in (5, 6, 7, 9, 30)
        out.append(dataclasses.astuple(pol.decide(
            window=w, ratio=ratio, baseline_ratio=1.0, plan_age=w % 7,
            pending=w % 11 == 3, topology_event=topo)))
        if w % 8 == 4:
            pol.notify_swap(w - 1)
        if w == 12:
            pol.notify_gated()
        if w in (15, 16):
            pol.notify_fabric_pressure(w)
        out.append(pol.state_snapshot())
    return out


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"degrade_factor": 1.5, "rearm_factor": 1.1, "patience": 2, "cooldown_windows": 3},
    {"max_staleness": 5, "fabric_staleness": 2},
    {"flap_backoff_base": 0},
    {"flap_backoff_base": 2, "flap_backoff_max": 4, "flap_reset_windows": 4},
])
def test_policy_equals_reference(cfg_kw):
    assert _policy_script(trt, cfg_kw) == _policy_script(jrt, cfg_kw)


def test_policy_triggers():
    """The reference's hysteresis, staleness and topology cases."""
    pol = trt.ReplanPolicy(trt.PolicyConfig(degrade_factor=1.5, rearm_factor=1.1,
                                            patience=2, cooldown_windows=3))
    kw = dict(baseline_ratio=1.0, plan_age=0, pending=False)
    fired = [pol.decide(window=w, ratio=r, **kw).replan
             for w, r in enumerate([2.0, 2.0, 2.0, 2.0, 1.0, 2.0, 2.0])]
    assert fired == [False, True, False, False, False, False, True]
    pol = trt.ReplanPolicy(trt.PolicyConfig(max_staleness=5))
    base = dict(ratio=1.0, baseline_ratio=1.0, pending=False)
    assert not pol.decide(window=0, plan_age=4, **base).replan
    assert pol.decide(window=1, plan_age=5, **base).reason == "staleness"
    d = pol.decide(window=2, plan_age=0, ratio=1.0, baseline_ratio=1.0,
                   pending=True, topology_event=True)
    assert d.replan and d.reason == "topology"
    never = trt.NeverReplan()
    assert not never.decide(window=0, ratio=9.0, baseline_ratio=1.0, plan_age=99,
                            pending=False, topology_event=True).replan


def test_events_equal_reference():
    for pkg in (jrt, trt):
        log = pkg.EventLog()
        log.schedule(pkg.link_restored(5, 0, G))
        log.schedule(pkg.link_down(5, 0, G))
        log.schedule(pkg.link_degraded(2, 1, 2, 0.25))
        assert log.peek_next_window() == 2 and len(log) == 3
        snap = [ev.describe() for ev in log.copy().snapshot()]
        assert snap == ["link_degraded[1->2]@w2 x0.25", "link_restored[0->4]@w5",
                        "link_down[0->4]@w5"]
        assert [ev.kind for ev in log.pop_due(4)] == ["link_degraded"]
        due = log.pop_due(5)
        assert [ev.scale for ev in due] == [1.0, 0.0]
        assert dict(log.overrides(due)) == {(0, G): 0.0}
        with pytest.raises(ValueError, match="degraded scale"):
            pkg.link_degraded(0, 0, 1, 1.0)
    ev = (0, 1, 2, 0.5)
    assert trt.LinkEvent(*ev).to_json_obj() == jrt.LinkEvent(*ev).to_json_obj()
    assert trt.PricesMovedHint("a", 0.5) == trt.PricesMovedHint("a", 0.5, None)


def test_event_log_not_consumed_by_replays():
    _, tt = _topos()
    trace = jrt.balanced_trace(N, 12)
    events = trt.EventLog([trt.link_down(4, 0, G)])
    trt.OrchestrationRuntime(tt, device="cpu").run_trace(trace, events=events)
    assert len(events) == 1
    static = trt.run_static(tt, trace, events=events, device="cpu")
    assert len(events) == 1 and any(r.events for r in static.reports)


@pytest.mark.parametrize("kind,kw", [
    ("balanced_trace", {"jitter": 0.1, "seed": 3}),
    ("drifting_skew_trace", {"dwell": 5, "ramp": 2, "seed": 1}),
    ("drifting_skew_trace", {"hot_seq": [1, 6], "hot_frac": 0.5}),
    ("skew_burst_trace", {"burst_window": 2, "burst_pairs": [(0, 5), (3, 3)]}),
])
def test_traces_equal_reference(kind, kw):
    want = getattr(jrt, kind)(N, 12, **kw)
    got = getattr(trt, kind)(N, 12, **kw)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_jsonio_equals_reference(tmp_path):
    assert tjson.known_schemas() == jjson.known_schemas()
    for sid in ("nimble.runtime_trace/v1", "nimble.x_1/v3"):
        assert tjson.parse_schema_id(sid) == jjson.parse_schema_id(sid)
    for bad in ("nimble.runtime_trace", "other.kind/v1", "nimble.Bad/v1",
                "nimble.kind/v0", "nimble.kind/vx", 3):
        with pytest.raises(ValueError):
            tjson.parse_schema_id(bad)
    with pytest.raises(ValueError):
        tjson.tag("runtime_trace", {}, version=2)
    with pytest.raises(ValueError):
        tjson.tag("Bad", {})
    rec = tjson.tag("runtime_window", {"b": (1, 2), "a": {"d": 1, "c": 2}})
    assert rec == jjson.tag("runtime_window", {"b": (1, 2), "a": {"d": 1, "c": 2}})
    assert tjson.schema_kind(rec) == "runtime_window" and tjson.schema_version(rec) == 1
    assert tjson.schema_kind({}) == "" and tjson.schema_version({"schema": "x/vq"}) == 0
    path = tmp_path / "rec.json"
    tjson.write_json_file(str(path), rec)
    assert tjson.read_json_file(str(path)) == jjson.read_json_file(str(path))
    assert tjson.json_loads(tjson.json_dumps(rec)) == jjson.json_loads(jjson.json_dumps(rec))
    # a whole trace record round-trips to the same parsed object
    _, tt = _topos()
    res = trt.OrchestrationRuntime(tt, device="cpu").run_trace(jrt.balanced_trace(N, 4))
    obj = res.to_json_obj()
    assert tjson.json_loads(tjson.json_dumps(obj, indent=True)) == \
        jjson.json_loads(jjson.json_dumps(obj))


# -- the paper's planner policies (tests/test_policies.py), on both packages ------

@pytest.mark.parametrize("case", ["small-single-path", "elephant-splits",
                                  "rail-elephant-splits", "hysteresis-carry",
                                  "background-load", "balanced-direct"])
def test_paper_policy_cases_equal_reference(case):
    jt, tt = _topos()
    kw = {}
    if case == "small-single-path":
        dem = {(0, 1): MB, (2, 1): MB, (3, 1): MB}
    elif case == "elephant-splits":
        dem = {(0, 1): 256.0 * MB}
    elif case == "rail-elephant-splits":
        dem = {(4, 0): 256.0 * MB}
    elif case == "hysteresis-carry":
        dem = {(s, 0): 64.0 * MB for s in range(1, 4)}
        dem[(0, 1)] = 256.0 * MB
        kw["prev_loads"] = jmcf.solve_mwu(jt, dem).resource_bytes
    elif case == "background-load":
        dem = {(4, 0): 64.0 * MB}
        kw["prev_loads"] = 2.0 * jmcf.solve_direct(jt, {(4, 0): 1024.0 * MB}).resource_bytes
    else:
        dem = {(s, d): 16.0 * MB for s in range(N) for d in range(N) if s != d}
    pj, pt = jmcf.solve_mwu(jt, dem, **kw), tmcf.solve_mwu(tt, dem, **kw)
    _plans_equal(pt, pj)
    if case == "small-single-path":
        assert all(len(f) == 1 and f[0].path.n_relays == 0
                   for f in pt.consolidated().values())
    elif case.endswith("splits"):
        assert pt.n_paths_used(next(iter(dem))) >= 2
    elif case == "background-load":
        rail = tt.link_id(4, 0)
        assert pt.link_bytes[rail] < tmcf.solve_mwu(tt, dem).link_bytes[rail]
    elif case == "balanced-direct":
        assert tfab.simulate(pt).completion_time <= \
            tfab.simulate(tmcf.solve_direct(tt, dem)).completion_time * 1.05


def test_single_pair_bandwidth_saturation_equals_reference():
    jt, tt = _topos()
    bws = []
    for mb in [1, 4, 16, 64, 256, 1024]:
        dem = {(0, 1): float(mb) * MB}
        bw = tfab.pair_bandwidth(tmcf.solve_mwu(tt, dem), (0, 1))
        assert bw == jfab.pair_bandwidth(jmcf.solve_mwu(jt, dem), (0, 1))
        bws.append(bw / 1e9)
    assert all(b2 >= b1 - 1e-6 for b1, b2 in zip(bws, bws[1:]))
    assert bws[0] == pytest.approx(120.0, rel=0.01) and 250.0 < bws[-1] < 278.2 * 1.01
