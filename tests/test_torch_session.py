"""Port endpoint API against the JAX package's ``Session``.

The cases of the reference's ``tests/test_session.py`` run on both
packages (the port's sessions solve on the CPU, ``device="cpu"``): plans,
window reports, fairness records and ``Session.report()`` must be equal.
Then ``launch/fairness.py``'s five sections against the reference's
``benchmarks/bench_fairness.py`` (every figure equal), the selfcheck, the
two examples wired through a ``Session``, and paper-moe-8e's MoE layer
built through a ``Session``-wired ``ParallelContext``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import repro.runtime as jrt
from repro.api import Session as JSession, SessionSpec as JSessionSpec
from repro.api import TopologySpec as JTopologySpec
from repro.core import fabsim as jfabsim
from repro.core.dataplane import NimbleAllToAll as JNimbleAllToAll
from repro.core.moe_comm import MoECommConfig as JMoECommConfig
from repro.core.moe_comm import MoEDispatcher as JMoEDispatcher
from repro.core.topology import Topology as JTopology
from repro_torch import api as tapi
from repro_torch.api import Session as TSession, SessionSpec as TSessionSpec
from repro_torch.api import TopologySpec as TTopologySpec
from repro_torch.core.dataplane import NimbleAllToAll as TNimbleAllToAll
from repro_torch.core.moe_comm import MoECommConfig as TMoECommConfig
from repro_torch.core.moe_comm import MoEDispatcher as TMoEDispatcher
from repro_torch.core.topology import Topology as TTopology
from repro_torch.jsonio import json_dumps, json_loads, schema_kind
from repro_torch.launch import fairness

from test_torch_fabric import JAX, PORT, elephant, norm, raised, skew_demand

pytestmark = pytest.mark.torch_port

ROOT = os.path.join(os.path.dirname(__file__), "..")
MB = float(1 << 20)
N = 8
G = 4


def assert_reports_identical(a, b):
    assert a.to_json_obj() == b.to_json_obj()
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


def _pair(scenario):
    got, want = norm(scenario(PORT)), norm(scenario(JAX))
    assert got == want
    return got


# -- spec ------------------------------------------------------------------------

def test_topology_spec_builds_identical():
    built = TTopologySpec(N, group_size=G, n_pods=2, link_scale={(0, G): 0.5}).build()
    ref = JTopologySpec(N, group_size=G, n_pods=2, link_scale={(0, G): 0.5}).build()
    assert built.fingerprint == ref.fingerprint
    assert TTopologySpec(N, group_size=G).build().fingerprint == TTopology(N, G).fingerprint


SPEC_ERRORS = {
    "adaptivity": dict(adaptivity="warp"),
    "weight": dict(weight=0.0),
    "qos": dict(qos="platinum"),
    "runtime-static": dict(runtime="RuntimeConfig"),
    "fabric-adaptive": dict(adaptivity="adaptive", fabric="arbiter"),
    "two-planners": dict(adaptivity="adaptive", runtime="RuntimeConfig",
                         planner="PlannerConfig"),
    "price_decay": dict(price_decay=0.0),
    "fabric_staleness": dict(fabric_staleness=0),
    "arbiter-and-fabric": dict(adaptivity="arbitrated", arbiter="ArbiterConfig",
                               fabric="arbiter"),
}


def _spec_kwargs(P, kw):
    out = dict(kw)
    for k, v in kw.items():
        if v == "RuntimeConfig":
            out[k] = P.rt.RuntimeConfig()
        elif v == "PlannerConfig":
            out[k] = P.PlannerConfig()
        elif v == "ArbiterConfig":
            out[k] = P.fab.ArbiterConfig()
        elif v == "arbiter":
            out[k] = P.fab.FabricArbiter(P.Topology(N, G))
    return out


@pytest.mark.parametrize("case", list(SPEC_ERRORS))
def test_spec_validation_equals_reference(case):
    def scenario(P):
        kw = _spec_kwargs(P, SPEC_ERRORS[case])
        return raised(lambda: P.Spec(topology=P.Topology(N, G), **kw))
    _pair(scenario)


def test_spec_folds_and_cost_overrides_equal_reference():
    def scenario(P):
        ts = P.Topology(N, G)
        spec = P.Spec(topology=ts, adaptivity="arbitrated",
                      policy=P.rt.PolicyConfig(fabric_staleness=7))
        assert spec.policy_config().fabric_staleness == 7
        assert P.Spec(topology=ts, adaptivity="adaptive").policy_config() is None
        cm = P.Spec(topology=ts, cost={"relay_cap": 50e9}).build_cost_model()
        assert cm.relay_cap == 50e9 and cm.inject_cap == P.mcf.CostModel().inject_cap
        arb = P.Spec(topology=ts, adaptivity="arbitrated").arbiter_config()
        pinned = P.Spec(topology=ts, adaptivity="arbitrated",
                        arbiter=P.fab.ArbiterConfig(price_decay=9.0)).arbiter_config()
        return [spec.policy_config(), dataclasses.asdict(cm), arb, pinned,
                P.Spec(topology=ts, qos="gold", weight=2.5).tenant_config(),
                P.Spec(topology=ts, adaptivity="adaptive",
                       planner=P.PlannerConfig(lam=0.5)).runtime_config()]
    _pair(scenario)
    assert TSessionSpec(topology=TTopology(N, G)).device == "cuda"


# -- static, adaptive, arbitrated: the facade against the reference's ---------------

def static_plans(P):
    D = skew_demand()
    with P.Session(P.Spec(topology=P.TopoSpec(N, group_size=G))) as sess:
        out = [sess.plan(D, mode=m) for m in ("nimble", "direct", "stripe")]
        Dm = np.zeros((N, N))
        for (s, d), v in D.items():
            Dm[s, d] = v
        out.append(sess.plan(Dm))
        err = raised(lambda: sess.plan(D, mode="warp"))
    topo = P.Topology(N, G)
    refs = [P.mcf.solve_mwu(topo, D), P.mcf.solve_direct(topo, D),
            P.mcf.solve_static_striping(topo, D)]
    assert norm(out[:3]) == norm(refs) and norm(out[3]) == norm(refs[0])
    return out + [err]


def static_run_trace(P):
    topo = P.Topology(N, G)
    trace = jrt.drifting_skew_trace(N, 8, dwell=4)
    with P.Session(P.Spec(topology=topo)) as sess:
        got = sess.run_trace(trace)
        oracle = sess.run_oracle(trace)
    assert norm(got) == norm(P.run_static(topo, trace))
    return [got, oracle]


def adaptive_trace(P):
    topo = P.Topology(N, G)
    trace = jrt.drifting_skew_trace(N, 24, dwell=8)
    ref = P.Runtime(topo).run_trace(trace)
    with P.Session(P.Spec(topology=topo, adaptivity="adaptive")) as sess:
        got = sess.run_trace(trace)
        prefilled = sess.prefill(trace[:3])
        report = sess.report()
    assert_reports_identical(ref, got)
    report.pop("topology")
    return [got, prefilled, report]


def arbitrated_opt_out(P):
    topo = P.Topology(N, G)
    trace = jrt.drifting_skew_trace(N, 20, dwell=6)
    bg = elephant(P, topo)
    rt = P.Runtime(topo)
    arb = P.fab.FabricArbiter(topo)
    arb.register_runtime("skew", rt)
    arb.register("bg")
    arb.commit("bg", bg.resource_bytes)
    ref = rt.run_trace(trace)
    spec = P.Spec(topology=topo, adaptivity="arbitrated", tenant="skew",
                  price_decay=None, fabric_staleness=None)
    with P.Session(spec) as sess:
        sess.join_static_tenant("bg", bg)
        got = sess.run_trace(trace)
        fair = sess.fabric.fairness_report()
    assert_reports_identical(ref, got)
    assert fair == arb.fairness_report()
    return [got, fair]


def arbitrated_calibrated(P):
    topo = P.Topology(N, G)
    trace = jrt.drifting_skew_trace(N, 20, dwell=6)
    bg = elephant(P, topo)
    rt = P.Runtime(topo, policy=P.rt.ReplanPolicy(P.rt.PolicyConfig(
        fabric_staleness=P.api.FABRIC_STALENESS_DEFAULT)))
    arb = P.fab.FabricArbiter(topo, cfg=P.fab.ArbiterConfig(
        price_decay=P.api.PRICE_DECAY_DEFAULT))
    arb.register_runtime("skew", rt)
    arb.register("bg")
    arb.commit("bg", bg.resource_bytes)
    ref = rt.run_trace(trace)
    with P.Session(P.Spec(topology=topo, adaptivity="arbitrated", tenant="skew")) as sess:
        sess.join_static_tenant("bg", bg)
        got = sess.run_trace(trace)
        fair = sess.fabric.fairness_report()
        report = sess.report()
    assert_reports_identical(ref, got)
    assert fair == arb.fairness_report()
    report.pop("topology")
    return [got, report]


def arbitrated_plan_prices(P):
    topo = P.Topology(N, G)
    D = skew_demand()
    bg = elephant(P, topo)
    arb = P.fab.FabricArbiter(topo)
    arb.register("job")
    arb.register("bg")
    arb.commit("bg", bg.resource_bytes)
    ref = P.mcf.solve_mwu(topo, D, ext_loads=arb.prices_for("job"))
    with P.Session(P.Spec(topology=topo, adaptivity="arbitrated", tenant="job")) as sess:
        sess.join_static_tenant("bg", bg)
        got = sess.plan(D)
        assert norm(got) == norm(ref)
        assert set(sess.fabric.state.tenants()) == {"bg", "job"}
        sess.plan(D, mode="direct")
        assert np.array_equal(sess.fabric.state.committed_load("job"), ref.resource_bytes)
        return [got, sess.fabric.to_json_obj()]


def plan_threads_planner(P):
    topo = P.Topology(N, G)
    D = skew_demand()
    pcfg = P.PlannerConfig(lam=0.5, chunk_bytes=2.0 * MB)
    spec = P.Spec(topology=topo, adaptivity="adaptive",
                  runtime=P.rt.RuntimeConfig(planner=pcfg))
    with P.Session(spec) as sess:
        got = sess.plan(D)
    assert norm(got) == norm(P.mcf.solve_mwu(topo, D, lam=0.5, eps=2.0 * MB))
    return [got]


def lifecycle(P):
    topo = P.Topology(N, G)
    spec = P.Spec(topology=topo, adaptivity="arbitrated", tenant="t")
    with P.Session(spec) as sess:
        arb = sess.fabric
        rep = sess.step(jrt.balanced_trace(N, 1)[0])
        assert arb.tenants() == ["t"] and len(arb.bus) == 1
        assert sess.tenant == "t" and sess.state == "active"
    assert sess.state == "closed" and arb.tenants() == [] and len(arb.bus) == 0
    errs = [raised(lambda: sess.plan(skew_demand())),
            raised(lambda: sess.step(jrt.balanced_trace(N, 1)[0])),
            raised(lambda: sess.report()),
            raised(lambda: sess.__enter__())]
    sess.close()
    with P.Session(P.Spec(topology=topo)) as st:
        errs += [raised(lambda: st.step(jrt.balanced_trace(N, 1)[0])),
                 raised(lambda: st.join_static_tenant("bg", np.zeros(1))),
                 raised(lambda: st.plan(skew_demand(), commit=True)),
                 raised(lambda: st.prefill([]))]
    return [rep, errs, arb.to_json_obj()]


def shared_fabric(P):
    topo = P.Topology(N, G)
    with P.Session(P.Spec(topology=topo, adaptivity="arbitrated", tenant="a")) as sa:
        spec_b = P.Spec(topology=topo, adaptivity="arbitrated", tenant="b",
                        fabric=sa.fabric)
        with P.Session(spec_b) as sb:
            assert sb.fabric is sa.fabric and sa.fabric.tenant_order() == ["a", "b"]
            ra = sa.step(jrt.balanced_trace(N, 1)[0])
            rb = sb.step(jrt.balanced_trace(N, 1)[0])
            assert set(sa.fabric.state.tenants()) == {"a", "b"}
        assert sa.fabric.tenants() == ["a"] and sa.fabric.state.tenants() == ["a"]
        return [ra, rb, sa.fabric.to_json_obj()]


def join_atomic(P):
    topo = P.Topology(N, G)
    with P.Session(P.Spec(topology=topo, adaptivity="arbitrated", tenant="t")) as sess:
        err = raised(lambda: sess.join_static_tenant("bg", np.zeros(3)))
        assert sess.fabric.tenants() == ["t"]
        sess.join_static_tenant("bg", elephant(P, topo))
        assert set(sess.fabric.tenants()) == {"t", "bg"}
        return [err, sess.fabric.to_json_obj()]


def report_schemas(P):
    topo = P.Topology(N, G)
    with P.Session(P.Spec(topology=topo, adaptivity="arbitrated", tenant="r")) as sess:
        sess.join_static_tenant("bg", elephant(P, topo))
        sess.run_trace(jrt.drifting_skew_trace(N, 4, dwell=2))
        rec = sess.report()
    kinds = {k: P.schema_kind(rec[k]) for k in
             ("runtime_stats", "telemetry", "trace", "fairness", "arbiter_stats",
              "metrics")}
    assert P.schema_kind(rec) == "session" and kinds == {
        "runtime_stats": "runtime_stats", "telemetry": "telemetry_aggregate",
        "trace": "runtime_trace", "fairness": "fabric_fairness",
        "arbiter_stats": "fabric_arbiter_stats", "metrics": "metrics"}
    P.api.validate_fairness_record(rec["fairness"])
    return [rec]


def fabric_pressure(P):
    topo = P.Topology(N, G)
    out = []
    for kw, join_at, windows in (
            (dict(policy=P.rt.PolicyConfig(fabric_staleness=2)), 3, 10),
            ({}, 2, 8),
            (dict(fabric_staleness=None, price_decay=None), 2, 8)):
        trace = jrt.balanced_trace(N, windows)
        spec = P.Spec(topology=topo, adaptivity="arbitrated", tenant="stable", **kw)
        with P.Session(spec) as sess:
            reports = []
            for w in range(windows):
                if w == join_at:
                    sess.join_static_tenant("peer", elephant(P, topo, mb=512.0))
                reports.append(sess.step(trace[w]))
            out += [reports, sess.fabric.stats, sess.fabric.cfg]
    reasons = [[r.replan_reason for r in reps] for reps in out[0::3]]
    assert reasons[0].index("fabric") >= 5 and "fabric" in reasons[1]
    assert "fabric" not in reasons[2]
    return out


SESSION_SCENARIOS = {f.__name__: f for f in (
    static_plans, static_run_trace, adaptive_trace, arbitrated_opt_out,
    arbitrated_calibrated, arbitrated_plan_prices, plan_threads_planner, lifecycle,
    shared_fabric, join_atomic, report_schemas, fabric_pressure,
)}


@pytest.mark.parametrize("case", list(SESSION_SCENARIOS))
def test_session_scenario_equals_reference(case):
    _pair(SESSION_SCENARIOS[case])


def test_report_round_trips_and_keeps_the_device_out():
    with TSession(TSessionSpec(topology=TTopology(N, G), adaptivity="arbitrated",
                               tenant="r", device="cpu")) as sess:
        sess.step(jrt.balanced_trace(N, 1)[0])
        rec = sess.report()
    assert json_loads(json_dumps(rec)) == rec
    assert schema_kind(rec) == "session" and "device" not in rec


def test_session_refuses_an_enabled_recorder():
    class Rec:
        enabled = True

    class Off:
        enabled = False

    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        TSession(TSessionSpec(topology=TTopology(N, G), device="cpu"), recorder=Rec())
    with TSession(TSessionSpec(topology=TTopology(N, G), device="cpu"), recorder=Off()):
        pass
    with pytest.raises(TypeError, match="not both"):
        TSession(TSessionSpec(topology=TTopology(N, G), device="cpu"), tenant="x")
    with TSession(topology=TTopology(N, G), device="cpu") as sess:
        assert sess.spec.tenant == "default"


# -- endpoints -------------------------------------------------------------------

def _demand(seed, b, hi):
    rng = np.random.default_rng(seed)
    demand = rng.integers(0, hi, size=(b, N, N)).astype(np.int32)
    for i in range(b):
        np.fill_diagonal(demand[i], 0)
    return demand


@pytest.mark.parametrize("mode", ["nimble", "direct", "stripe"])
def test_all_to_all_plan_batch_equals_reference(mode):
    demand = _demand(0, 3, 16)
    ref = JNimbleAllToAll("x", N, G, max_chunks=16, chunk_bytes=1024.0, mode=mode)
    want = np.asarray(ref.plan_batch(demand))
    with TSession(TSessionSpec(topology=TTopologySpec(N, group_size=G), device="cpu")) as s:
        comm = s.all_to_all(max_chunks=16, chunk_bytes=1024.0, mode=mode)
        assert comm is s.all_to_all(max_chunks=16, chunk_bytes=1024.0, mode=mode)
        got = comm.plan_batch(torch.as_tensor(demand))
    np.testing.assert_array_equal(got.numpy(), want)
    hand = TNimbleAllToAll(N, G, max_chunks=16, chunk_bytes=1024.0, mode=mode)
    np.testing.assert_array_equal(hand.plan_batch(demand).numpy(), want)
    # each entry equals the per-call plan of the dataplane
    for b in range(3):
        np.testing.assert_array_equal(
            hand.plan_from_counts(torch.as_tensor(demand[b])).numpy(), want[b])


def test_all_to_all_telemetry_equals_reference():
    demand = _demand(5, 2, 6)
    with JSession(JSessionSpec(topology=JTopology(N, G), adaptivity="adaptive")) as js, \
            TSession(TSessionSpec(topology=TTopology(N, G), adaptivity="adaptive",
                                  device="cpu")) as ts:
        jc = js.all_to_all("x", max_chunks=8, chunk_bytes=1024.0)
        tc = ts.all_to_all(max_chunks=8, chunk_bytes=1024.0)
        assert tc.telemetry is ts.runtime.telemetry
        np.testing.assert_array_equal(tc.plan_batch(torch.as_tensor(demand)).numpy(),
                                      np.asarray(jc.plan_batch(demand)))
        assert len(ts.runtime.telemetry) == 2
        assert ts.runtime.telemetry.to_json_obj() == js.runtime.telemetry.to_json_obj()


def test_dataplane_geometry_check_equals_reference():
    with pytest.raises(ValueError, match="geometry") as t:
        TNimbleAllToAll(N, G, max_chunks=8, chunk_bytes=1.0, topo=TTopology(N, 2))
    with pytest.raises(ValueError, match="geometry") as j:
        JNimbleAllToAll("x", N, G, max_chunks=8, chunk_bytes=1.0, topo=JTopology(N, 2))
    assert str(t.value) == str(j.value)


def test_moe_dispatcher_from_session_equals_reference():
    demand = _demand(1, 2, 4)
    jcfg = JMoECommConfig(n_devices=N, n_experts=8, d_model=16, group_size=G)
    tcfg = TMoECommConfig(n_devices=N, n_experts=8, d_model=16, group_size=G)
    want_plain = np.asarray(JMoEDispatcher("x", jcfg).plan_batched(demand, n_assign=64))
    np.testing.assert_array_equal(
        TMoEDispatcher(tcfg).plan_batched(torch.as_tensor(demand), n_assign=64).numpy(),
        want_plain)
    with JSession(JSessionSpec(topology=JTopology(N, G), adaptivity="adaptive")) as js, \
            TSession(TSessionSpec(topology=TTopology(N, G), adaptivity="adaptive",
                                  device="cpu")) as ts:
        jd, td = js.moe_dispatcher("x", jcfg), ts.moe_dispatcher(tcfg)
        assert td.runtime is ts.runtime and td is ts.moe_dispatcher(tcfg)
        want = np.asarray(jd.plan_batched(demand, n_assign=64))
        got = td.plan_batched(torch.as_tensor(demand), n_assign=64)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, want_plain)
        # the dispatch demand reached the runtime's estimator and telemetry
        assert ts.runtime.estimator.predict().sum() > 0
        np.testing.assert_array_equal(ts.runtime.estimator.predict(),
                                      js.runtime.estimator.predict())
        assert ts.runtime.telemetry.to_json_obj() == js.runtime.telemetry.to_json_obj()
        assert len(ts.runtime.telemetry) == 2
    bad = TMoECommConfig(n_devices=4, n_experts=8, d_model=16, group_size=2)
    jbad = JMoECommConfig(n_devices=4, n_experts=8, d_model=16, group_size=2)
    with TSession(TSessionSpec(topology=TTopology(N, G), device="cpu")) as ts, \
            JSession(JSessionSpec(topology=JTopology(N, G))) as js:
        with pytest.raises(ValueError, match="geometry") as t:
            ts.moe_dispatcher(bad)
        with pytest.raises(ValueError, match="geometry") as j:
            js.moe_dispatcher("x", jbad)
    assert str(t.value) == str(j.value)


# -- launch/fairness.py against benchmarks/bench_fairness.py -----------------------

def _bench_fairness():
    sys.path.insert(0, ROOT)
    try:
        from benchmarks import bench_fairness
    finally:
        sys.path.remove(ROOT)
    return bench_fairness


@pytest.mark.parametrize("section", ["host_coplan", "weights_sweep", "runtime_adaptive",
                                     "four_tenant"])
def test_fairness_section_equals_reference(section):
    reports = {}
    got = fairness.SECTIONS[section](device="cpu", reports=reports)
    want = getattr(_bench_fairness(), section)()
    assert got == want
    assert reports and all(schema_kind(r) == "session" for r in reports.values())
    if section == "host_coplan":
        assert round(got["win"], 7) == 1.4554899
        assert round(got["jain_index"], 7) == 0.9983191
    if section == "runtime_adaptive":
        assert round(got["win"], 7) == 1.2131033 and got["replans"] == 2
        assert round(got["jain_index"], 7) == 0.9221414
    if section == "four_tenant":
        assert round(got["win"], 7) == 1.0071764 and got["solves"] == 6
        assert round(got["jain_index"], 7) == 0.8889080


@pytest.fixture(scope="module")
def drift_arms():
    """Each mutual-drift arm run once per package, shared by the tests below."""
    bench = _bench_fairness()
    want = bench.mutual_drift()
    got = {m: fairness.mutual_drift_arm(m, device="cpu")
           for m in fairness.MUTUAL_DRIFT_ARMS}
    return got, want


@pytest.mark.parametrize("arm", ["unpriced", "legacy", "calibrated"])
def test_mutual_drift_arm_equals_reference(drift_arms, arm):
    got, want = drift_arms
    assert got[arm] == want["arms"][arm]


def test_mutual_drift_summary_equals_reference(drift_arms):
    got, want = drift_arms
    summary = fairness.mutual_drift_summary(got)
    assert summary == want
    _bench_fairness().validate_mutual_drift(summary)
    assert round(summary["win"], 7) == 1.0181673
    assert round(summary["win_legacy"], 7) == 0.7995681
    cal = summary["arms"]["calibrated"]
    assert cal["reprices"] == 3 and cal["price_hints"] == 11
    assert cal["replans"] == {"a": 4, "b": 10}


def test_fairness_command_on_cpu(capsys):
    assert fairness.main(["--device", "cpu", "--sections", "host_coplan",
                          "four_tenant"]) == 0
    out = capsys.readouterr().out
    assert "[fairness] host_coplan" in out and "win 1.4554899" in out
    assert "runtime solves on the card" not in out


# -- selfcheck and examples ----------------------------------------------------------

def test_selfcheck_on_cpu(capsys):
    from repro_torch.api import selfcheck

    assert selfcheck.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[selfcheck] 5/5 checks passed on cpu" in out
    rec = selfcheck.check_arbitrated(device="cpu")
    from repro.api.selfcheck import check_arbitrated

    assert rec == check_arbitrated()
    with pytest.raises(ValueError, match="schema"):
        tapi.validate_fairness_record({**rec, "schema": "nimble.other/v1"})
    with pytest.raises(ValueError, match="jain_index"):
        tapi.validate_fairness_record({**rec, "jain_index": 1.5})


def test_skewed_alltoallv_example_on_cpu(capsys):
    from repro_torch.examples import skewed_alltoallv as ex

    results = ex.main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("all modes bit-exact vs oracle")
    # the projected completion of each mode equals the reference facade's
    with JSession(JSessionSpec(topology=JTopologySpec(N, group_size=4))) as js:
        for hotspot in ex.HOTSPOTS:
            counts = ex.skewed_counts(N, 32, hotspot, None)
            demands = {(s, d): float(counts[s, d]) * 64 * 4 * 2**14
                       for s in range(N) for d in range(N) if counts[s, d]}
            for mode in ex.MODES:
                ok, t = results[hotspot][mode]
                assert ok
                assert t == jfabsim.simulate(js.plan(demands, mode=mode)).completion_time


@pytest.fixture
def one_thread():
    """Train on one CPU thread: parallel test workers share the host's cores,
    and torch's default of one thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_example_losses_equal_the_unwired_build(monkeypatch, one_thread):
    from repro_torch.examples import train_moe_nimble as ex
    from repro_torch.sharding.context import ParallelContext

    argv = ["--device", "cpu", "--steps", "12", "--seq", "16", "--batch", "4"]
    wired = ex.main(argv)

    def unwired(**kw):
        assert isinstance(kw.pop("session"), TSession)
        return ParallelContext(**kw)

    monkeypatch.setattr(ex, "ParallelContext", unwired)
    assert ex.main(argv) == wired


def test_moe_forward_through_a_session_is_bit_identical():
    """paper-moe-8e reduced, EP 8 in groups of 4: the Session-wired MoE layer
    gives the unwired layer's logits bit for bit, and the session's runtime
    takes the dispatch demand only through plan_batched."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import ParallelContext

    cfg = dataclasses.replace(get_config("paper-moe-8e").reduced(), n_experts=8)
    ctx = ParallelContext(ep_size=8, group_size=4, device="cpu")
    model = build_model(cfg, ctx)
    params = model.init(0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    want, _ = model.forward(params, {"tokens": tokens})
    spec = TSessionSpec(topology=TTopologySpec(8, 4), adaptivity="arbitrated",
                        tenant="moe-serve", device="cpu")
    with TSession(spec) as sess:
        wired = build_model(cfg, dataclasses.replace(ctx, session=sess))
        got, _ = wired.forward(params, {"tokens": tokens})
        assert len(sess.runtime.telemetry) == 0
        assert torch.equal(got, want)
