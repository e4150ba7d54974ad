"""Port fabric arbiter against the JAX package's: the same observations.

Every case of the reference's ``tests/test_fabric.py`` and
``tests/test_price_recency.py`` (and the arbiter cases of
``tests/test_faults.py``) is written once as a scenario over a package
namespace and run on both packages; the port's runtimes solve on the CPU
(``device="cpu"``).  A scenario returns what it observed — prices, ledger
loads, stamps, verdicts, hint payloads, window reports, stats — and the
two packages' observations must be equal, floats to the last bit.  The
reference's own assertions run inside each scenario, on both packages.
"""

import dataclasses
import types

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from hypothesis_compat import given, settings, st

import repro.api as japi
import repro.fabric as jfab
import repro.runtime as jrt
from repro.api import Session as JSession, SessionSpec as JSessionSpec
from repro.api import TopologySpec as JTopologySpec
from repro.core import mcf as jmcf
from repro.core.planner import PlannerConfig as JPlannerConfig, plan_flows as jplan_flows
from repro.core.schedule import build_planner_tables as jtables
from repro.core.topology import LinkEventBus as JBus, Topology as JTopology
from repro.jsonio import schema_kind as jschema_kind
from repro_torch import api as tapi
from repro_torch import fabric as tfab
from repro_torch import runtime as trt
from repro_torch.api import Session as TSession, SessionSpec as TSessionSpec
from repro_torch.api import TopologySpec as TTopologySpec
from repro_torch.core import mcf as tmcf
from repro_torch.core.planner import PlannerConfig as TPlannerConfig, plan_flows as tplan_flows
from repro_torch.core.schedule import build_planner_tables as ttables
from repro_torch.core.topology import LinkEventBus as TBus, Topology as TTopology
from repro_torch.jsonio import schema_kind as tschema_kind

pytestmark = pytest.mark.torch_port

MB = float(1 << 20)
N = 8
G = 4


def _port_runtime(topo, **kw):
    return trt.OrchestrationRuntime(topo, device="cpu", **kw)


def _port_spec(**kw):
    return TSessionSpec(device="cpu", **kw)


def _jax_plan_flows(D, tables, cfg, ext=None):
    import jax.numpy as jnp

    f, l = jplan_flows(jnp.asarray(D), tables, cfg,
                       ext_loads=None if ext is None else jnp.asarray(ext))
    return np.asarray(f), np.asarray(l)


def _port_plan_flows(D, tables, cfg, ext=None):
    import torch

    f, l = tplan_flows(torch.as_tensor(D), tables, cfg,
                       ext_loads=None if ext is None else torch.as_tensor(ext))
    return f.numpy(), l.numpy()


JAX = types.SimpleNamespace(
    api=japi, fab=jfab, rt=jrt, mcf=jmcf, Topology=JTopology, Bus=JBus,
    Runtime=jrt.OrchestrationRuntime, run_static=jrt.run_static, Session=JSession,
    Spec=JSessionSpec, TopoSpec=JTopologySpec, plan_flows=_jax_plan_flows,
    tables=jtables, PlannerConfig=JPlannerConfig, schema_kind=jschema_kind)
PORT = types.SimpleNamespace(
    api=tapi, fab=tfab, rt=trt, mcf=tmcf, Topology=TTopology, Bus=TBus,
    Runtime=_port_runtime,
    run_static=lambda topo, trace: trt.run_static(topo, trace, device="cpu"),
    Session=TSession, Spec=_port_spec, TopoSpec=TTopologySpec,
    plan_flows=_port_plan_flows, tables=ttables, PlannerConfig=TPlannerConfig,
    schema_kind=tschema_kind)


def norm(x):
    """A package-free, exactly comparable form of an observation."""
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        if type(x).__name__ == "Plan":
            return ("Plan", {k: [(f.path.nodes, f.bytes) for f in v]
                             for k, v in x.flows.items()},
                    norm(x.resource_bytes), norm(x.link_bytes), x.iterations)
        if hasattr(x, "to_json_obj"):
            return norm(x.to_json_obj())
        return (type(x).__name__,
                {f.name: norm(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def raised(fn):
    """The exception ``fn`` raises, as an observation (fails if none)."""
    try:
        fn()
    except (ValueError, KeyError, RuntimeError) as e:
        return e
    raise AssertionError("expected an exception")


def skew_demand(bytes_per_src=64 * MB, hot=0, hot_frac=0.7):
    return {
        (s, d): bytes_per_src * (hot_frac if d == hot else (1.0 - hot_frac) / (N - 2))
        for s in range(N) for d in range(N) if s != d
    }


def elephant_demand(mb=128.0, rails=(0, 1)):
    D = {}
    for r in rails:
        D[(r, r + G)] = mb * MB
        D[(r + G, r)] = mb * MB
    return D


def elephant(P, topo, mb=128.0, rails=(0, 1)):
    return P.mcf.solve_direct(topo, elephant_demand(mb, rails))


# -- scenarios: test_fabric.py ---------------------------------------------------

def prices_monotone(P):
    topo = P.Topology(N, group_size=G)
    cm = P.mcf.CostModel()
    arb = P.fab.FabricArbiter(topo, cm)
    arb.register("a")
    arb.register("b")
    assert arb.prices_for("a") is None
    bg = P.mcf.solve_direct(topo, elephant_demand(), cm)
    arb.commit("b", bg.resource_bytes)
    p1 = arb.prices_for("a")
    assert p1 is not None and (p1 >= 0).all()
    arb.commit("b", 2.0 * bg.resource_bytes)
    p2 = arb.prices_for("a")
    assert (p2 >= p1).all()
    arb2 = P.fab.FabricArbiter(topo, cm)
    arb2.register("a", P.fab.TenantConfig(weight=2.0))
    arb2.register("b")
    arb2.commit("b", bg.resource_bytes)
    assert np.allclose(arb2.prices_for("a"), p1 / 2.0)
    return [p1, p2, arb2.prices_for("a")]


def negative_commit_rejected(P):
    arb = P.fab.FabricArbiter(P.Topology(N, group_size=G))
    arb.register("a")
    bad = np.full(arb.state.n_resources, -1.0)
    return [raised(lambda: arb.commit("a", bad)),
            raised(lambda: arb.commit("a", np.zeros(3))),
            raised(lambda: arb.commit("zz", np.zeros(arb.state.n_resources))),
            arb.stats.commits]


def ext_zero_host(P):
    topo = P.Topology(N, group_size=G)
    D = skew_demand()
    ref = P.mcf.solve_mwu(topo, D)
    zero = P.mcf.solve_mwu(topo, D, ext_loads=np.zeros(ref.rm.n_resources))
    assert np.array_equal(ref.resource_bytes, zero.resource_bytes)
    assert np.array_equal(ref.link_bytes, zero.link_bytes)
    return [ref, zero]


def ext_zero_planner(P):
    tables = P.tables(P.Topology(N, group_size=G))
    cfg = P.PlannerConfig()
    D = np.array([[0 if s == d else 32 * MB for d in range(N)] for s in range(N)],
                 dtype=np.float32)
    ref = P.plan_flows(D, tables, cfg)
    zero = P.plan_flows(D, tables, cfg, np.zeros(tables.n_resources, np.float32))
    assert np.array_equal(ref[0], zero[0]) and np.array_equal(ref[1], zero[1])
    return [ref, zero]


def ext_excluded_from_accounting(P):
    topo = P.Topology(N, group_size=G)
    D = skew_demand()
    bg = P.mcf.solve_direct(topo, elephant_demand(512.0))
    priced = P.mcf.solve_mwu(topo, D, ext_loads=bg.resource_bytes)
    total = sum(sum(f.bytes for f in fl) for fl in priced.flows.values())
    assert total == pytest.approx(sum(D.values()), rel=1e-9)
    recharged = np.zeros(priced.rm.n_resources)
    for fl in priced.flows.values():
        for f in fl:
            for rid, eff in priced.rm.charges(f.path, f.bytes):
                recharged[rid] += eff
    assert np.allclose(recharged, priced.resource_bytes)
    return [priced]


def single_tenant_arbitrated(P):
    topo = P.Topology(N, group_size=G)
    D = skew_demand()
    arb = P.fab.FabricArbiter(topo)
    arb.register("solo")
    plans = arb.arbitrate({"solo": D})
    ref = P.mcf.solve_mwu(topo, D)
    assert norm(plans["solo"]) == norm(ref)
    assert arb.stats.solves == 1
    return [plans, arb.stats]


def single_tenant_runtime(P):
    topo = P.Topology(N, group_size=G)
    trace = jrt.drifting_skew_trace(N, 20, dwell=6)
    plain = P.Runtime(topo).run_trace(trace)
    arb = P.fab.FabricArbiter(topo)
    rt = P.Runtime(topo)
    arb.register_runtime("solo", rt)
    arbitrated = rt.run_trace(trace)
    assert plain.to_json_obj() == arbitrated.to_json_obj()
    assert arb.state.tenants() == ["solo"] and arb.stats.commits == len(trace)
    return [arbitrated, arb.to_json_obj(), arb.state.committed_load("solo")]


def ordering_deterministic(P):
    topo = P.Topology(N, group_size=G)
    demands = {"skew": skew_demand(), "ele": elephant_demand(256.0, rails=(1, 2))}

    def run(order):
        arb = P.fab.FabricArbiter(topo)
        for name in order:
            arb.register(name)
        return arb.arbitrate(demands), arb.stats

    p1, s1 = run(["skew", "ele"])
    p2, s2 = run(["ele", "skew"])
    assert norm(p1) == norm(p2)
    return [p1, s1]


def tenant_order(P):
    arb = P.fab.FabricArbiter(P.Topology(N, group_size=G))
    arb.register("zeta", P.fab.TenantConfig(qos="gold"))
    arb.register("alpha")
    arb.register("mid", P.fab.TenantConfig(qos="scavenger"))
    assert arb.tenant_order() == ["zeta", "alpha", "mid"]
    return [arb.tenant_order(), arb.tenant_order(["mid", "alpha"]),
            raised(lambda: arb.tenant_order(["nobody"])),
            raised(lambda: arb.register("alpha")),
            raised(lambda: P.fab.TenantConfig(weight=0.0)),
            raised(lambda: P.fab.TenantConfig(qos="platinum"))]


def token_bucket(P):
    bucket = P.fab.TokenBucket(P.fab.AdmissionConfig(burst=2, refill_per_window=0.5))
    out = [bucket.try_take(0), bucket.try_take(0), bucket.try_take(0),
           bucket.try_take(1), bucket.try_take(2), bucket.try_take(2),
           bucket.tokens(9)]
    assert out[:6] == [True, True, False, False, True, False]
    return out + [raised(lambda: P.fab.AdmissionConfig(burst=0)),
                  raised(lambda: P.fab.AdmissionConfig(refill_per_window=-1.0))]


def admission_bypasses(P):
    arb = P.fab.FabricArbiter(P.Topology(N, group_size=G))
    arb.register("only", P.fab.TenantConfig(admission=P.fab.AdmissionConfig(burst=1)))
    out = [arb.admit("only", w) for w in range(5)]
    assert all(d.reason == "solo" for d in out)
    arb.register("peer")
    out += [arb.admit("only", 10), arb.admit("only", 10),
            arb.admit("only", 10, reason="topology")]
    assert out[5].reason == "ok" and not out[6].admitted and out[7].admitted
    arb.register("vip", P.fab.TenantConfig(qos="gold",
                                           admission=P.fab.AdmissionConfig(burst=1)))
    out += [arb.admit("vip", w) for w in range(5)]
    assert all(d.reason == "qos" for d in out[-5:])
    return out + [arb.stats, raised(lambda: arb.admit("ghost", 0))]


def policy_gating_and_pressure(P):
    """The policy's gate re-arm and fabric-pressure clock cases."""
    out = []
    policy = P.rt.ReplanPolicy(P.rt.PolicyConfig(cooldown_windows=1))
    congested = lambda w: policy.decide(window=w, ratio=2.0, baseline_ratio=1.0,
                                        plan_age=w, pending=False, topology_event=False)
    first = congested(0)
    assert first.replan and first.reason == "congestion"
    policy.notify_gated()
    refires = [w for w in range(1, 6) if congested(w).replan]
    assert refires
    out += [first, refires]
    kw = dict(ratio=1.0, baseline_ratio=1.0, plan_age=0, pending=False)
    pol = P.rt.ReplanPolicy(P.rt.PolicyConfig(fabric_staleness=2))
    out.append(pol.decide(window=0, **kw))
    pol.notify_fabric_pressure(1)
    pol.notify_fabric_pressure(2)
    out += [pol.decide(window=2, **kw), pol.decide(window=3, **kw),
            pol.decide(window=4, **kw)]
    assert out[-2].reason == "fabric"
    pol.notify_fabric_pressure(5)
    pol.notify_swap()
    out.append(pol.decide(window=9, **kw))
    pol = P.rt.ReplanPolicy(P.rt.PolicyConfig(fabric_staleness=2))
    pol.notify_fabric_pressure(6)
    pol.notify_swap(solved_window=5)
    out.append(pol.decide(window=8, **kw))
    assert out[-1].reason == "fabric"
    pol.notify_fabric_pressure(6)
    pol.notify_swap(solved_window=7)
    out.append(pol.decide(window=20, **kw))
    pol = P.rt.ReplanPolicy()
    pol.notify_fabric_pressure(0)
    out.append(pol.decide(window=50, ratio=1.0, baseline_ratio=1.0, plan_age=50,
                          pending=False))
    assert not out[-1].replan
    return out


def runtime_gated_replans(P):
    topo = P.Topology(N, group_size=G)
    trace = jrt.drifting_skew_trace(N, 16, dwell=4)
    arb = P.fab.FabricArbiter(topo)
    rt = P.Runtime(topo, policy=P.rt.ReplanPolicy(
        P.rt.PolicyConfig(max_staleness=1, cooldown_windows=0)))
    arb.register_runtime("greedy", rt, P.fab.TenantConfig(
        admission=P.fab.AdmissionConfig(burst=1, refill_per_window=0.25)))
    arb.register("peer")
    res = rt.run_trace(trace)
    reasons = [r.replan_reason for r in res.reports]
    assert "gated" in reasons and arb.stats.throttled > 0
    for r in res.reports:
        if r.replan_reason == "gated":
            assert not r.replan_issued
            assert r.trigger_reason in ("congestion", "staleness", "fabric")
        elif not r.replan_issued:
            assert r.trigger_reason == "none"
        else:
            assert r.trigger_reason == r.replan_reason
    assert res.to_json_obj()["gated_windows"] == res.gated_windows
    return [res, arb.to_json_obj()]


def price_hints(P):
    topo = P.Topology(N, group_size=G)
    out = []
    for rel in (None, 0.0):
        cfg = None if rel is None else P.fab.ArbiterConfig(price_hint_rel=rel)
        arb = P.fab.FabricArbiter(topo, cfg=cfg)
        arb.register("a")
        seen = []
        arb.bus.subscribe(lambda evs: seen.extend(evs))
        bg = elephant(P, topo, 256.0)
        arb.commit("a", bg.resource_bytes)     # solo: never hints
        arb.register("b")
        arb.commit("b", bg.resource_bytes)
        arb.commit("b", bg.resource_bytes * 1.01)
        arb.commit("b", bg.resource_bytes * 3.0)
        out += [seen, arb.stats]
    assert len(out[0]) == 2 and out[0][0].tenant == "b" and out[2] == []
    return out


def withdrawal_hint(P):
    topo = P.Topology(N, group_size=G)
    arb = P.fab.FabricArbiter(topo)
    arb.register("a")
    arb.register("b")
    bg = elephant(P, topo, 256.0)
    arb.commit("a", bg.resource_bytes)
    arb.commit("b", bg.resource_bytes)
    seen = []
    arb.bus.subscribe(lambda evs: seen.extend(evs))
    arb.unregister("b")
    hints = [e for e in seen if isinstance(e, P.rt.PricesMovedHint)]
    assert len(hints) == 1 and hints[0].tenant == "b"
    return [seen, arb.stats]


def stable_tenant_fabric_shift(P):
    topo = P.Topology(N, group_size=G)
    trace = jrt.balanced_trace(N, 10)
    arb = P.fab.FabricArbiter(topo)
    rt = P.Runtime(topo, policy=P.rt.ReplanPolicy(P.rt.PolicyConfig(fabric_staleness=2)))
    arb.register_runtime("stable", rt)
    arb.register("peer")
    reports = []
    for w in range(10):
        if w == 3:
            arb.commit("peer", elephant(P, topo, 512.0).resource_bytes)
        reports.append(rt.step(trace[w]))
    reasons = [r.replan_reason for r in reports]
    fired = reasons.index("fabric")
    assert fired >= 5 and all(r == "none" for r in reasons[:3])
    assert any(r.swapped for r in reports[fired + 1:])
    return [reports, rt.stats, rt.active_plan]


def broadcast_and_unregister(P):
    topo = P.Topology(N, group_size=G)
    trace = jrt.drifting_skew_trace(N, 8, dwell=4)
    arb = P.fab.FabricArbiter(topo)
    rt_a, rt_b = P.Runtime(topo), P.Runtime(topo)
    arb.register_runtime("a", rt_a)
    arb.register_runtime("b", rt_b)
    listeners = arb.broadcast(P.rt.link_down(3, 0, G))
    assert listeners == 2 and arb.state.fingerprint != topo.fingerprint
    res_a, res_b = rt_a.run_trace(trace), rt_b.run_trace(trace)
    for res in (res_a, res_b):
        assert res.reports[3].replan_reason == "topology"
    assert rt_a.topo.fingerprint == rt_b.topo.fingerprint == arb.state.fingerprint
    out = [listeners, res_a, res_b, arb.to_json_obj()]
    # unregister detaches: ledger, bus, and the runtime's event feed
    arb.register("c")
    arb.commit("a", np.ones(arb.state.n_resources))
    arb.unregister("a")
    arb.unregister("a")                      # idempotent
    arb.unregister("ghost")
    assert arb.tenants() == ["b", "c"] and len(arb.bus) == 1
    arb.broadcast(P.rt.link_down(9, 1, G + 1))
    assert len(rt_a.events) == 0 and len(rt_b.events) == 1
    return out + [arb.tenants(), arb.state.tenants(), len(arb.bus), arb.stats]


def event_bus(P):
    bus = P.Bus()
    seen = []
    t1 = bus.subscribe(lambda evs: seen.append(("one", len(evs))))
    bus.subscribe(lambda evs: seen.append(("two", len(evs))))
    out = [bus.publish([1, 2]), len(bus)]
    bus.unsubscribe(t1)
    bus.unsubscribe(t1)
    out += [bus.publish([3]), len(bus), seen]
    assert seen == [("one", 2), ("two", 2), ("two", 1)]
    return out


def fairness_metrics(P):
    f = P.fab
    out = [f.jains_index([]), f.jains_index([3.0, 3.0, 3.0]),
           f.jains_index([1.0, 0.0, 0.0, 0.0]), f.jains_index([0.0, 0.0]),
           f.jains_index([0.3, 1.7, 2.9]),
           raised(lambda: f.jains_index([-1.0, 1.0])),
           f.maxmin_violation([]), f.maxmin_violation([2.0]),
           f.maxmin_violation([2.0, 2.0]), f.maxmin_violation([4.0, 2.0]),
           f.maxmin_violation([0.0, 0.0]),
           f.weighted_drains({"a": 1.5, "b": 2.0}, {"a": 2.0})]
    assert out[2] == pytest.approx(0.25) and out[9] == pytest.approx(0.5)
    return out


def fairness_report_schema(P):
    topo = P.Topology(N, group_size=G)
    arb = P.fab.FabricArbiter(topo)
    arb.register("a", P.fab.TenantConfig(weight=2.0))
    arb.register("b")
    plans = arb.arbitrate({"a": skew_demand(), "b": elephant_demand()})
    rep = arb.fairness_report()
    assert P.schema_kind(rep) == "fabric_fairness"
    assert set(rep["tenants"]) == {"a", "b"} and rep["weights"]["a"] == 2.0
    assert 0.0 < rep["jain_index"] <= 1.0 and 0.0 <= rep["maxmin_violation"] <= 1.0
    assert P.schema_kind(arb.to_json_obj()) == "fabric_arbiter"
    assert P.schema_kind(arb.state.to_json_obj()) == "fabric_state"
    return [plans, arb.to_json_obj(), arb.state.summary(), arb.weights()]


def state_link_overrides(P):
    topo = P.Topology(N, group_size=G)
    state = P.fab.FabricState(topo)
    loads = np.ones(state.n_resources)
    state.commit("a", loads)
    before = state.drain_time_s(loads)
    fp = state.apply_link_overrides({(0, G): 0.5})
    assert fp != topo.fingerprint and state.drain_time_s(loads) > before
    state.withdraw("ghost")
    return [fp, before, state.drain_time_s(loads), state.committed_load("a"),
            state.to_json_obj(), state.total_load(), state.drain_times()]


def arbitrated_beats_independent(P):
    topo = P.Topology(N, group_size=G)
    D = skew_demand()
    bg = elephant(P, topo, 128.0)
    ind = P.mcf.solve_mwu(topo, D)
    ind_combined = float(np.max((ind.resource_bytes + bg.resource_bytes)
                                / ind.rm.capacity))
    arb = P.fab.FabricArbiter(topo)
    arb.register("skew")
    arb.register("bg")
    arb.commit("bg", bg.resource_bytes)
    plan = P.mcf.solve_mwu(topo, D, ext_loads=arb.prices_for("skew"))
    arb.commit("skew", plan.resource_bytes)
    fairness = arb.fairness_report()
    assert arb.combined_drain_s() < ind_combined and fairness["jain_index"] >= 0.9
    return [ind_combined, plan, arb.combined_drain_s(), fairness]


def eviction(P):
    topo = P.Topology(N, group_size=G)
    arb = P.fab.FabricArbiter(topo, cfg=P.fab.ArbiterConfig(evict_staleness=3.0))
    arb.register("a")
    arb.register("b")
    loads = np.full(arb.state.rm.n_resources, float(MB))
    arb.commit("a", loads, window=0)
    arb.commit("b", loads, window=0)
    for w in range(1, 5):
        arb.commit("a", loads, window=w)
    assert arb.stats.evictions == 1 and arb.tenants() == ["a"]
    arb.unregister("b")
    off = P.fab.FabricArbiter(topo)
    off.register("a")
    off.register("b")
    off.commit("b", np.ones(len(loads)), window=0)
    for w in range(1, 50):
        off.commit("a", np.ones(len(loads)), window=w)
    assert off.tenants() == ["a", "b"] and off.stats.evictions == 0
    return [arb.stats, arb.tenants(), arb.state.committed_load("b"), off.stats,
            off.state.to_json_obj()]


# -- scenarios: test_price_recency.py ---------------------------------------------

def stamps_and_clock(P):
    state = P.fab.FabricState(P.Topology(N, group_size=G))
    loads = np.ones(state.n_resources)
    out = []
    state.commit("host", loads)
    state.commit("rt", loads, window=3)
    out += [state.clock, state.staleness("host"), state.staleness("rt")]
    state.commit("rt2", loads, window=7)
    out += [state.clock, state.staleness("rt")]
    state.commit("rt", loads, window=5)
    out += [state.clock, state.staleness("rt")]
    state.withdraw("rt")
    out += [state.staleness("rt"), state.summary()]
    assert out[:7] == [3, None, 0.0, 7, 4.0, 7, 2.0]
    return out


def decay_factors(P):
    state = P.fab.FabricState(P.Topology(N, group_size=G))
    loads = np.ones(state.n_resources)
    state.commit("host", loads)
    state.commit("stale", loads, window=0)
    state.commit("fresh", loads, window=4)
    out = [state.decay_factor("stale", 4.0), state.decay_factor("stale", 2.0),
           state.decay_factor("stale", 3.0), state.decay_factor("fresh", 2.0),
           state.decay_factor("host", 2.0), state.decay_factor("missing", 2.0),
           state.decay_factor("stale", None), state.decay_factor("stale", 0.0)]
    assert out[0] == pytest.approx(0.5) and out[1] == pytest.approx(0.25)
    assert out[3:] == [1.0] * 5
    return out


def external_load_decay_none(P):
    rng = np.random.default_rng(0)
    state = P.fab.FabricState(P.Topology(N, group_size=G))
    for i, t in enumerate(("a", "b", "c", "d", "e")):
        state.commit(t, rng.uniform(0.0, 1e9, state.n_resources), window=i)
    raw = state.external_load("a")
    assert np.array_equal(raw, np.maximum(state.total_load()
                                          - state.committed_load("a"), 0.0))
    state2 = P.fab.FabricState(P.Topology(N, group_size=G))
    for t in ("a", "b", "c"):
        state2.commit(t, state.committed_load(t))
    decayed = state2.external_load("a", half_life=2.0)
    assert np.array_equal(decayed, state2.committed_load("b") + state2.committed_load("c"))
    # four peers at four stalenesses: the sum's order shows in the last bits
    return [raw, decayed] + [state.external_load(t, half_life=h)
                             for t in ("a", "b", "c", "e") for h in (1.5, 0.5, 4.0)]


def prices_for_decay(P):
    topo = P.Topology(N, group_size=G)
    bg = elephant(P, topo).resource_bytes
    out = []
    for decay in (2.0, None):
        arb = P.fab.FabricArbiter(topo, cfg=P.fab.ArbiterConfig(price_decay=decay))
        arb.register("me")
        arb.register("peer", P.fab.TenantConfig(weight=3.0))
        arb.commit("peer", bg, window=0)
        arb.commit("me", np.zeros(arb.state.n_resources), window=4)
        out += [arb.prices_for("me"), arb.prices_for("peer")]
    assert np.allclose(out[0], 0.25 * bg) and np.array_equal(out[2], bg)
    return out


def skew_vs_elephant_decay_none(P):
    topo = P.Topology(N, group_size=G)
    D = skew_demand()
    bg = elephant(P, topo)
    ref_arb = P.fab.FabricArbiter(topo)
    ref_arb.register("skew")
    ref_arb.register("bg")
    ref_arb.commit("bg", bg.resource_bytes)
    ref = P.mcf.solve_mwu(topo, D, ext_loads=ref_arb.prices_for("skew"))
    ref_arb.commit("skew", ref.resource_bytes)
    spec = P.Spec(topology=topo, adaptivity="arbitrated", tenant="skew",
                  price_decay=None, fabric_staleness=None)
    with P.Session(spec) as sess:
        sess.join_static_tenant("bg", bg)
        got = sess.plan(D)
        got_combined = sess.fabric.combined_drain_s()
    assert norm(got) == norm(ref) and got_combined == ref_arb.combined_drain_s()
    with P.Session(P.Spec(topology=topo, adaptivity="arbitrated", tenant="skew")) as sess:
        sess.join_static_tenant("bg", bg)
        default = sess.plan(D)
    assert np.array_equal(default.resource_bytes, ref.resource_bytes)
    return [ref, got_combined, default]


def reprice_semantics(P):
    topo = P.Topology(N, group_size=G)
    bg = elephant(P, topo).resource_bytes
    arb = P.fab.FabricArbiter(topo)
    arb.register("me")
    arb.register("peer")
    out = [arb.reprice("me", None)]
    arb.commit("peer", bg)
    out += [arb.reprice("me", None), arb.reprice("me", bg.copy())]
    arb.commit("peer", bg * 1.05)
    out.append(arb.reprice("me", bg.copy()))
    arb.state.withdraw("peer")
    out.append(arb.reprice("me", bg.copy()))
    assert [d.moved for d in out] == [False, True, False, False, True]
    assert arb.stats.reprices == 2
    off = P.fab.FabricArbiter(topo, cfg=P.fab.ArbiterConfig(price_hint_rel=0.0))
    off.register("me")
    off.register("peer")
    off.commit("peer", bg)
    out.append(off.reprice("me", None))
    assert not out[-1].moved and off.stats.reprices == 0
    return out + [arb.stats, off.stats]


def swap_boundary_reprice(P):
    topo = P.Topology(N, group_size=G)
    trace = jrt.balanced_trace(N, 10)
    arb = P.fab.FabricArbiter(topo)
    rt = P.Runtime(topo, policy=P.rt.ReplanPolicy(
        P.rt.PolicyConfig(max_staleness=3, cooldown_windows=0)))
    arb.register_runtime("t", rt)
    arb.register("peer")
    reports = [rt.step(trace[w]) for w in range(4)]
    assert reports[-1].replan_issued and reports[-1].replan_reason == "staleness"
    arb.commit("peer", elephant(P, topo, mb=512.0).resource_bytes)
    reports.append(rt.step(trace[4]))
    assert reports[-1].swapped and rt.stats.reprices == 1 and arb.stats.reprices == 1
    reports.append(rt.step(trace[5]))
    assert reports[-1].swapped and reports[-1].plan_source == "reprice"
    assert rt.stats.reprices == 1 and rt.stats.replans == 1
    return [reports, rt.stats, arb.stats, rt.active_plan]


def reprice_skipped_when_stable(P):
    topo = P.Topology(N, group_size=G)
    trace = jrt.balanced_trace(N, 8)
    pol = lambda: P.rt.ReplanPolicy(P.rt.PolicyConfig(max_staleness=3, cooldown_windows=0))
    plain = P.Runtime(topo, policy=pol())
    arb = P.fab.FabricArbiter(topo)
    rt = P.Runtime(topo, policy=pol())
    arb.register_runtime("t", rt)
    arb.register("peer")
    arb.commit("peer", elephant(P, topo).resource_bytes)
    res = rt.run_trace(trace)
    ref = plain.run_trace(trace)
    assert rt.stats.reprices == 0 and arb.stats.reprices == 0
    assert [r.replan_issued for r in res.reports] == [r.replan_issued for r in ref.reports]
    assert [r.swapped for r in res.reports] == [r.swapped for r in ref.reports]
    return [res, ref]


def commit_fingerprints(P):
    topo = P.Topology(N, group_size=G)
    other = P.Topology(N, group_size=2)
    state = P.fab.FabricState(topo)
    out = [raised(lambda: state.commit("t", np.ones(state.n_resources),
                                       fingerprint=other.fingerprint)),
           raised(lambda: state.commit("t", np.ones(3)))]
    assert str(other.fingerprint) in str(out[0]) and "t" in str(out[0])
    state.apply_link_overrides({(0, G): 0.5})
    state.commit("t", np.ones(state.n_resources), window=1, fingerprint=topo.fingerprint)
    assert state.tenants() == ["t"]
    arb = P.fab.FabricArbiter(topo)
    arb.register("t")
    out.append(raised(lambda: arb.commit("t", np.ones(arb.state.n_resources),
                                         fingerprint=other.fingerprint)))
    assert arb.stats.commits == 0
    return out + [state.to_json_obj()]


def late_joiner(P):
    topo = P.Topology(N, group_size=G)
    trace = jrt.balanced_trace(N, 60)
    with P.Session(P.Spec(topology=topo, adaptivity="arbitrated", tenant="a")) as sa:
        for w in range(50):
            sa.step(trace[w])
        assert sa.fabric.state.clock == 49
        spec_b = P.Spec(topology=topo, adaptivity="arbitrated", tenant="b",
                        fabric=sa.fabric)
        with P.Session(spec_b) as sb:
            rep = sb.step(trace[50])
            assert sa.fabric.state.staleness("b") == 0.0
            assert sa.fabric.state.decay_factor("b", sa.fabric.cfg.price_decay) == 1.0
            committed = sa.fabric.state.committed_load("b")
            assert np.array_equal(sa.fabric.prices_for("a"), committed)
            return [rep, committed, sb.runtime._fabric_window_offset,
                    sa.fabric.to_json_obj()]


def runtime_export_stamps(P):
    topo = P.Topology(N, group_size=G)
    trace = jrt.balanced_trace(N, 3)
    arb = P.fab.FabricArbiter(topo)
    rt = P.Runtime(topo)
    arb.register_runtime("t", rt)
    out = []
    for w in range(3):
        rt.step(trace[w])
        out += [arb.state.staleness("t"), arb.state.clock]
    assert out == [0.0, 0, 0.0, 1, 0.0, 2] and arb.stats.commits == 3
    # observe_dispatch exports too, stamped in fabric windows
    rt.observe_dispatch(jrt.drifting_skew_trace(N, 2, dwell=1, seed=4))
    return out + [arb.state.clock, arb.state.committed_load("t"), arb.stats]


def unregister_hints(P):
    topo = P.Topology(N, group_size=G)
    out = []
    arb = P.fab.FabricArbiter(topo)
    rt = P.Runtime(topo)
    arb.register_runtime("solo", rt)
    arb.commit("solo", np.ones(arb.state.n_resources))
    before = arb.stats.price_hints
    arb.unregister("solo")
    assert arb.stats.price_hints == before and len(arb.bus) == 0
    out.append(arb.stats)
    arb = P.fab.FabricArbiter(topo)
    pol = lambda: P.rt.ReplanPolicy(P.rt.PolicyConfig(fabric_staleness=1))
    leaving, staying = P.Runtime(topo, policy=pol()), P.Runtime(topo, policy=pol())
    arb.register_runtime("leaving", leaving)
    arb.register_runtime("staying", staying)
    loads = np.ones(arb.state.n_resources)
    arb.commit("leaving", loads)
    arb.commit("staying", loads)
    leaving.policy._pressure_window = None
    staying.policy._pressure_window = None
    before = arb.stats.price_hints
    arb.unregister("leaving")
    assert arb.stats.price_hints == before + 1
    assert staying.policy._pressure_window is not None
    assert leaving.policy._pressure_window is None
    out.append(arb.stats)
    arb = P.fab.FabricArbiter(topo)
    arb.register("a")
    arb.register("b")
    arb.commit("a", loads)
    arb.commit("b", loads)
    seen = []
    arb.bus.subscribe(lambda evs: seen.extend(evs))
    arb.commit("b", 1.05 * loads)
    hints = [e for e in seen if isinstance(e, P.rt.PricesMovedHint)]
    assert len(hints) == 1 and hints[0].rel_change > 0.5
    return out + [seen]


SCENARIOS = {f.__name__: f for f in (
    prices_monotone, negative_commit_rejected, ext_zero_host, ext_zero_planner,
    ext_excluded_from_accounting, single_tenant_arbitrated, single_tenant_runtime,
    ordering_deterministic, tenant_order, token_bucket, admission_bypasses,
    policy_gating_and_pressure, runtime_gated_replans, price_hints, withdrawal_hint,
    stable_tenant_fabric_shift, broadcast_and_unregister, event_bus, fairness_metrics,
    fairness_report_schema, state_link_overrides, arbitrated_beats_independent,
    eviction, stamps_and_clock, decay_factors, external_load_decay_none,
    prices_for_decay, skew_vs_elephant_decay_none, reprice_semantics,
    swap_boundary_reprice, reprice_skipped_when_stable, commit_fingerprints,
    late_joiner, runtime_export_stamps, unregister_hints,
)}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_scenario_equals_reference(case):
    got = norm(SCENARIOS[case](PORT))
    want = norm(SCENARIOS[case](JAX))
    assert got == want


@settings(max_examples=10, deadline=None)
@given(st.floats(0.5, 16.0), st.integers(1, 6))
def test_decayed_prices_monotone_in_staleness_equal_reference(half_life, steps):
    """The reference's property, on both packages: a peer's decayed price is
    monotone non-increasing in staleness, and the port's equals JAX's."""
    rng = np.random.default_rng(42)
    peer_load = rng.uniform(0.0, 1e9, 100)
    seq = {}
    for name, P in (("port", PORT), ("jax", JAX)):
        state = P.fab.FabricState(P.Topology(N, group_size=G))
        peer = peer_load[:state.n_resources]
        state.commit("peer", peer, window=0)
        state.commit("me", np.zeros(state.n_resources), window=0)
        prev = state.external_load("me", half_life=half_life)
        assert np.array_equal(prev, peer)
        out = [prev]
        for k in range(1, steps + 1):
            state.commit("me", np.zeros(state.n_resources), window=k)
            cur = state.external_load("me", half_life=half_life)
            assert (cur <= prev + 1e-9).all()
            assert (cur[peer > 0] < prev[peer > 0]).all()
            out.append(cur)
            prev = cur
        seq[name] = norm(out)
    assert seq["port"] == seq["jax"]

