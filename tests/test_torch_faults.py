"""Port fault harness against the JAX package's: the same observations.

Every case of the reference's ``tests/test_faults.py`` (its arbiter eviction
cases aside, which ``test_torch_fabric.py`` holds) is written once as a
scenario over a package namespace and run on both packages; the port's
runtimes solve on the CPU (``device="cpu"``).  A scenario returns what it
observed — schedules and their digests, events, masks, estimator and
policy states, window reports, plans — and the two packages' observations
must be equal, floats to the last bit.  The reference's own assertions run
inside each scenario, on both packages.  Then ``launch/drills.py``'s four
fault sections against the reference's ``benchmarks/bench_faults.py``:
every figure, and every ``DrillResult``, equal.
"""

import copy
import os
import sys
import types

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from hypothesis_compat import given, settings, st

import repro.core as jcore
import repro.fabric as jfab
import repro.faults as jfaults
import repro.runtime as jrt
from repro.core.topology import DOWN_CAP as JDOWN_CAP, Topology as JTopology
from repro.runtime.events import merge_overrides as jmerge
from repro_torch import core as tcore
from repro_torch import fabric as tfab
from repro_torch import faults as tfaults
from repro_torch import runtime as trt
from repro_torch.core.topology import DOWN_CAP as TDOWN_CAP, Topology as TTopology
from repro_torch.launch import drills
from repro_torch.runtime.events import merge_overrides as tmerge

from test_torch_fabric import norm, raised

pytestmark = pytest.mark.torch_port

ROOT = os.path.join(os.path.dirname(__file__), "..")
MB = 1 << 20
N = 8
G = 4

JAX = types.SimpleNamespace(
    core=jcore, fab=jfab, f=jfaults, rt=jrt, Topology=JTopology, merge=jmerge,
    DOWN_CAP=JDOWN_CAP, Runtime=jrt.OrchestrationRuntime)
PORT = types.SimpleNamespace(
    core=tcore, fab=tfab, f=tfaults, rt=trt, Topology=TTopology, merge=tmerge,
    DOWN_CAP=TDOWN_CAP,
    Runtime=lambda topo, **kw: trt.OrchestrationRuntime(topo, device="cpu", **kw))


def _pair(scenario):
    got, want = norm(scenario(PORT)), norm(scenario(JAX))
    assert got == want
    return got


def schedule_obs(sched):
    """Everything a compiled schedule holds, in a comparable form."""
    return [sched.digest(), sched.to_json_obj(), sched.events, sched.n_devices,
            sorted(sched.blackout_prob.items()),
            sorted(sched.dropout_masks.items()),
            sorted(sched.straggler_scale.items()),
            sorted(sched.elephant_bytes.items()),
            sorted(sched.crash_windows.items()), sched.horizon]


# -- injector determinism ----------------------------------------------------------

def _scenario(P, seed, start, cycles, jitter, drop):
    f = P.f
    return f.FaultScenario(
        name="prop",
        seed=seed,
        flaps=(f.LinkFlapSpec(0, G, start=start, cycles=cycles,
                              down_windows=2, up_windows=2, jitter=jitter),),
        blackouts=(f.TelemetryBlackoutSpec(start=start + 1, duration=4,
                                           drop_prob=drop),),
        stragglers=(f.StragglerSpec(start=start, duration=3, inflation=2.5),),
        elephants=(f.ElephantFlowSpec(1, G + 1, start=start, duration=6,
                                      bytes_per_window=64 * MB, jitter=0.3),),
        crashes=(f.TenantCrashSpec("B", window=start + 5),),
    )


@settings(max_examples=20, deadline=None)
@given(
    st.integers(0, 2**16),
    st.integers(0, 8),
    st.integers(1, 4),
    st.floats(0.0, 0.8),
    st.floats(0.1, 0.9),
)
def test_same_seed_same_schedule_equals_reference(seed, start, cycles, jitter, drop):
    """Two injectors, same (seed, spec, topo) -> bit-identical digests, on
    both packages, and the port's schedule is the reference's byte for byte."""
    def scenario(P):
        t = P.Topology(N, group_size=G)
        spec = _scenario(P, seed, start, cycles, jitter, drop)
        a = P.f.FaultInjector(t).compile(spec)
        b = P.f.FaultInjector(t).compile(spec)
        assert a.digest() == b.digest()
        assert a.events == b.events
        for w, mask in a.dropout_masks.items():
            assert mask.dtype == np.bool_ and np.array_equal(mask, b.dropout_masks[w])
        for mat in a.elephant_bytes.values():
            assert mat.dtype == np.float64 and mat.shape == (N, N)
        windows = [ev.window for ev in a.events]
        assert windows == sorted(windows)
        prev_restore = None
        for dn, up in zip(a.events[::2], a.events[1::2]):
            assert dn.scale == 0.0 and up.scale == 1.0
            assert up.window == dn.window + spec.flaps[0].down_windows
            if prev_restore is not None:
                assert dn.window >= prev_restore
            prev_restore = up.window
        return schedule_obs(a)

    _pair(scenario)


def different_seed_different_masks(P):
    topo = P.Topology(N, group_size=G)
    a = P.f.FaultInjector(topo).compile(_scenario(P, 1, 4, 2, 0.5, 0.5))
    b = P.f.FaultInjector(topo).compile(_scenario(P, 2, 4, 2, 0.5, 0.5))
    assert a.digest() != b.digest()
    return [schedule_obs(a), schedule_obs(b)]


def injector_validates_topology(P):
    f = P.f
    inj = f.FaultInjector(P.Topology(N, group_size=G))
    return [
        raised(lambda: inj.compile(f.FaultScenario(
            name="bad", flaps=(f.LinkFlapSpec(0, N + 3, start=0),)))),
        raised(lambda: inj.compile(f.FaultScenario(
            name="bad", rail_losses=(f.RailLossSpec(device=N + 1, start=0),)))),
    ]


def spec_validation(P):
    """Every spec's own validation (the reference's ``__post_init__``s)."""
    f = P.f
    return [
        raised(lambda: f.LinkFlapSpec(0, G, start=0, cycles=0)),
        raised(lambda: f.LinkFlapSpec(0, G, start=0, down_windows=0)),
        raised(lambda: f.LinkFlapSpec(0, G, start=0, jitter=1.0)),
        raised(lambda: f.RailLossSpec(device=0, start=4, restore=4)),
        raised(lambda: f.TelemetryBlackoutSpec(start=0, duration=0)),
        raised(lambda: f.TelemetryBlackoutSpec(start=0, duration=2, drop_prob=0.0)),
        raised(lambda: f.StragglerSpec(start=0, duration=0)),
        raised(lambda: f.StragglerSpec(start=0, duration=2, inflation=0.5)),
        raised(lambda: f.ElephantFlowSpec(0, G, 0, 0, 1.0)),
        raised(lambda: f.ElephantFlowSpec(0, G, 0, 2, 0.0)),
        raised(lambda: f.ElephantFlowSpec(0, G, 0, 2, 1.0, jitter=-0.1)),
        raised(lambda: f.FaultInjector(P.Topology(N, group_size=G)).compile(
            f.FaultScenario(name="bad", crashes=[f.TenantCrashSpec("", 3)]))),
        f.LinkFlapSpec(0, G, start=2, cycles=3).end_window,
        f.FaultScenario(name="lists", flaps=[f.LinkFlapSpec(0, G, start=1)]).flaps,
    ]


def rail_loss_fans_out_to_nic_links(P):
    topo = P.Topology(N, group_size=G)
    sched = P.f.FaultInjector(topo).compile(P.f.FaultScenario(
        name="rail",
        rail_losses=(P.f.RailLossSpec(device=0, start=3, restore=7),),
    ))
    downs = [ev for ev in sched.events if ev.scale == 0.0]
    ups = [ev for ev in sched.events if ev.scale == 1.0]
    assert len(downs) == len(ups) >= 1
    assert all(ev.window == 3 and 0 in (ev.src, ev.dst) for ev in downs)
    assert all(ev.window == 7 for ev in ups)
    permanent = P.f.FaultInjector(topo).compile(P.f.FaultScenario(
        name="rail", rail_losses=(P.f.RailLossSpec(device=5, start=2),)))
    return [schedule_obs(sched), schedule_obs(permanent)]


# -- EventLog flap sequences -------------------------------------------------------

def down_then_restore_same_window_restore_wins(P):
    log = P.rt.EventLog([P.rt.link_down(3, 0, G), P.rt.link_restored(3, 0, G)])
    due = log.pop_due(3)
    assert [ev.scale for ev in due] == [0.0, 1.0]
    assert P.merge(due) == [((0, G), 1.0)]
    return [due, P.merge(due)]


def restore_scheduled_before_down_down_wins(P):
    log = P.rt.EventLog()
    log.schedule(P.rt.link_restored(3, 0, G))
    log.schedule(P.rt.link_down(3, 0, G))
    merged = P.merge(log.pop_due(3))
    assert merged == [((0, G), 0.0)]
    return merged


def duplicate_downs_collapse(P):
    log = P.rt.EventLog([P.rt.link_down(2, 0, G), P.rt.link_down(2, 0, G)])
    merged = P.merge(log.pop_due(2))
    assert merged == [((0, G), 0.0)]
    return merged


def pop_due_orders_across_windows(P):
    log = P.rt.EventLog([P.rt.link_restored(5, 0, G), P.rt.link_down(2, 0, G)])
    due = log.pop_due(10)
    assert [ev.window for ev in due] == [2, 5]
    return due


def runtime_same_window_flap_leaves_fabric_healthy(P):
    topo = P.Topology(N, group_size=G)
    log = P.rt.EventLog([P.rt.link_down(1, 0, G), P.rt.link_restored(1, 0, G)])
    rt = P.Runtime(topo, events=log)
    reports = [rt.step(d) for d in P.rt.balanced_trace(N, 4)]
    assert rt.topo.down_link_ids() == []
    return [reports, rt.stats, rt.topo.fingerprint]


# -- telemetry guard ---------------------------------------------------------------

def record_loads_rejects_poison(P):
    cap = P.core.ResourceModel(P.Topology(N, group_size=G)).capacity
    tel = P.rt.LinkTelemetry(cap)
    good = cap * 1e-3
    tel.record_loads(0, good)
    assert len(tel) == 1
    for w, (i, bad) in enumerate([(0, np.nan), (0, -1.0), (0, np.inf)], start=1):
        loads = good.copy()
        loads[i] = bad
        tel.record_loads(w, loads)
    assert len(tel) == 1 and tel.rejected == 3
    agg = tel.aggregate()
    assert agg["rejected_records"] == 3
    assert np.isfinite(tel.mean_util()).all()
    err = raised(lambda: tel.record_loads(4, good[:-1]))
    assert tel.rejected == 3
    return [agg, tel.mean_util(), tel.to_json_obj(), err]


# -- estimator degraded mode -------------------------------------------------------

def estimator_blackout_serves_last_good(P):
    est = P.rt.DemandEstimator(4)
    d = np.zeros((4, 4))
    d[0, 1] = 100 * MB
    est.update(d)
    est.update(d)
    before = est.predict().copy()
    assert est.confidence == 1.0
    out = [before]
    est.update(None)
    assert np.array_equal(est.predict(), before)
    assert est.confidence == pytest.approx(0.5) and est.missing_windows == 1
    out += [est.confidence, est.predict()]
    est.update(None)
    assert est.confidence == pytest.approx(0.25)
    out.append(est.confidence)
    est.update(d)
    assert est.confidence == 1.0 and np.isfinite(est.predict()).all()
    return out + [est.confidence, est.missing_windows, est.predict()]


def estimator_partial_dropout_backfills(P):
    est = P.rt.DemandEstimator(4)
    d = np.full((4, 4), 10.0 * MB)
    np.fill_diagonal(d, 0.0)
    est.update(d)
    obs = d.copy()
    obs[0, 1] = np.nan
    est.update(obs)
    assert np.isfinite(est.predict()).all()
    assert 0.5 < est.confidence < 1.0
    return [est.predict(), est.confidence, est.missing_windows]


# -- policy flap backoff -----------------------------------------------------------

def _topo_decide(pol, w, event=True):
    return pol.decide(window=w, ratio=1.0, baseline_ratio=1.0,
                      plan_age=0, pending=False, topology_event=event)


def flap_backoff_suppresses_storm(P):
    pol = P.rt.ReplanPolicy(P.rt.PolicyConfig())
    decisions = [_topo_decide(pol, w) for w in range(8)]
    assert [d.reason for d in decisions] == [
        "topology", "topology", "backoff", "topology",
        "backoff", "backoff", "backoff", "topology"]
    return decisions


def flap_backoff_deferred_catchup_fires_once(P):
    pol = P.rt.ReplanPolicy(P.rt.PolicyConfig())
    out = [_topo_decide(pol, 0), _topo_decide(pol, 1), _topo_decide(pol, 2),
           _topo_decide(pol, 3, event=False), _topo_decide(pol, 4, event=False)]
    assert out[0].replan and out[1].replan and out[2].reason == "backoff"
    assert out[3].replan and out[3].reason == "topology"
    assert not out[4].replan
    return out


def flap_backoff_quiet_period_resets_level(P):
    cfg = P.rt.PolicyConfig()
    pol = P.rt.ReplanPolicy(cfg)
    out = [_topo_decide(pol, w) for w in range(4)]
    quiet = 3 + cfg.flap_reset_windows + 1
    out += [_topo_decide(pol, quiet), _topo_decide(pol, quiet + 1)]
    assert out[-2].reason == "topology" and out[-1].reason == "topology"
    return out


def flap_backoff_disabled_fires_every_event(P):
    pol = P.rt.ReplanPolicy(P.rt.PolicyConfig(flap_backoff_base=0))
    out = [_topo_decide(pol, w) for w in range(6)]
    assert all(d.reason == "topology" for d in out)
    return out


# -- runtime watchdog --------------------------------------------------------------

def watchdog_abandons_stuck_pending(P):
    rt = P.Runtime(
        P.Topology(N, group_size=G),
        cfg=P.rt.RuntimeConfig(solve_delay_windows=12, pending_deadline_windows=4),
        events=P.rt.EventLog([P.rt.link_down(2, 0, G)]),
    )
    reports = [rt.step(d) for d in P.rt.balanced_trace(N, 24)]
    assert rt.stats.watchdog_abandons == 1
    assert any(r.plan_source == "watchdog" and r.swapped for r in reports)
    assert all(np.isfinite(r.completion_s) for r in reports)
    return [reports, rt.stats, rt.active_plan]


def watchdog_disabled_never_fires(P):
    rt = P.Runtime(
        P.Topology(N, group_size=G),
        cfg=P.rt.RuntimeConfig(solve_delay_windows=12, pending_deadline_windows=None),
        events=P.rt.EventLog([P.rt.link_down(2, 0, G)]),
    )
    reports = [rt.step(d) for d in P.rt.balanced_trace(N, 24)]
    assert rt.stats.watchdog_abandons == 0
    return [reports, rt.stats]


# -- planner degraded mode ---------------------------------------------------------

def sweep_solver_avoids_down_link(P):
    down = P.Topology(N, group_size=G).with_link_scale({(0, G): 0.0})
    lid = down.link_id(0, G)
    assert lid in down.down_link_ids()
    plan = P.core.solve_mwu(down, {(0, G): 256 * MB}, refresh="sweep")
    assert not plan.degraded and plan.link_bytes[lid] == 0.0
    assert plan.per_pair_bytes()[(0, G)] == pytest.approx(256 * MB, rel=1e-9)
    return [plan, plan.per_pair_bytes(), P.DOWN_CAP]


def healthy_solve_not_degraded(P):
    plan = P.core.solve_mwu(P.Topology(N, group_size=G),
                            {(0, G): 64 * MB, (1, G + 1): 64 * MB})
    assert not plan.degraded
    return plan


def solve_degraded_routes_everything(P):
    down = P.Topology(N, group_size=G).with_link_scale({(0, G): 0.0, (1, G + 1): 0.0})
    demands = {(0, G): 128 * MB, (1, G + 1): 64 * MB, (2, G + 2): 32 * MB}
    plan = P.core.solve_degraded(down, demands)
    assert plan.degraded
    routed = plan.per_pair_bytes()
    for key, d in demands.items():
        assert routed[key] == pytest.approx(d, rel=1e-9)
    for lid in down.down_link_ids():
        assert plan.link_bytes[lid] == 0.0
    return [plan, routed]


# -- fabric teardown ---------------------------------------------------------------

def withdraw_unknown_tenant_is_noop(P):
    state = P.fab.FabricState(P.Topology(N, group_size=G))
    state.withdraw("ghost")
    state.commit("a", np.ones(state.rm.n_resources))
    state.withdraw("a")
    state.withdraw("a")
    assert state.committed_load("a") is None
    return state.to_json_obj()


def unregister_idempotent(P):
    arb = P.fab.FabricArbiter(P.Topology(N, group_size=G))
    arb.register("a")
    arb.unregister("a")
    arb.unregister("a")
    arb.unregister("ghost")
    assert arb.tenants() == []
    return [arb.tenants(), arb.stats, arb.to_json_obj()]


# -- drill harness -----------------------------------------------------------------

def schedule_consumption_helpers(P):
    f = P.f
    sched = f.FaultInjector(P.Topology(N, group_size=G)).compile(f.FaultScenario(
        name="mix",
        seed=3,
        blackouts=(f.TelemetryBlackoutSpec(start=2, duration=2, drop_prob=1.0),
                   f.TelemetryBlackoutSpec(start=6, duration=2, drop_prob=0.4)),
        stragglers=(f.StragglerSpec(start=4, duration=1, inflation=3.0),),
        elephants=(f.ElephantFlowSpec(0, G, start=1, duration=2,
                                      bytes_per_window=8 * MB),),
        crashes=(f.TenantCrashSpec("B", window=5),),
    ))
    d = np.zeros((N, N))
    assert sched.observed_demand(2, d) is None
    partial = sched.observed_demand(6, d)
    assert partial is not None and np.isnan(partial).any()
    assert sched.observed_demand(0, d) is d
    assert sched.perturbed_demand(1, d)[0, G] >= 8 * MB * 0.5
    assert sched.completion_scale(4) == 3.0 and sched.completion_scale(0) == 1.0
    assert not sched.crashed("B", 4) and sched.crashed("B", 5)
    assert sched.horizon >= 7
    return [schedule_obs(sched), np.isnan(partial), sched.perturbed_demand(1, d),
            sched.perturbed_demand(0, d), [sched.completion_scale(w) for w in range(8)],
            [sched.crashed("B", w) for w in range(8)], sched.event_log().pop_due(99)]


def drill_result_accounting(P):
    """``run_drill`` through a runtime and a Session under a composed
    schedule, and every figure of ``DrillResult``."""
    f = P.f
    topo = P.Topology(N, group_size=G)
    sched = f.FaultInjector(topo).compile(f.FaultScenario(
        name="drill", seed=5,
        flaps=(f.LinkFlapSpec(0, G, start=4, cycles=2, down_windows=1, up_windows=1),),
        blackouts=(f.TelemetryBlackoutSpec(start=9, duration=2, drop_prob=0.5),),
        stragglers=(f.StragglerSpec(start=11, duration=2, inflation=2.0),),
        crashes=(f.TenantCrashSpec("t", window=14),),
    ))
    trace = P.rt.drifting_skew_trace(N, 16, dwell=6)
    out = []
    for tenant in (None, "t"):
        rt = P.Runtime(topo)
        assert f.arm_events(rt, sched) == len(sched.events)
        rt = P.Runtime(topo)
        res = f.run_drill(rt, trace, sched, tenant=tenant)
        pre = res.healthy_median_s(4)
        out += [res.to_json_obj(), res.completions(), pre, res.availability(pre),
                res.availability(pre, factor=1.01), res.availability(0.0),
                res.recovery_window(after=7, threshold_s=1.5 * pre),
                res.recovery_window(after=99, threshold_s=1.0),
                res.replans_by_reason(), res.backoff_windows, res.replan_count,
                res.total_completion_s, len(res.reports)]
    return out


SCENARIOS = {f.__name__: f for f in (
    different_seed_different_masks, injector_validates_topology, spec_validation,
    rail_loss_fans_out_to_nic_links, down_then_restore_same_window_restore_wins,
    restore_scheduled_before_down_down_wins, duplicate_downs_collapse,
    pop_due_orders_across_windows, runtime_same_window_flap_leaves_fabric_healthy,
    record_loads_rejects_poison, estimator_blackout_serves_last_good,
    estimator_partial_dropout_backfills, flap_backoff_suppresses_storm,
    flap_backoff_deferred_catchup_fires_once, flap_backoff_quiet_period_resets_level,
    flap_backoff_disabled_fires_every_event, watchdog_abandons_stuck_pending,
    watchdog_disabled_never_fires, sweep_solver_avoids_down_link,
    healthy_solve_not_degraded, solve_degraded_routes_everything,
    withdraw_unknown_tenant_is_noop, unregister_idempotent,
    schedule_consumption_helpers, drill_result_accounting,
)}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_scenario_equals_reference(case):
    _pair(SCENARIOS[case])


# -- launch/drills.py against benchmarks/bench_faults.py ---------------------------

def _bench(name):
    sys.path.insert(0, ROOT)
    try:
        import importlib

        return importlib.import_module(f"benchmarks.{name}")
    finally:
        sys.path.remove(ROOT)


#: the reference code's digests and figures (its bench, rerun with JAX on a CPU)
FAULT_FIGURES = {
    "flap": {"digest": "dc8ddaa2bee31628deed4bced91120a7013fd2a133bf135e8017efd398caf86a",
             "topology_replans_backoff": 4, "topology_replans_storm": 8,
             "suppressed_windows": 4, "recovered_window": 15,
             "availability": 0.8571428571428571,
             "prefault_completion_s": 0.003810177137937085},
    "blackout": {"digest": "61caea2cf98311dd38330f413ae19c6af9e22edba9b49e7db15963e34a3423eb",
                 "adaptive_static_ratio": 0.7089201621067166,
                 "adaptive_completion_s": 0.2953325649876276, "missing_windows": 8},
    "tenant_crash": {"digest": "7eec5ea3646b3689ac5bd0272a977255b10ca1f28e38e3af42a0b5e746e4b48d",
                     "survivor_solo_ratio": 1.0, "evictions": 1, "survivors": ["A"]},
    "perturb": {"digest": "221c6c3d2365eb9f0d39f4e2e23f3fb8ab2493b502458fb8e8c4d4b192e2e93d",
                "straggler_ratio": 3.524722348348898,
                "total_completion_s": 0.14198466913342306, "telemetry_rejected": 0},
}


@pytest.fixture(scope="module")
def fault_sections():
    reports = {}
    got = {name: drills.SECTIONS[name](device="cpu", reports=reports)
           for name in drills.FAULT_SECTIONS}
    return got, reports


@pytest.mark.parametrize("section", drills.FAULT_SECTIONS)
def test_fault_section_equals_reference(fault_sections, section):
    got, reports = fault_sections
    want = getattr(_bench("bench_faults"), f"{section}_section")()
    assert got[section] == want
    for key, val in FAULT_FIGURES[section].items():
        assert got[section][key] == val, key


def test_fault_digests_equal_the_bench_file(fault_sections):
    import json

    with open(os.path.join(ROOT, "BENCH_faults.json")) as fh:
        bench = json.load(fh)
    for name in drills.FAULT_SECTIONS:
        assert fault_sections[0][name]["digest"] == bench[name]["digest"]


def test_drill_results_equal_reference(fault_sections):
    """The DrillResults behind the sections, drill for drill."""
    _, reports = fault_sections
    bench = _bench("bench_faults")
    seen = {}
    real = jfaults.run_drill

    def keep(*a, **kw):
        res = real(*a, **kw)
        seen.setdefault(res.schedule.scenario.name, []).append(res.to_json_obj())
        return res

    bench.run_drill = keep
    try:
        for name in ("flap", "blackout", "perturb"):
            getattr(bench, f"{name}_section")()
    finally:
        bench.run_drill = real
    assert [reports["flap backoff"], reports["flap storm"]] == seen["flap"]
    assert [reports["blackout"]] == seen["blackout"]
    assert [reports["perturb"]] == seen["perturb"]
    assert len(reports["tenant_crash survivor"]) == 36


def test_port_drills_pass_the_reference_gate(fault_sections):
    """The reference's ``validate_faults`` gate on the port's figures, and
    each of its regressions rejected."""
    validate_faults = _bench("bench_faults").validate_faults
    good = fault_sections[0]
    validate_faults(good)
    for section, key, bad in [
        ("flap", "recovery_windows", 5), ("flap", "recovery_windows", None),
        ("flap", "topology_replans_backoff", 9), ("flap", "availability", 0.5),
        ("blackout", "adaptive_static_ratio", 1.2), ("blackout", "missing_windows", 3),
        ("tenant_crash", "evictions", 0), ("tenant_crash", "survivor_solo_ratio", 1.5),
        ("tenant_crash", "double_teardown_ok", False),
        ("perturb", "telemetry_rejected", 2), ("perturb", "straggler_ratio", 1.0),
    ]:
        broken = copy.deepcopy(good)
        broken[section][key] = bad
        with pytest.raises(ValueError):
            validate_faults(broken)
    with pytest.raises(ValueError):
        validate_faults({k: v for k, v in good.items() if k != "blackout"})


def test_drills_command_on_cpu(capsys):
    assert drills.main(["--device", "cpu", "--sections", "perturb", "steady"]) == 0
    out = capsys.readouterr().out
    assert "[drills] perturb" in out and "straggler ratio 3.524722348348898" in out
    assert "[drills] steady" in out and "win 1.0087846045090592" in out
    assert "runtime solves on the card" not in out
