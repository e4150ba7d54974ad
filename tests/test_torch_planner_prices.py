"""The tensor planner's two price inputs against the JAX package.

``prev_loads`` (this job's previous loads, EMA-folded through
``PlannerConfig.hysteresis``) and ``ext_loads`` (other tenants' committed
load: priced, never carried into the returned loads).  The demands are the
runtime's own traces (real-valued, jittered), so the resource loads depend
on the order the charges are summed in; flows and loads must equal JAX's
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as jpl
from repro.core.schedule import build_planner_tables as jtables
from repro.core.topology import Topology as JTopology
from repro.runtime.traces import drifting_skew_trace, skew_burst_trace
from repro_torch.core import planner as tpl
from repro_torch.core.schedule import build_planner_tables as ttables
from repro_torch.core.topology import Topology as TTopology

pytestmark = pytest.mark.torch_port

MB = float(1 << 20)


def _case(n, B, seed, degraded=False):
    jt, tt = JTopology(n, group_size=4), TTopology(n, group_size=4)
    if degraded:
        jt, tt = (t.with_link_scale({(0, 4): 0.0}) for t in (jt, tt))
    trace = np.concatenate([
        drifting_skew_trace(n, B, dwell=2, seed=seed),
        skew_burst_trace(n, B, burst_window=1, seed=seed),
    ]).astype(np.float32)
    jtab, ttab = jtables(jt), ttables(tt)
    rng = np.random.default_rng(seed)
    R = ttab.n_resources
    prev = (rng.random((len(trace), R)) * 512 * MB).astype(np.float32)
    ext = (rng.random((len(trace), R)) * 512 * MB).astype(np.float32)
    return trace, jtab, ttab, prev, ext


def _both(trace, jtab, ttab, cfg_kw, prev, ext):
    jcfg, tcfg = jpl.PlannerConfig(**cfg_kw), tpl.PlannerConfig(**cfg_kw)
    fj, lj = jpl.plan_flows_batch(
        jnp.asarray(trace), jtab, jcfg,
        None if prev is None else jnp.asarray(prev),
        None if ext is None else jnp.asarray(ext))
    ft, lt = tpl.plan_flows_batch(
        torch.as_tensor(trace), ttab, tcfg,
        None if prev is None else torch.as_tensor(prev),
        None if ext is None else torch.as_tensor(ext))
    return (np.asarray(fj), np.asarray(lj)), (ft.numpy(), lt.numpy())


@pytest.mark.parametrize("prices", ["none", "prev", "ext", "both"])
@pytest.mark.parametrize("n,degraded", [(8, False), (16, False), (8, True)])
def test_plan_flows_batch_prices_bit_exact(n, degraded, prices):
    trace, jtab, ttab, prev, ext = _case(n, 3, seed=n, degraded=degraded)
    prev = prev if prices in ("prev", "both") else None
    ext = ext if prices in ("ext", "both") else None
    for cfg_kw in ({}, {"n_iters": 32, "hysteresis": 0.25}):
        (fj, lj), (ft, lt) = _both(trace, jtab, ttab, cfg_kw, prev, ext)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(lt, lj)
        # every byte routed
        np.testing.assert_allclose(ft.sum(-1), trace, rtol=1e-5)


def test_prices_move_the_plan_and_stay_out_of_the_loads():
    trace, _, ttab, prev, ext = _case(8, 2, seed=1)
    d = torch.as_tensor(trace)
    f0, l0 = tpl.plan_flows_batch(d, ttab)
    fe, le = tpl.plan_flows_batch(d, ttab, ext_loads=torch.as_tensor(ext))
    assert not torch.equal(fe, f0)                  # prices steer the solve
    # ext is not carried into the loads: they are this job's own charges
    pc = ttab.pair_candidates
    for b in range(len(trace)):
        own = np.zeros(ttab.n_resources)
        np.add.at(own, pc.rids.ravel(),
                  (fe[b].reshape(-1, ttab.K, 1).numpy() * pc.mult).ravel())
        np.testing.assert_allclose(le[b].numpy(), own, rtol=1e-5)
    # all-zero prices give the unpriced plan bit for bit
    fz, lz = tpl.plan_flows_batch(d, ttab, ext_loads=torch.zeros_like(le))
    assert torch.equal(fz, f0) and torch.equal(lz, l0)
    # prev_loads folds through the EMA: zero prev equals no prev
    fp, lp = tpl.plan_flows_batch(d, ttab, prev_loads=torch.zeros_like(l0))
    assert torch.equal(fp, f0) and torch.equal(lp, l0)
    _, lh = tpl.plan_flows_batch(d, ttab, prev_loads=torch.as_tensor(prev))
    assert bool((lh >= 0.5 * torch.as_tensor(prev)).all())


def test_plan_flows_single_matches_batch_and_reference():
    trace, jtab, ttab, prev, ext = _case(8, 1, seed=2)
    ft, lt = tpl.plan_flows(torch.as_tensor(trace[0]), ttab,
                            prev_loads=torch.as_tensor(prev[0]),
                            ext_loads=torch.as_tensor(ext[0]))
    fj, lj = jpl.plan_flows(jnp.asarray(trace[0]), jtab, jpl.PlannerConfig(),
                            prev_loads=jnp.asarray(prev[0]),
                            ext_loads=jnp.asarray(ext[0]))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_planner_config_and_provenance_equal_reference():
    assert tpl.PlannerConfig().hysteresis == jpl.PlannerConfig().hysteresis == 0.5
    for kw in ({}, {"lam": 0.5, "n_iters": 32, "hysteresis": 0.0}):
        assert tpl.planner_provenance(tpl.PlannerConfig(**kw)) == \
            jpl.planner_provenance(jpl.PlannerConfig(**kw))


@pytest.mark.parametrize("n", [8, 32])
def test_load_sum_order_is_the_tables_static_order(n):
    """Each resource's segment is its load, then every candidate row entry
    charging it (mult > 0), in (pair, k, slot) order."""
    ttab = ttables(TTopology(n, group_size=4))
    tb = tpl.device_tables(ttab, "cpu")
    R = ttab.n_resources
    rid = ttab.pair_candidates.rids.reshape(-1)
    live = ttab.pair_candidates.mask.reshape(-1)
    order, lengths = tb.seg_order.numpy(), tb.seg_lengths.numpy()
    assert order.shape == (R + live.sum(),) and int(lengths.sum()) == order.size
    assert lengths[-1] == 1                     # the dummy resource: its load alone
    starts = np.cumsum(lengths) - lengths
    for r in range(R):
        seg = order[starts[r]:starts[r] + lengths[r]]
        assert seg[0] == r
        np.testing.assert_array_equal(seg[1:] - R, np.flatnonzero((rid == r) & live))
