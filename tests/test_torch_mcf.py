"""Port host planner and fabric simulator against the JAX package.

``core/mcf.py`` and ``core/fabsim.py`` are numpy only in both packages, so
every result is held bit for bit: the same flows per pair and path, equal
resource and link loads, equal ``SimResult`` records.  Demands are made
with numpy from a seed (real-valued, skewed, with small messages) and handed
to both packages.
"""

import numpy as np
import pytest

from repro.core import fabsim as jfab
from repro.core import incidence as jinc
from repro.core import mcf as jmcf
from repro.core import planner as jpl
from repro.core.topology import Topology as JTopology
from repro_torch.core import fabsim as tfab
from repro_torch.core import incidence as tinc
from repro_torch.core import mcf as tmcf
from repro_torch.core.topology import Topology as TTopology

pytestmark = pytest.mark.torch_port

MB = float(1 << 20)

#: (name, n, group size, link scales): three healthy geometries, and one
#: fabric with a rail down and an intra-node link degraded
TOPOS = [
    ("8x4", 8, 4, None),
    ("16x4", 16, 4, None),
    ("32x4", 32, 4, None),
    ("8x4-degraded", 8, 4, {(0, 4): 0.0, (1, 2): 0.5}),
]


def _topos(n, G, scales):
    j, t = JTopology(n, group_size=G), TTopology(n, group_size=G)
    if scales:
        j, t = j.with_link_scale(scales), t.with_link_scale(scales)
    return j, t


def _demands(n, seed, density=None):
    """Skewed real-valued demand: two hot destinations, a few <= 1 MB."""
    rng = np.random.default_rng(seed)
    density = density if density is not None else (1.0 if n <= 16 else 0.15)
    hot = rng.choice(n, size=2, replace=False)
    out = {}
    for s in range(n):
        for d in range(n):
            if s == d or rng.random() > density:
                continue
            v = rng.uniform(0.25, 48.0) * MB
            if d in hot:
                v *= 6.0
            out[(s, d)] = float(v)
    return out


def _flows(plan):
    return {
        k: [(f.path.links, f.path.nodes, f.path.family, f.bytes) for f in v]
        for k, v in plan.flows.items()
    }


def assert_plans_equal(a, b):
    """Same flows per pair and path (in order), same loads, bit for bit."""
    assert _flows(a) == _flows(b)
    np.testing.assert_array_equal(a.resource_bytes, b.resource_bytes)
    np.testing.assert_array_equal(a.link_bytes, b.link_bytes)
    assert a.resource_bytes.dtype == b.resource_bytes.dtype
    assert (a.iterations, a.degraded) == (b.iterations, b.degraded)
    assert a.max_normalized_load() == b.max_normalized_load()


def _loads(rm, seed, scale=64 * MB):
    return np.random.default_rng(seed).uniform(0.0, scale, rm.n_resources)


@pytest.mark.parametrize("refresh", ["sweep", "sequential"])
@pytest.mark.parametrize("prices", ["none", "prev", "ext", "both"])
@pytest.mark.parametrize("name,n,G,scales", TOPOS, ids=[t[0] for t in TOPOS])
def test_solve_mwu_equals_reference(name, n, G, scales, prices, refresh):
    jt, tt = _topos(n, G, scales)
    dem = _demands(n, seed=n)
    rm = jmcf.ResourceModel(jt)
    kw = {}
    if prices in ("prev", "both"):
        kw["prev_loads"] = _loads(rm, 1)
    if prices in ("ext", "both"):
        kw["ext_loads"] = _loads(rm, 2)
    want = jmcf.solve_mwu(jt, dem, refresh=refresh, **kw)
    got = tmcf.solve_mwu(tt, dem, refresh=refresh, **kw)
    assert_plans_equal(got, want)
    assert sum(got.per_pair_bytes().values()) == pytest.approx(sum(dem.values()))


@pytest.mark.parametrize("refresh", ["sweep", "sequential"])
def test_solve_mwu_zero_ext_loads_equal_none_and_negative_raises(refresh):
    _, tt = _topos(8, 4, None)
    dem = _demands(8, seed=3)
    R = tmcf.ResourceModel(tt).n_resources
    base = tmcf.solve_mwu(tt, dem, refresh=refresh)
    assert_plans_equal(tmcf.solve_mwu(tt, dem, refresh=refresh,
                                      ext_loads=np.zeros(R)), base)
    bad = np.zeros(R)
    bad[3] = -1.0
    for mcf in (tmcf, jmcf):
        with pytest.raises(ValueError, match="non-negative"):
            mcf.solve_mwu(tt if mcf is tmcf else JTopology(8, group_size=4), dem,
                          refresh=refresh, ext_loads=bad)
    with pytest.raises(ValueError, match="unknown refresh"):
        tmcf.solve_mwu(tt, dem, refresh="nope")


@pytest.mark.parametrize("solver", ["solve_direct", "solve_static_striping",
                                    "solve_degraded"])
@pytest.mark.parametrize("name,n,G,scales", TOPOS, ids=[t[0] for t in TOPOS])
def test_baseline_solvers_equal_reference(name, n, G, scales, solver):
    jt, tt = _topos(n, G, scales)
    dem = _demands(n, seed=n + 1)
    want = getattr(jmcf, solver)(jt, dem)
    got = getattr(tmcf, solver)(tt, dem)
    assert_plans_equal(got, want)


@pytest.mark.parametrize("name,n,G,scales", TOPOS, ids=[t[0] for t in TOPOS])
def test_pxn_path_and_cut_bound_equal_reference(name, n, G, scales):
    jt, tt = _topos(n, G, scales)
    for s in range(n):
        for d in range(n):
            if s != d:
                a, b = jmcf.pxn_path(jt, (s, d)), tmcf.pxn_path(tt, (s, d))
                assert (a.links, a.nodes, a.family) == (b.links, b.nodes, b.family)
    for seed in range(3):
        dem = _demands(n, seed)
        assert tmcf.congestion_lower_bound(tt, dem) == \
            jmcf.congestion_lower_bound(jt, dem)


@pytest.mark.parametrize("name,n,G,scales", TOPOS, ids=[t[0] for t in TOPOS])
def test_plan_from_flows_equals_reference(name, n, G, scales):
    """The same planner output materializes into equal host plans."""
    import jax.numpy as jnp

    jt, tt = _topos(n, G, scales)
    dem = _demands(n, seed=5)
    D = np.zeros((n, n), np.float32)
    for (s, d), v in dem.items():
        D[s, d] = v
    flows, _ = jpl.plan_flows(jnp.asarray(D), jinc.incidence_for(jt),
                              jpl.PlannerConfig(n_iters=32))
    flows = np.array(flows)
    # a pair whose row is all zero takes k=0 with its whole demand
    flows[0, 1] = 0.0
    dem[(0, 1)] = 3.0 * MB
    want = jmcf.plan_from_flows(jt, flows, dem, iterations=32)
    got = tmcf.plan_from_flows(tt, flows, dem, iterations=32)
    assert_plans_equal(got, want)


@pytest.mark.parametrize("name,n,G,scales", TOPOS, ids=[t[0] for t in TOPOS])
def test_apply_plan_fractions_equals_reference(name, n, G, scales):
    """A stale plan on drifted demand (unseen pairs take PXN), on its own
    fabric and on one with a link down."""
    jt, tt = _topos(n, G, scales)
    old = _demands(n, seed=6, density=0.5)
    new = _demands(n, seed=7, density=0.8)
    pj, pt = jmcf.solve_mwu(jt, old), tmcf.solve_mwu(tt, old)
    assert_plans_equal(tmcf.apply_plan_fractions(pt, new),
                       jmcf.apply_plan_fractions(pj, new))
    down = {(1, 1 + G): 0.0}
    assert_plans_equal(
        tmcf.apply_plan_fractions(pt, new, topo=tt.with_link_scale(down)),
        jmcf.apply_plan_fractions(pj, new, topo=jt.with_link_scale(down)))


def _sim_equal(a, b):
    assert a.to_json_obj() == b.to_json_obj()
    np.testing.assert_array_equal(a.per_resource_time, b.per_resource_time)


@pytest.mark.parametrize("name,n,G,scales", TOPOS, ids=[t[0] for t in TOPOS])
def test_fabsim_equals_reference(name, n, G, scales):
    jt, tt = _topos(n, G, scales)
    dem = _demands(n, seed=8)
    for solver in ("solve_mwu", "solve_direct", "solve_static_striping"):
        pj, pt = getattr(jmcf, solver)(jt, dem), getattr(tmcf, solver)(tt, dem)
        for chunk in (float(1 << 20), float(4 << 20)):
            _sim_equal(tfab.simulate(pt, chunk), jfab.simulate(pj, chunk))
        sj, st = jfab.simulate(pj), tfab.simulate(pt)
        assert st.bottleneck_kind(pt) == sj.bottleneck_kind(pj)
        assert tfab.compare({"p": pt})["p"].to_json_obj() == sj.to_json_obj()
        for pair in list(dem)[:6]:
            assert tfab.pair_bandwidth(pt, pair) == jfab.pair_bandwidth(pj, pair)
    assert tfab.pair_bandwidth(tmcf.solve_mwu(tt, {(0, 1): MB}), (1, 0)) == 0.0
    assert tfab.simulate_nccl_rounds(tt, dem) == jfab.simulate_nccl_rounds(jt, dem)


@pytest.mark.parametrize("pairs", [1, 4, 40])
def test_pipeline_fills_agree(pairs):
    """The vectorized fill (8+ relayed flows) and the scalar loop (fewer)
    equal the reference loop, in both packages."""
    jt, tt = _topos(16, 4, None)
    dem = dict(list(_demands(16, seed=9).items())[:pairs])
    dem = {k: v * 16 for k, v in dem.items()}          # large: relays recruited
    pj, pt = jmcf.solve_mwu(jt, dem), tmcf.solve_mwu(tt, dem)
    for chunk in (float(1 << 20), float(8 << 20)):
        ref = tfab._pipeline_fill_reference(pt, chunk)
        np.testing.assert_array_equal(tfab._pipeline_fill(pt, chunk), ref)
        np.testing.assert_array_equal(ref, jfab._pipeline_fill_reference(pj, chunk))
        np.testing.assert_array_equal(tfab._pipeline_fill(pt, chunk),
                                      jfab._pipeline_fill(pj, chunk))


def test_cached_incidence_serves_both_solvers():
    """The host solver and the tensor planner share one table build."""
    tt = TTopology(8, group_size=4)
    assert tinc.incidence_for(tt) is tinc.incidence_for(TTopology(8, group_size=4))
    plan = tmcf.solve_mwu(tt, _demands(8, seed=10))
    assert plan.consolidated().keys() == plan.flows.keys()
