"""Port planner core against the JAX package: tables, schedules and plans.

Integer results (incidence tables, slot layouts, quantized chunk plans) must
be bit-exact.  Inputs are made with numpy from a seed and handed to both
packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataplane as jdp
from repro.core import incidence as jinc
from repro.core import planner as jpl
from repro.core import schedule as jsch
from repro.core.topology import Topology as JTopology
from repro_torch.core import dataplane as tdp
from repro_torch.core import incidence as tinc
from repro_torch.core import planner as tpl
from repro_torch.core import schedule as tsch
from repro_torch.core.topology import Topology as TTopology

pytestmark = pytest.mark.torch_port

GEOMETRIES = [(8, 4), (16, 4)]


def _skewed_demand(rng, n, C):
    """Chunk demand with a few hot destinations (MoE-style skew)."""
    d = rng.integers(0, C // 4 + 1, size=(n, n))
    hot = rng.choice(n, size=2, replace=False)
    d[:, hot] = rng.integers(C // 2, C + 1, size=(n, 2))
    np.fill_diagonal(d, 0)
    return d.astype(np.int32)


@pytest.mark.parametrize("n,G", GEOMETRIES)
def test_incidence_tables_equal(n, G):
    j = jinc.incidence_for(JTopology(n, G))
    t = tinc.incidence_for(TTopology(n, G))
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "paths":
            assert [None if p is None else (p.links, p.nodes, p.family) for p in a] \
                == [None if p is None else (p.links, p.nodes, p.family) for p in b]
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name
    for f in dataclasses.fields(j.pair_candidates):
        np.testing.assert_array_equal(getattr(j.pair_candidates, f.name),
                                      getattr(t.pair_candidates, f.name))
    # cached per fingerprint, as in the reference
    assert tinc.incidence_for(TTopology(n, G)) is t


@pytest.mark.parametrize("alt_frac", [0.0, 0.5])
@pytest.mark.parametrize("n,G", GEOMETRIES)
def test_schedule_slot_tables_equal(n, G, alt_frac):
    j = jsch.build_schedule(JTopology(n, G), 16, alt_frac)
    t = tsch.build_schedule(TTopology(n, G), 16, alt_frac)
    for name in ("S", "slot_rel", "slot_k", "slot_pos"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
    assert len(j.rounds) == len(t.rounds)
    for rj, rt in zip(j.rounds, t.rounds):
        assert [h for h, _ in rj] == [h for h, _ in rt]
        for (_, a), (_, b) in zip(rj, rt):
            np.testing.assert_array_equal(a, b)
        for hop, _ in rj:
            assert j.perm_pairs(hop) == t.perm_pairs(hop)
    np.testing.assert_array_equal(jdp.build_rel_of_pair(n, G),
                                  tdp.build_rel_of_pair(n, G))


@pytest.mark.parametrize("chunk_bytes", [float(1 << 16), float(1 << 20), float(4 << 20)])
@pytest.mark.parametrize("n,G", GEOMETRIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_plans_bit_exact(n, G, chunk_bytes, seed):
    C = 16
    rng = np.random.default_rng(seed)
    demand = _skewed_demand(rng, n, C)
    cfg_j = jpl.PlannerConfig(chunk_bytes=chunk_bytes)
    cfg_t = tpl.PlannerConfig(chunk_bytes=chunk_bytes)
    jt = jsch.build_schedule(JTopology(n, G), C, 0.5)
    tt = tsch.build_schedule(TTopology(n, G), C, 0.5)
    hj = jpl.PlannerTablesHashable(jinc.incidence_for(JTopology(n, G)), jt.S,
                                   jdp.build_rel_of_pair(n, G))
    want = np.asarray(jpl.plan_chunks_jit(jnp.asarray(demand), hj, cfg_j))
    got = tpl.plan_chunks(torch.as_tensor(demand), tinc.incidence_for(TTopology(n, G)),
                          cfg_t, tt.S, tdp.build_rel_of_pair(n, G))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(-1).numpy(), demand)
    # the unquantized flows and loads agree bit for bit too
    D = demand.astype(np.float32) * np.float32(chunk_bytes)
    fj, lj = jpl.plan_flows(jnp.asarray(D), jinc.incidence_for(JTopology(n, G)), cfg_j)
    ft, lt = tpl.plan_flows(torch.as_tensor(D), tinc.incidence_for(TTopology(n, G)),
                            cfg_t)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("n,G", GEOMETRIES)
def test_batch_plans_equal_per_matrix_and_jax(n, G):
    C, B = 16, 3
    rng = np.random.default_rng(7)
    demand = np.stack([_skewed_demand(rng, n, C) for _ in range(B)])
    cfg_t = tpl.PlannerConfig(chunk_bytes=float(2 << 20))
    cfg_j = jpl.PlannerConfig(chunk_bytes=float(2 << 20))
    tt = tsch.build_schedule(TTopology(n, G), C, 0.5)
    tabs = tinc.incidence_for(TTopology(n, G))
    rel = tdp.build_rel_of_pair(n, G)
    batch = tpl.plan_chunks(torch.as_tensor(demand), tabs, cfg_t, tt.S, rel)
    for b in range(B):
        one = tpl.plan_chunks(torch.as_tensor(demand[b]), tabs, cfg_t, tt.S, rel)
        assert torch.equal(batch[b], one)
    jt = jsch.build_schedule(JTopology(n, G), C, 0.5)
    hj = jpl.PlannerTablesHashable(jinc.incidence_for(JTopology(n, G)), jt.S,
                                   jdp.build_rel_of_pair(n, G))
    want = np.asarray(jpl.plan_chunks_batch_jit(jnp.asarray(demand), hj, cfg_j))
    np.testing.assert_array_equal(batch.numpy(), want)


@pytest.mark.parametrize("mode", ["direct", "stripe"])
@pytest.mark.parametrize("n,G", GEOMETRIES)
def test_static_plan_rules_equal(mode, n, G):
    C = 16
    demand = _skewed_demand(np.random.default_rng(3), n, C)
    j = jdp.NimbleAllToAll("x", n, G, max_chunks=C, chunk_bytes=128.0, mode=mode)
    t = tdp.NimbleAllToAll(n, G, max_chunks=C, chunk_bytes=128.0, mode=mode)
    want = np.asarray(j._plan(jnp.asarray(demand)))
    got = t.plan_from_counts(torch.as_tensor(demand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
