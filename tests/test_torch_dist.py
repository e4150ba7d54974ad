"""The port's executor across processes (gloo, on the CPU) against the stacked one.

Each world is spawned once (a module-scoped fixture a process count ``P``)
and runs every case of ``repro_torch.launch.dist_checks`` for it; the
parametrised tests read its results.  ``n`` EP ranks in groups of ``G``
over ``P`` processes, each hosting ``n / P`` of them:

* the dataplane at P in {1, 2, 4, 8} for n = 8, G = 4 and at P = 2 for
  n = 4, G = 2, in the three modes, f32 and bf16: ``y`` and ``recv``
  bit-exact against the stacked executor and ``ref_all_to_allv``, and the
  plan's digest the same on every process and the stacked executor's;
  ``baseline_all_to_all`` against the oracle (the padded buffers moved as
  they are);
* the MoE layer (router, dispatch, grouped FFN, combine) forward and its
  gradients against the stacked path's, within 1e-5 of each one's largest
  value (f32 sums over fewer rows, then an all_reduce);
* the masked branch (tokens replicated over the model group): its forward
  against the stacked masked path, and that it raises under a gradient;
* the train step on (data 2, model 1) across 2 processes without EP
  (ep_size 1) against the stacked one, as below;
* the reference's EP train step on (data 2, model 4) across 8 processes
  from the JAX package's weights (``params_from_jax``): the loss within
  1e-6 relative and every gradient leaf within 1e-5 of its largest value
  against the stacked EP 4 path, the loss within 5e-2 of the JAX package's
  single-device step;
* ``selftest --procs 8 --device cpu`` ends ``ALL OK``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models.registry import build_model as j_build_model
from repro.sharding.context import SINGLE as J_SINGLE
from repro_torch.core.dataplane import NimbleAllToAll, ref_all_to_allv
from repro_torch.launch import dist_checks, selftest
from repro_torch.launch.dist import spawn
from repro_torch.models.moe import make_moe_ffn
from repro_torch.models.registry import build_model
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

WORLDS = (1, 2, 4, 8)
GEOMETRIES = {8: (8, 4), 4: (4, 2)}           # n -> (n, G)
LAYER = dict(B=8, S=8)


def _jax_train_ref():
    """The reference's weights for the selftest's EP config, and its
    single-device loss on the selftest's batch."""
    cfg = selftest.ep_train_config()
    jcfg = dataclasses.replace(j_get_config("granite-moe-1b-a400m").reduced(),
                               n_experts=8, top_k=2, moe_capacity_factor=8.0)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = selftest.ep_train_batch(cfg, "cpu")
    jbatch = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in batch.items()}
    loss = float(jmodel.loss(jparams, jbatch))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jparams)
    return tree, loss


@functools.lru_cache(maxsize=None)
def jax_train_ref():
    return _jax_train_ref()


def _cases(P):
    cases = []
    for n, (_, G) in GEOMETRIES.items():
        if n % P or (n == 4 and P != 2):
            continue
        for dt in dist_checks.DTYPES:
            cases.append((f"exchange-n{n}-{dt}", "exchange", dict(n=n, G=G, dtype=dt)))
        cases.append((f"baseline-n{n}", "baseline", dict(n=n)))
        cases.append((f"layer-n{n}", "layer", dict(n=n, G=G, **LAYER)))
    if P == 2:
        cases.append(("masked-n4", "masked", dict(n=4, G=2)))
        cases.append(("train-ep1", "train", dict(tree=jax_train_ref()[0], data=2, model=1,
                                                 ep_size=1)))
    if P == 8:
        cases.append(("train", "train", dict(tree=jax_train_ref()[0], data=2, model=4)))
    return cases


@functools.lru_cache(maxsize=None)
def _world(P):
    results = spawn(dist_checks.run_cases, P, _cases(P), timeout_s=600)
    return {key: [r[key] for r in results] for key in results[0]}


@pytest.fixture
def world(request):
    """{case key: [each process's result]} of the world of ``request.param``
    processes, spawned once (on first use) for every test that names it."""
    return _world(request.param)


def _geometries():
    return [(P, n) for P in WORLDS for n in GEOMETRIES
            if n % P == 0 and (n != 4 or P == 2)]


def _exchange_params():
    return [pytest.param(P, n, dt, mode, id=f"P{P}-n{n}-{dt}-{mode}")
            for P, n in _geometries() for dt in dist_checks.DTYPES
            for mode in dist_checks.MODES]


@functools.lru_cache(maxsize=None)
def stacked_exchange(n, dt, mode):
    G = GEOMETRIES[n][1]
    x_all, counts = dist_checks.exchange_inputs(n, 16, 32, 0, dt)
    comm = NimbleAllToAll(n, G, max_chunks=16, chunk_bytes=32 * 4, mode=mode)
    y, r = comm(torch.as_tensor(x_all).to(dist_checks.DTYPES[dt]), torch.as_tensor(counts))
    plan = comm.plan_from_counts(torch.as_tensor(counts))
    return y.float().numpy(), r.numpy(), dist_checks.plan_digest(plan), x_all, counts


@pytest.mark.parametrize("world,n,dt,mode", _exchange_params(), indirect=["world"])
def test_exchange_bit_exact_against_stacked_and_oracle(world, n, dt, mode):
    y_st, r_st, plan_st, x_all, counts = stacked_exchange(n, dt, mode)
    yref, rref = ref_all_to_allv(x_all, counts)
    assert np.array_equal(y_st, yref) and np.array_equal(r_st, rref)
    blocks = [r[mode] for r in world[f"exchange-n{n}-{dt}"]]
    P = len(blocks)
    L = n // P
    for p, b in enumerate(blocks):
        blk = slice(p * L, (p + 1) * L)
        assert b["dtype"] == str(dist_checks.DTYPES[dt])
        assert np.array_equal(b["y"], y_st[blk]) and np.array_equal(b["y"], yref[blk])
        assert np.array_equal(b["recv"], r_st[blk]) and np.array_equal(b["recv"], rref[blk])
        assert b["plan"] == plan_st                     # the same plan on every process
    sent = [m for b in blocks for rnd in b["messages_per_hop"] for m in rnd]
    assert (max(sent) == 0) if P == 1 else (max(sent) >= 1)


def _params_for(kind):
    return [pytest.param(P, n, id=f"P{P}-n{n}-{kind}") for P, n in _geometries()]


@pytest.mark.parametrize("world,n", _params_for("baseline"), indirect=["world"])
def test_baseline_all_to_all_equals_the_oracle(world, n):
    x_all, counts = dist_checks.exchange_inputs(n, 16, 32, 0, "f32")
    yref, _ = ref_all_to_allv(x_all, counts)
    got = np.concatenate(world[f"baseline-n{n}"])
    assert np.array_equal(got, yref)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


@functools.lru_cache(maxsize=None)
def stacked_layer(n):
    G = GEOMETRIES[n][1]
    cfg = dist_checks.layer_config()
    p, x, cot = dist_checks.layer_inputs(cfg, **LAYER)
    ctx = ParallelContext(ep_size=n, group_size=G, moe_chunk_tokens=4, device="cpu")
    return dist_checks.layer_grads(make_moe_ffn(cfg, ctx), p, x, cot)


@pytest.mark.parametrize("world,n", _params_for("layer"), indirect=["world"])
def test_moe_layer_forward_and_gradients_equal_stacked(world, n):
    want = stacked_layer(n)
    got = world[f"layer-n{n}"]
    assert all(g["dropped"] == 0 for g in got) and want["dropped"] == 0
    for g in got:
        assert abs(g["aux"] - want["aux"]) <= 1e-6 * abs(want["aux"])
    # tokens and their gradients: each process's rows
    _close(np.concatenate([g["y"] for g in got]), want["y"])
    _close(np.concatenate([g["x"] for g in got]), want["x"])
    # the replicated router: its gradient is the processes' sum
    _close(np.sum([g["router"] for g in got], axis=0), want["router"])
    # the expert leaves: each process's block of experts
    for k in ("wg", "wu", "wd"):
        _close(np.concatenate([g[k] for g in got]), want[k])


@pytest.mark.parametrize("world", [2], indirect=True, ids=["P2"])
def test_masked_branch_forward_equals_stacked_and_raises_under_grad(world):
    cfg = dist_checks.layer_config()
    p, x, _ = dist_checks.layer_inputs(cfg, 1, 3)
    ctx = ParallelContext(ep_size=4, group_size=2, moe_chunk_tokens=4, device="cpu")
    with torch.no_grad():
        y, aux, _ = make_moe_ffn(cfg, ctx)(p, x)
    got = world["masked-n4"]
    for g in got:
        _close(g["y"], y.numpy())                      # the all-reduced sum, everywhere
        assert abs(g["aux"] - float(aux)) <= 1e-6 * abs(float(aux))
        assert "no gradient across processes" in g["raised"]


@functools.lru_cache(maxsize=None)
def stacked_train(ep_size=4):
    tree, _ = jax_train_ref()
    cfg = selftest.ep_train_config()
    ctx = ParallelContext(ep_size=ep_size, group_size=2, moe_mode="nimble", device="cpu")
    params = params_from_jax(tree, cfg, ctx)
    loss, grads = loss_and_grads(build_model(cfg, ctx), params,
                                 selftest.ep_train_batch(cfg, "cpu"))
    return float(loss), [g.numpy() for g in leaves(grads)], params


def _hold_train(got, ep_size):
    loss, grads, params = stacked_train(ep_size)
    assert all(g["dropped"] == 0 for g in got)
    for g in got:
        assert abs(g["loss"] - loss) <= 1e-6 * abs(loss)
    full = selftest.assemble_grads(got, params)
    assert len(full) == len(grads)
    for a, b in zip(full, grads):
        _close(a, b)


@pytest.mark.parametrize("world", [8], indirect=True, ids=["P8"])
def test_train_step_across_8_processes_equals_stacked_ep4(world):
    _hold_train(world["train"], 4)


@pytest.mark.parametrize("world", [2], indirect=True, ids=["P2"])
def test_ep1_train_step_on_data_2_model_1_equals_stacked(world):
    """No EP with a mesh: the batch over data, the load-balance loss still
    the global batch's (each process's aux is not its shard's)."""
    _hold_train(world["train-ep1"], 1)


@pytest.mark.parametrize("world", [8], indirect=True, ids=["P8"])
def test_train_step_across_8_processes_near_jax_single_device(world):
    got = world["train"]
    _, jloss = jax_train_ref()
    for g in got:
        assert np.isfinite(g["loss"]) and abs(g["loss"] - jloss) < 5e-2


def test_selftest_procs_8_all_ok(capsys):
    assert selftest.main(["--procs", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for arm in ("dataplane direct (8 processes): OK", "dataplane stripe (8 processes): OK",
                "dataplane nimble (8 processes): OK", "moe_comm direct (8 processes): OK",
                "moe_comm nimble (8 processes): OK", "EP train step (8 processes, mesh data "
                "2 x model 4", "ALL OK"):
        assert arm in out, arm


def test_spawn_reports_a_failing_process():
    with pytest.raises(RuntimeError, match="failed in process [01] of 2"):
        spawn(dist_checks.run_cases, 2, [("x", "exchange", dict(n=3, G=4))], timeout_s=120)


def test_shard_batch_raises_when_the_processes_do_not_split_it():
    import types

    from repro_torch.train.step import shard_batch

    batch = {"tokens": torch.arange(24).view(8, 3), "labels": torch.arange(24).view(8, 3)}
    ctx = types.SimpleNamespace(token_block=(1, 4))
    got, share = shard_batch(batch, ctx)
    assert share == 0.25 and torch.equal(got["tokens"], batch["tokens"][2:4])
    with pytest.raises(ValueError, match="does not split over 3 processes"):
        shard_batch(batch, types.SimpleNamespace(token_block=(0, 3)))


def test_gradient_all_reduce_packs_buckets_and_copies_back(monkeypatch):
    from repro_torch.launch.dist import local_world
    from repro_torch.train import step

    monkeypatch.setattr(step, "BUCKET_BYTES", 64)
    g = torch.Generator().manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    ts = [torch.randn(n, generator=g).to(dt)
          for n, dt in ((4, f32), (40, f32), (3, bf16), (8, f32), (2, f32), (5, bf16))]
    ts.append(torch.randn(4, 6, generator=g).t())           # strided: through a buffer
    assert [[t.numel() for t in b] for b in step._buckets(ts)] == [
        [4], [40], [8, 2], [24], [3, 5]]
    want = [t.clone() for t in ts]
    with local_world("gloo"):
        step._all_reduce_flat(ts, (None,))                  # a sum over one process
    assert all(torch.equal(a, b) for a, b in zip(ts, want))


def test_train_moe_nimble_example_across_8_processes(capsys):
    from repro_torch.examples import train_moe_nimble

    losses = train_moe_nimble.main(["--device", "cpu", "--steps", "25", "--seq", "32",
                                    "--procs", "8"])
    out = capsys.readouterr().out
    assert "8 processes: the global loss equal on every process" in out
    assert "(improved)" in out and len(losses) == 25


def test_skewed_alltoallv_example_across_4_processes(capsys):
    from repro_torch.examples import skewed_alltoallv

    across = skewed_alltoallv.main(["--device", "cpu", "--procs", "4"])
    stacked = skewed_alltoallv.main(["--device", "cpu"])
    assert across == stacked                 # bit-exact flags and the same projections
    assert capsys.readouterr().out.count("all modes bit-exact vs oracle") == 2
