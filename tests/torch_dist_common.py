"""What the port's gloo worlds run and what their tests hold them against.

The tests of the port's executor across processes (on the CPU, against
the stacked executor, one process and the JAX package) are split by the
world they spawn, so that the worlds run side by side:

* ``test_torch_dist_p1p2.py``: the worlds of 1 and 2 processes;
* ``test_torch_dist_p4.py``: (data 2, model 2);
* ``test_torch_dist_p8.py``: (data 2, model 4);
* ``test_torch_dist_spawns.py``: the stand-alone spawns (the selftest, the
  two examples, a failing process) and the worlds of one
  (``local_world``).

Each world is spawned once in a test process (:func:`_world`, on first
use) and runs every case :func:`_cases` gives it
(``repro_torch.launch.dist_checks``); the parametrised tests read its
results.  This module holds the cases, the references they are held
against (the stacked executor, one process, the JAX package's
single-device step and decode) and the checks that more than one world
shares (``check_*``).
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
from repro_torch.optim import adamw
from repro_torch.train.step import loss_and_grads, make_train_step
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

WORLDS = (1, 2, 4, 8)
GEOMETRIES = {8: (8, 4), 4: (4, 2)}           # n -> (n, G)
LAYER = dict(B=8, S=8)
ROWS_ARCHS = ("paper-moe-8e", "smollm-135m")
ROWS_OVERFLOW = 0.5           # a capacity factor at which paper-moe-8e drops
#: zamba2's shared attention block is read at each of its calls: its
#: gradient is the uses' sum, reduced once
PLACED_ARCHS = ("paper-moe-8e", "granite-moe-1b-a400m", "smollm-135m", "xlstm-125m",
                "zamba2-1.2b")
#: world -> (data, model, tokens a sequence of an MoE arch): 31 tokens on
#: (data 2, model 2) take the MoE's masked branch (62 global tokens, data x
#: EP 4 = 8), 32 on (data 2, model 4) its split of the model group's rows;
#: the archs without experts take 32 on both (the same references)
PLACED = {4: (2, 2, 31), 8: (2, 4, 32)}
PLACED_STEPS = 2
#: the placed cases' dtype and tolerances (loss relative, each leaf against
#: its largest value): zamba2's Mamba gradients (``A_log``, ``dt_bias``,
#: ``D``) are near-cancelling sums, which any reordered float32 sum above
#: them moves past 1e-5, so its step is held in float64
PLACED_DTYPE = {"zamba2-1.2b": "f64"}
PLACED_TOL = {"f32": (1e-6, 1e-5), "f64": (1e-12, 1e-9)}
#: the tensor-parallel cases on both PLACED worlds (2 sequences of 32
#: tokens, the rows replicated over model): (arch reduced, its config
#: overrides, remat); d_model 128 or 144, d_ff 256, 2 layers
_NARROW = (("d_model", 128), ("d_ff", 256))
_WHISPER6 = (("n_heads", 6), ("n_kv_heads", 6), ("d_model", 192), ("d_ff", 256))
#: xLSTM with one mLSTM head of 128: half of it a process on model 2 (64
#: value columns), a quarter on model 4 (32), the sLSTM by 64 or 32 channels
_XLSTM1 = (("n_heads", 1), ("n_kv_heads", 1), ("d_model", 128))
TP_CASES = {
    # query and KV heads divide by 2 and 4; remat recomputes the sums
    "heads-divide": ("llama3-8b", (("n_heads", 8), ("n_kv_heads", 4)) + _NARROW, True),
    # 2 KV heads over model 4: each read whole, two processes sharing one
    "kv-shared": ("llama3-8b", (("n_heads", 8), ("n_kv_heads", 2)) + _NARROW, False),
    # smollm's 9 over 3 heads divide by neither: uneven whole heads (5 and 4
    # on model 2; 3, 2, 2, 2 on model 4) cut from the leaves read whole, the
    # MLP and the vocab split
    "heads-whole": ("smollm-135m", (("n_heads", 9), ("n_kv_heads", 3), ("d_model", 144),
                                    ("d_ff", 256)), False),
    # 3 query and 3 KV heads: 2 and 1 on model 2; on model 4 one process
    # holds none (its share of every sum is zeros, no attention launched)
    "heads-fewer": ("llama3-8b", (("n_heads", 3), ("n_kv_heads", 3), ("d_model", 192),
                                  ("d_ff", 256)), False),
    # 509 divides by neither: the logits stay whole
    "vocab-whole": ("llama3-8b", (("vocab", 509),) + _NARROW, False),
    # whisper: the encoder's, the decoder's and the cross attention by heads,
    # the GELU MLP (its bias after the sum), the logits tied to the embedding
    "tied-vocab": ("whisper-small", _NARROW, False),
    # whisper with 6 heads: 3 a process on model 2, 2, 1, 2, 1 on model 4, in
    # the encoder's, the decoder's and the cross attention
    "whisper-uneven": ("whisper-small", _WHISPER6, False),
    # the mLSTM by value columns of its one head (dv < dk in mlstm_scan), the
    # sLSTM by channels
    "xlstm-one-head": ("xlstm-125m", _XLSTM1, False),
}
#: the tensor-parallel cases' dtype (``PLACED_TOL``'s tolerances): the
#: one-head mLSTM's ``bi`` gradient is a near-cancelling sum over the tokens
#: (1.2e-6 against ``wi``'s 0.36), whose four processes' float32 shares sum
#: in another order than one process's, so that case is held in float64
TP_DTYPE = {"xlstm-one-head": "f64"}


#: serving on both PLACED worlds, 4 prompts (2 a data block, replicated
#: over model) unless SERVE_OPTS says otherwise: (arch reduced, its config
#: overrides, the cache's width, the prompt's length); then 6 greedy steps.
#: The cache's ``KVLayout`` on model 2 and model 4 in :data:`SERVE_KINDS`
_WIDE = (("n_heads", 12), ("n_kv_heads", 3), ("d_model", 192), ("d_ff", 256))
SERVE_CASES = {
    # query and KV heads divide by 2 and 4
    "heads": ("llama3-8b", (("n_heads", 8), ("n_kv_heads", 4)) + _NARROW, 16, 5),
    # smollm's 9 over 3 heads: the cache by slots, the attention whole
    "seq-smollm": ("smollm-135m", (("n_heads", 9), ("n_kv_heads", 3), ("d_model", 144),
                                   ("d_ff", 256)), 16, 5),
    # 12 over 3 heads: the cache by slots, the query heads split (each process
    # reading its KV heads unevenly), the new token's q, k, v gathered
    "seq": ("llama3-8b", _WIDE, 16, 5),
    # 9 slots divide by neither 2 nor 4: the cache whole, the query heads split
    "whole": ("llama3-8b", _WIDE, 9, 5),
    # a ring of 4 slots (2 or 1 a process), written past its wrap twice
    "ring": ("llama3-8b", _WIDE, 4, 5),
    # paper-moe-8e: 4 KV heads, EP 4; a prompt of 8 (64 tokens: the expert
    # layer splits the model group's rows), decode steps of 4 (masked)
    "moe": ("paper-moe-8e", (), 16, 8),
    # paper-moe-8e where its capacity drops (SERVE_OPTS): 5 prompts, which
    # data 2 does not divide, so every process holds all 5 (the prefill's 40
    # tokens split over the model group, each decode step's 5 on the masked
    # branch), and the data replicas repeat each drop
    "moe-drop": ("paper-moe-8e", (), 16, 8),
    # zamba2 with 4 SSM heads (one Mamba layer, one call of the shared
    # block): the conv and SSM caches by SSM heads, the shared block's KV
    # cache by heads
    "zamba2": ("zamba2-1.2b", (("ssm_heads", 4),), 16, 5),
    # whisper on 6 heads: its self caches (a ring of 4 slots, written past
    # its wrap twice) by heads on model 2, by slots on model 4 (2, 1, 2, 1
    # heads: uneven heads past the wrap), the cross attention on the
    # process's heads over its rows' encoder states
    "whisper": ("whisper-small", _WHISPER6, 4, 5),
    # xLSTM, 4 mLSTM heads of 64: 2 whole heads a process on model 2, one on
    # model 4; the mLSTM states by those heads, the sLSTM's by channels
    "xlstm": ("xlstm-125m", (), 16, 5),
    # one mLSTM head: its states' value columns split (C [B, 1, 128, 64 or 32])
    "xlstm-one-head": ("xlstm-125m", _XLSTM1, 16, 5),
}
#: the cache's ``KVLayout`` kind on model 2 and model 4 ("state" for xLSTM,
#: which holds no KV cache, only recurrent states)
SERVE_KINDS = {"heads": ("heads", "heads"), "seq-smollm": ("seq", "seq"), "seq": ("seq", "seq"),
               "whole": ("whole", "whole"), "ring": ("seq", "seq"), "moe": ("heads", "heads"),
               "moe-drop": ("heads", "heads"), "zamba2": ("heads", "heads"),
               "whisper": ("heads", "seq"), "xlstm": ("state", "state"),
               "xlstm-one-head": ("state", "state")}
#: a case's batch, the expert layer's capacity factor and chunk (a chunk of
#: one token, at 0.25, gives a rank's 2 assignments of a decode step one
#: slot a destination)
SERVE_OPTS = {"moe-drop": dict(B=5, capacity=0.25, chunk=1)}
SERVE_STEPS, SERVE_BATCH = 6, 4


def serve_opts(case) -> dict:
    return dict(dict(B=SERVE_BATCH, capacity=8.0, chunk=4), **SERVE_OPTS.get(case, {}))


def placed_tokens(P, arch) -> int:
    return PLACED[P][2] if j_get_config(arch).n_experts else 32


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


@functools.lru_cache(maxsize=None)
def _jax_rows_model(arch, capacity=8.0, over=()):
    """The reference's model of ``dist_checks.rows_inputs``' config and its
    seed-0 weights (the same for every batch)."""
    cfg, _, _ = dist_checks.rows_inputs(arch, capacity=capacity, over=over)
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **dict(over))
    if jcfg.n_experts:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=capacity)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jmodel = j_build_model(jcfg, J_SINGLE)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def jax_serve_tree(arch, over=()):
    """The reference's seed-0 weights of ``dist_checks.serve_config``'s
    config, as numpy arrays."""
    _, jparams = _jax_rows_model(arch, 8.0, over)
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jparams)


def jax_rows_ref(arch, B=2, capacity=8.0, S=32, over=()):
    """The reference's seed-0 weights for ``dist_checks.rows_inputs``' config
    (with the overrides ``over``), and its single-device loss on that batch
    (once for each batch, however the arguments are passed)."""
    return _jax_rows_ref(arch, B, capacity, S, over)


@functools.lru_cache(maxsize=None)
def _jax_rows_ref(arch, B, capacity, S, over):
    _, _, batch = dist_checks.rows_inputs(arch, B, S, capacity=capacity, over=over)
    jmodel, jparams = _jax_rows_model(arch, capacity, over)
    jbatch = {k: jnp.asarray(v.numpy() if v.is_floating_point() else
                             v.numpy().astype(np.int32)) for k, v in batch.items()}
    loss = float(jmodel.loss(jparams, jbatch))
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), jparams), loss


def _cases(P):
    cases = []
    for n, (_, G) in GEOMETRIES.items():
        if n % P or (n == 4 and P != 2):
            continue
        for dt in dist_checks.DTYPES:
            cases.append((f"exchange-n{n}-{dt}", "exchange", dict(n=n, G=G, dtype=dt)))
        cases.append((f"baseline-n{n}", "baseline", dict(n=n)))
        cases.append((f"layer-n{n}", "layer", dict(n=n, G=G, **LAYER)))
    if P in (2, 4):
        cases.append(("masked-n4", "masked", dict(n=4, G=2)))
    if P == 2:
        cases.append(("train-ep1", "train", dict(tree=jax_train_ref()[0], data=2, model=1,
                                                 ep_size=1)))
    if P in PLACED:
        data, model, _ = PLACED[P]
        for arch in PLACED_ARCHS:
            S = placed_tokens(P, arch)
            cases.append((f"placed-{arch}", "rows", dict(
                arch=arch, data=data, model=model, S=S, steps=PLACED_STEPS,
                tree=jax_rows_ref(arch, S=S)[0], dtype=PLACED_DTYPE.get(arch, "f32"))))
        for name, (arch, over, remat) in TP_CASES.items():
            cases.append((f"tp-{name}", "rows", dict(
                arch=arch, data=data, model=model, steps=PLACED_STEPS, over=over,
                remat=remat, tree=jax_rows_ref(arch, over=over)[0],
                dtype=TP_DTYPE.get(name, "f32"))))
        for name, (arch, over, width, prompt) in SERVE_CASES.items():
            cases.append((f"serve-{name}", "serve", dict(
                arch=arch, over=over, data=data, model=model, P=prompt, steps=SERVE_STEPS,
                width=width, tree=jax_serve_tree(arch, over), **serve_opts(name))))
    if P == 4:
        cases.append(("gather", "gather", {}))
        read, _ = single_ckpt()
        cases.append(("ckpt", "ckpt", dict(write=_ckpt_dir("world"), read=read)))
        for arch in ROWS_ARCHS:
            cases.append((f"rows-{arch}", "rows", dict(arch=arch, tree=jax_rows_ref(arch)[0])))
        cases.append(("rows-overflow", "rows", dict(
            B=1, capacity=ROWS_OVERFLOW,
            tree=jax_rows_ref("paper-moe-8e", 1, ROWS_OVERFLOW)[0])))
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


def _geometries(worlds):
    return [(P, n) for P in worlds for n in GEOMETRIES
            if n % P == 0 and (n != 4 or P == 2)]


def exchange_params(worlds):
    return [pytest.param(P, n, dt, mode, id=f"P{P}-n{n}-{dt}-{mode}")
            for P, n in _geometries(worlds) for dt in dist_checks.DTYPES
            for mode in dist_checks.MODES]


def params_for(kind, worlds):
    return [pytest.param(P, n, id=f"P{P}-n{n}-{kind}") for P, n in _geometries(worlds)]


@functools.lru_cache(maxsize=None)
def stacked_exchange(n, dt, mode):
    G = GEOMETRIES[n][1]
    x_all, counts = dist_checks.exchange_inputs(n, 16, 32, 0, dt)
    comm = NimbleAllToAll(n, G, max_chunks=16, chunk_bytes=32 * 4, mode=mode)
    y, r = comm(torch.as_tensor(x_all).to(dist_checks.DTYPES[dt]), torch.as_tensor(counts))
    plan = comm.plan_from_counts(torch.as_tensor(counts))
    return y.float().numpy(), r.numpy(), dist_checks.plan_digest(plan), x_all, counts


def check_exchange(world, n, dt, mode):
    """``y`` and ``recv`` bit-exact against the stacked executor and the
    oracle, the same plan on every process, messages sent across processes."""
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


def check_baseline(world, n):
    """``baseline_all_to_all`` against the oracle (the padded buffers moved as
    they are)."""
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


def check_layer(world, n):
    """The MoE layer (router, dispatch, grouped FFN, combine) forward and its
    gradients against the stacked path's, within 1e-5 of each one's largest
    value (f32 sums over fewer rows, then an all_reduce)."""
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


def check_masked(world):
    """3 tokens on every process (4 EP ranks, 2 or 1 a process): the sum over
    the model group forward, and its backward a sum too, so that the world's
    ``1 / P`` shares give the stacked path's gradients (f32, 1e-6)."""
    cfg = dist_checks.layer_config()
    p, x, cot = dist_checks.layer_inputs(cfg, 1, 3)
    ctx = ParallelContext(ep_size=4, group_size=2, moe_chunk_tokens=4, device="cpu")
    want = dist_checks.layer_grads(make_moe_ffn(cfg, ctx), p, x, cot)
    got = world["masked-n4"]
    for g in got:
        _close(g["y"], want["y"], 1e-6)                 # the all-reduced sum, everywhere
        assert abs(g["aux"] - want["aux"]) <= 1e-6 * abs(want["aux"])
    # the replicated tokens and router: each process's share, summed
    for k in ("x", "router"):
        _close(np.sum([g[k] for g in got], axis=0), want[k], 1e-6)
    # the expert leaves: each process's block of experts
    for k in ("wg", "wu", "wd"):
        _close(np.concatenate([g[k] for g in got]), want[k], 1e-6)


@functools.lru_cache(maxsize=None)
def stacked_train(ep_size=4):
    tree, _ = jax_train_ref()
    cfg = selftest.ep_train_config()
    ctx = ParallelContext(ep_size=ep_size, group_size=2, moe_mode="nimble", device="cpu")
    params = params_from_jax(tree, cfg, ctx)
    loss, grads = loss_and_grads(build_model(cfg, ctx), params,
                                 selftest.ep_train_batch(cfg, "cpu"))
    return float(loss), [g.numpy() for g in leaves(grads)], params


def hold_train(got, ep_size):
    """The EP train step's loss within 1e-6 relative and every gradient leaf
    within 1e-5 of its largest value against the stacked EP ``ep_size`` path."""
    loss, grads, params = stacked_train(ep_size)
    assert all(g["dropped"] == 0 for g in got)
    for g in got:
        assert abs(g["loss"] - loss) <= 1e-6 * abs(loss)
    full = selftest.assemble_grads(got, params)
    assert len(full) == len(grads)
    for a, b in zip(full, grads):
        _close(a, b)


@functools.lru_cache(maxsize=None)
def single_rows(arch, B=2, capacity=8.0, S=32, steps=0, over=(), remat=False, dtype="f32"):
    """The single-process step on the whole batch (EP 4 stacked for moe),
    from the reference's weights: (loss, drops, gradient leaves, the
    parameters it started from); with ``steps``, also (each step's loss and
    norm, the parameter leaves after them) at ``dist_checks.OPT``; ``over``,
    ``remat`` and ``dtype`` as ``dist_checks.rows`` takes them."""
    cfg, ep_size, batch = dist_checks.rows_inputs(arch, B, S, capacity=capacity, over=over)
    dt = dist_checks.FLOATS[dtype]
    ctx = ParallelContext(ep_size=ep_size, group_size=2, moe_mode="nimble",
                          moe_chunk_tokens=4, device="cpu", remat=remat, param_dtype=dt,
                          compute_dtype=dt)
    model = build_model(cfg, ctx)
    params = params_from_jax(jax_rows_ref(arch, B, capacity, S, over)[0], cfg, ctx)
    stats = {} if cfg.n_experts else None
    loss, grads = loss_and_grads(model, params, batch, stats=stats)
    out = (float(loss), int(stats["dropped"]) if stats else 0,
           [g.numpy() for g in leaves(grads)], params)
    if not steps:
        return out
    step = make_train_step(model, adamw.AdamWConfig(**dist_checks.OPT))
    p = params_from_jax(jax_rows_ref(arch, B, capacity, S, over)[0], cfg, ctx)
    state, metrics = adamw.init(p), []
    for _ in range(steps):
        p, state, m = step(p, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return out + (metrics, [t.numpy() for t in leaves(p)])


def check_placed(world, arch):
    """Every leaf and both AdamW moments held as blocks by the full specs, 2
    sequences on (data 2, model 2) or (data 2, model 4): the loss, the
    gradients put together from the blocks, two steps' losses and norms and
    the parameters after them against one process; the loss against the JAX
    package's single-device step; the bytes held."""
    from repro_torch.sharding.specs import at_path, block_shape, build_param_specs, leaf_paths

    P = len(world[f"placed-{arch}"])
    data, model, _ = PLACED[P]
    S = placed_tokens(P, arch)
    dtype = PLACED_DTYPE.get(arch, "f32")
    ltol, tol = PLACED_TOL[dtype]
    loss, dropped, grads, params, metrics, after = single_rows(
        arch, S=S, steps=PLACED_STEPS, dtype=dtype)
    _, jloss = jax_rows_ref(arch, S=S)
    got = world[f"placed-{arch}"]
    sizes = {"data": data, "model": model}
    specs = build_param_specs(params, sizes)
    held = 0
    for path, t in leaf_paths(params):
        spec = at_path(specs, path)
        moment = max(t.element_size(), 4)            # AdamW's m and v: at least float32
        held += int(np.prod(block_shape(t.shape, spec, sizes))) * (t.element_size()
                                                                    + 2 * moment)
    for g in got:
        assert g["rows"]["replicas"] == model and not g["rows"]["split_over_model"]
        assert abs(g["loss"] - loss) <= ltol * abs(loss)
        assert np.isfinite(g["loss"]) and abs(g["loss"] - jloss) < 5e-2
        assert g["dropped"] == dropped == 0
        assert g["held"] == held
        # the first step's loss is the one held above; each step's loss and
        # norm as the gradients (the second starts from parameters that
        # differ by the summation order)
        for (lw, nw), (lg, ng) in zip(metrics, g["metrics"]):
            assert abs(lg - lw) <= tol * abs(lw) and abs(ng - nw) <= tol * abs(nw)
    for key, want in (("grads", grads), ("params", after)):
        full = selftest.assemble_grads(got, params, key)
        assert len(full) == len(want)
        for a, b in zip(full, want):
            assert a.dtype == b.dtype == {"f32": np.float32, "f64": np.float64}[dtype]
            _close(a, b, tol)


def _tp_launches(arch, over, model, remat=False):
    """What the first step launches under TP use on a model axis of
    ``model`` (``sharding/tp.py``), by the rules stated here: (the leaves
    that keep their "model" block, as "a/b/c" paths, a stacked leaf's
    layer dim folded; the sums over the model group; the loss's maxes).
    Attention keeps ``wq``/``bq``/``wo`` where the query heads divide and
    ``wk``/``wv``/``bk``/``bv`` where the KV heads divide too, a Mamba layer
    its channel leaves (``conv_w``, ``conv_b``, ``gate_norm``, ``out_proj``)
    where its SSM heads divide; a dense MLP and ``lm_head`` keep theirs
    where "model" splits them (d_ff, vocab).  An mLSTM layer keeps ``wv``,
    ``wg``, ``gate_norm`` and ``wo`` (its value columns) where the model
    group divides d into blocks of whole heads or of one head's columns,
    and ``wq``/``wk``/``wi``/``wf`` too where it divides the heads; an
    sLSTM layer keeps ``wz``, ``wi``, ``wf``, ``wo_gate`` and ``down`` (its
    channels) where it divides d.  Every attention sums its
    output once, on whole heads or uneven ones (the moe family's attention
    only; zamba2 at each call of its shared block), a dense
    MLP where d_ff divides, a Mamba layer twice where its SSM heads divide
    (``gate_norm``'s sum of squares, ``out_proj``'s output), an mLSTM
    layer twice on its value columns (the same two), an sLSTM layer once
    on its channels (``down``'s output, after one gather of ``h``), the
    loss once where the vocab splits; remat's recompute reruns the
    attention's sum, not the MLP's: the block's last op, whose output no
    recomputed activation needs.  -> (kept, sums, maxes, gathers), the
    last the group gathers of activations (the sLSTM's ``h``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.hybrid import n_attn_calls, n_mamba_layers
    from repro_torch.models.registry import family
    from repro_torch.models.xlstm import is_slstm_layer
    from repro_torch.sharding.specs import at_path, build_param_specs, leaf_paths
    from repro_torch.sharding.tp import value_columns

    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(over))
    attention = ("attn", "self_attn", "cross_attn")
    shapes = family(cfg).param_shapes(cfg)
    specs = build_param_specs(shapes, {"data": 2, "model": model})
    heads = cfg.n_heads % model == 0
    kv = heads and cfg.n_kv_heads % model == 0
    ssm = bool(cfg.ssm_heads) and cfg.ssm_heads % model == 0
    xl = cfg.arch_type == "ssm"
    mlstm = xl and value_columns(cfg.n_heads, cfg.d_model // cfg.n_heads, model, 0) is not None
    slstm = xl and cfg.d_model % model == 0
    kept = set()
    for path, _ in leaf_paths(shapes):
        name, parent = path[-1], path[-2] if len(path) > 1 else None
        if "model" not in at_path(specs, path):
            continue
        if parent in attention and heads and (name in ("wq", "bq", "wo") or kv):
            kept.add("/".join(map(str, path)))
        if parent == "mlp" or path == ("lm_head",):
            kept.add("/".join(map(str, path)))
        if parent == "mamba" and ssm and name in ("conv_w", "conv_b", "gate_norm",
                                                  "out_proj"):
            kept.add("/".join(map(str, path)))
        if xl and path[0] == "blocks":
            if is_slstm_layer(cfg, path[1]):
                keep = slstm and name in ("wz", "wi", "wf", "wo_gate", "down")
            else:
                keep = mlstm and (name in ("wv", "wg", "gate_norm", "wo")
                                  or heads and name in ("wq", "wk", "wi", "wf"))
            if keep:
                kept.add("/".join(map(str, path)))
    mlp = cfg.d_ff % model == 0 if cfg.d_ff else False
    vocab = int("lm_head" in kept or "lm_head" not in shapes and cfg.vocab % model == 0)
    if cfg.arch_type == "audio":          # encoder: attention, MLP; decoder: two, MLP
        return kept, (cfg.n_enc_layers * (1 + int(mlp))
                      + cfg.n_layers * (2 + int(mlp)) + vocab), vocab, 0
    if cfg.arch_type == "hybrid":
        return kept, (n_attn_calls(cfg) * (1 + int(mlp))
                      + n_mamba_layers(cfg) * 2 * int(ssm) + vocab), vocab, 0
    if xl:
        n_s = sum(is_slstm_layer(cfg, i) for i in range(cfg.n_layers))
        n_m = cfg.n_layers - n_s
        return kept, 2 * n_m * int(mlstm) + n_s * int(slstm) + vocab, vocab, n_s * int(slstm)
    if cfg.arch_type == "moe":
        per, calls = 1, cfg.n_layers
    else:
        per, calls = 1 + int(mlp) + int(remat), cfg.n_layers
    return kept, calls * per + vocab, vocab, 0


def check_placed_tp(world, arch):
    """The placed cases' first step (2 sequences, the rows replicated over
    model) on (data 2, model 2) and (data 2, model 4): no leaf that keeps
    its "model" block is gathered over "model" (``embed``, split on d, is),
    and the sums over the group, the loss's maxes and the activations'
    gathers are as :func:`_tp_launches` counts them.  zamba2 shares its
    work too: its shared block by heads (4 over 2 and 4), its logits by
    vocab, its Mamba layer by SSM heads on model 2, whose ``in_proj`` it
    reads whole; its 2 SSM heads do not divide model 4, where the Mamba
    layer's leaves are read whole.  xLSTM's mLSTM layer by value columns
    (2 whole heads of 4 on model 2, one on model 4), its ``norm``, ``bi``,
    ``bf`` read whole; its sLSTM layer by channels, ``up`` and ``norm``
    read whole."""
    got = world[f"placed-{arch}"]
    _, model, _ = PLACED[len(got)]
    kept, sums, maxes, gathers = _tp_launches(arch, (), model)
    assert "lm_head" in kept
    hybrid = arch == "zamba2-1.2b"
    for g in got:
        launches = g["launches"]
        assert launches["sum"] == sums and launches["max"] == maxes
        assert launches["gather"] == gathers
        assert not kept & set(launches["model_gathers"])
        assert launches["model_gathers"]["embed"] == 1
        if hybrid:
            assert "shared_attn/attn/wq" in kept and "lm_head" not in launches["model_gathers"]
            mamba = {k for k in launches["model_gathers"] if k.startswith("mamba/")}
            assert mamba == ({"mamba/in_proj"} if model == 2 else
                             {"mamba/conv_w", "mamba/conv_b", "mamba/gate_norm",
                              "mamba/out_proj"})
            assert ("mamba/out_proj" in kept) == (model == 2)
        if arch == "xlstm-125m":
            assert {k for k in kept if k.startswith("blocks/")} == {
                "blocks/0/wq", "blocks/0/wk", "blocks/0/wv", "blocks/0/wi", "blocks/0/wf",
                "blocks/0/wg", "blocks/0/gate_norm", "blocks/0/wo", "blocks/1/wz",
                "blocks/1/wi", "blocks/1/wf", "blocks/1/wo_gate", "blocks/1/down"}
            assert {k for k in launches["model_gathers"] if k.startswith("blocks/")} == {
                "blocks/1/up"}
            assert gathers == 1


def check_tp_train(world, case):
    """The tensor-parallel cases, 2 sequences on (data 2, model 2) and (data
    2, model 4), from the JAX package's weights: the loss within 1e-6
    relative and each gradient leaf within 1e-5 of its largest value
    against one process, two AdamW steps' losses, norms and parameters
    within 1e-5 (float64: 1e-12 and 1e-9, ``TP_DTYPE``); the loss within
    5e-2 of the JAX package's single-device step.  The launches: the sums,
    maxes and gathers of :func:`_tp_launches`, and over "model" only the
    leaves that do not keep their block, each
    layer once (``embed`` once; ``wk``/``wv`` where the KV heads do not
    divide; every attention leaf where the query heads do not; whisper's
    tied ``embed`` at both its reads, ``dec_pos`` once; the one-head
    mLSTM's ``wq`` and ``wk`` and the sLSTM's ``up``)."""
    arch, over, remat = TP_CASES[case]
    got = world[f"tp-{case}"]
    data, model, _ = PLACED[len(got)]
    dtype = TP_DTYPE.get(case, "f32")
    ltol, tol = PLACED_TOL[dtype]
    loss, dropped, grads, params, metrics, after = single_rows(
        arch, steps=PLACED_STEPS, over=over, remat=remat, dtype=dtype)
    _, jloss = jax_rows_ref(arch, over=over)
    kept, sums, maxes, gathers = _tp_launches(arch, over, model, remat)
    cfg = dict(over)
    heads, kv = cfg.get("n_heads", 4), cfg.get("n_kv_heads", 4)
    whole = (("wq", "wk", "wv", "wo") if heads % model else
             ("wk", "wv") if kv % model else ())
    audio = arch == "whisper-small"
    top = {"embed": 2, "dec_pos": 1} if audio else {"embed": 1}
    subtrees = ("enc/attn", "dec/self_attn", "dec/cross_attn") if audio else ("blocks/attn",)
    gathered = dict({f"{t}/{k}": 2 for t in subtrees for k in whole}, **top)
    if arch == "xlstm-125m":     # one mLSTM head (wi/wf [d, 1]: not split), an sLSTM layer
        gathered = {"blocks/0/wq": 1, "blocks/0/wk": 1, "blocks/1/up": 1, **top}
    assert maxes == (case != "vocab-whole")
    for g in got:
        assert g["rows"]["replicas"] == model and not g["rows"]["split_over_model"]
        assert abs(g["loss"] - loss) <= ltol * abs(loss)
        assert np.isfinite(g["loss"]) and abs(g["loss"] - jloss) < 5e-2
        for (lw, nw), (lg, ng) in zip(metrics, g["metrics"]):
            assert abs(lg - lw) <= tol * abs(lw) and abs(ng - nw) <= tol * abs(nw)
        assert g["launches"] == {"sum": sums, "max": maxes, "gather": gathers,
                                 "model_gathers": gathered}
    for key, want in (("grads", grads), ("params", after)):
        full = selftest.assemble_grads(got, params, key)
        assert len(full) == len(want)
        for a, b in zip(full, want):
            _close(a, b, tol)


@functools.lru_cache(maxsize=None)
def single_serve(case):
    """``dist_checks.serve_run`` of ``case`` in one process, without a mesh,
    from the JAX package's weights, which the world takes too."""
    arch, over, width, prompt = SERVE_CASES[case]
    opts = serve_opts(case)
    cfg, ep_size = dist_checks.serve_config(arch, over, opts["capacity"])
    ctx = dist_checks._ctx(None, ep_size, "cpu", opts["chunk"])
    model = build_model(cfg, ctx)
    params = params_from_jax(jax_serve_tree(arch, over), cfg, ctx)
    prompts = torch.as_tensor(dist_checks.serve_prompts(cfg, opts["B"], prompt))
    frames = dist_checks.serve_frames(cfg, opts["B"])
    return dist_checks.serve_run(model, params, prompts, width, SERVE_STEPS, opts["B"],
                                 None if frames is None else torch.as_tensor(frames))


def _serve_launches(case, model) -> dict:
    """A decode step's collectives over the model group (``sharding/tp.py``),
    by the rules of ``models/layers.py::attention_decode``, summed over the
    run's steps and layers: each attention sums its row-parallel output
    (on whole heads or uneven ones), a dense MLP where d_ff divides (the
    expert layer's sum is its own), a Mamba layer its ``gate_norm`` and its
    output where its SSM heads divide, an mLSTM layer the same two on its
    value columns, an sLSTM layer one gather of ``h`` and ``down``'s sum
    on its channels; a cache split by slots takes one
    max and one sum to combine its blocks and one gather of the new token's
    q, k, v.  whisper's decoder layer attends twice (its self cache, then
    the cross attention), and its cache's encoder states are computed once
    (the encoder's attention and MLP a layer)."""
    from repro_torch.models.hybrid import n_attn_calls, n_mamba_layers
    from repro_torch.models.xlstm import is_slstm_layer

    arch, over, _, prompt = SERVE_CASES[case]
    cfg, _ = dist_checks.serve_config(arch, over)
    seq = int(SERVE_KINDS[case][model // 4] == "seq")
    mlp = int(cfg.arch_type != "moe" and cfg.d_ff % model == 0)
    steps = prompt + SERVE_STEPS
    if cfg.arch_type == "hybrid":
        n, mamba = n_attn_calls(cfg) * steps, n_mamba_layers(cfg) * steps
        return {"sum": n * (1 + mlp + seq) + mamba * 2 * int(cfg.ssm_heads % model == 0),
                "max": n * seq, "gather": n * seq}
    if cfg.arch_type == "ssm":
        n_s = sum(is_slstm_layer(cfg, i) for i in range(cfg.n_layers)) * steps
        n_m = cfg.n_layers * steps - n_s
        return {"sum": 2 * n_m + n_s, "max": 0, "gather": n_s}
    n = cfg.n_layers * steps
    cross = int(cfg.arch_type == "audio")
    encoder = cfg.n_enc_layers * (1 + mlp) if cross else 0
    return {"sum": n * (1 + cross + mlp + seq) + encoder, "max": n * seq, "gather": n * seq}


def check_serving(world, case):
    """Serving on (data 2, model 2) and (data 2, model 4), the prompts over
    data where it divides them, replicated over model (``Model.serve_rows``):
    each process holds its blocks of the parameters and of the cache (the
    KV cache by heads, by slots or whole: ``SERVE_KINDS``; xLSTM's states
    by heads, value columns or channels; the shapes of ``shard_cache``'s
    blocks), and its prefill's last logits, the decode steps' logits (f32)
    and greedy tokens are one process's, the logits within 1e-5 of their
    largest value, whole over the vocab on every process of a model group;
    the decode's collectives as :func:`_serve_launches` counts them; the
    world's drops (moe), over the replicas on the data axes, are one
    process's, in the prefill and the decode, and "moe-drop" drops in both.
    Every case but "moe-drop" (whose drops are EP 4's, which one JAX device
    does not have) is also held against the JAX package's prefill and
    ``decode_step`` on one device at ``test_torch_dense.py``'s 1e-4."""
    got = world[f"serve-{case}"]
    data, model, _ = PLACED[len(got)]
    want = single_serve(case)
    B = serve_opts(case)["B"]
    count = data if B % data == 0 else 1
    b = B // count
    for g in got:
        assert g["rows"] == dict(index=g["coord"]["data"] if count > 1 else 0, count=count,
                                 replicas=len(got) // count, split_over_model=False)
        assert g["kind"] == SERVE_KINDS[case][model // 4]
        assert g["cache"] == g["whole"]
        rows = slice(g["rows"]["index"] * b, (g["rows"]["index"] + 1) * b)
        _close(g["prefill"], want["prefill"][rows])
        _close(g["logits"], want["logits"][:, rows])
        assert np.array_equal(g["tokens"], want["tokens"][:, rows])
        assert g["launches"] == _serve_launches(case, model)
    copies = len(got) // count // model          # the data axes' replicas
    for key in ("prefill_dropped", "dropped"):
        assert sum(g[key] for g in got) == copies * want[key], key
        assert (want[key] > 0) == (case == "moe-drop"), key
    if case != "moe-drop":
        jprefill, jlogits = jax_serve(case)
        for g in got:
            rows = slice(g["rows"]["index"] * b, (g["rows"]["index"] + 1) * b)
            _close(g["prefill"], jprefill[rows], 1e-4)
            _close(g["logits"], jlogits[:, rows], 1e-4)


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch, over, prompt):
    """The JAX package's last prefill logits on one device on the serving
    prompts of ``arch`` (with ``over``), ``prompt`` tokens long."""
    cfg, _ = dist_checks.serve_config(arch, over)
    jmodel, jparams = _jax_rows_model(arch, 8.0, over)
    prompts = dist_checks.serve_prompts(cfg, SERVE_BATCH, prompt)
    batch = {"tokens": jnp.asarray(prompts.astype(np.int32))}
    frames = dist_checks.serve_frames(cfg, SERVE_BATCH)
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    forward = jax.jit(functools.partial(jmodel.forward, last_only=True))
    jlogits, _ = forward(jparams, batch)
    return np.asarray(jlogits)[:, -1]


@functools.lru_cache(maxsize=None)
def jax_serve(case):
    """The JAX package's prefill logits and ``decode_step`` logits on one
    device for ``case``, fed the prompts and then one process's greedy
    tokens (which the worlds' equal); whisper's cache holds the encoder
    states of the prompts' frames."""
    arch, over, width, prompt = SERVE_CASES[case]
    cfg, _ = dist_checks.serve_config(arch, over)
    jmodel, jparams = _jax_rows_model(arch, 8.0, over)
    from repro.configs.base import InputShape as JInputShape

    prompts = dist_checks.serve_prompts(cfg, SERVE_BATCH, prompt)
    toks = np.concatenate([prompts, single_serve(case)["tokens"].T], axis=1)
    cache = jmodel.init_cache(SERVE_BATCH, JInputShape("serve", width, SERVE_BATCH, "decode"))
    frames = dist_checks.serve_frames(cfg, SERVE_BATCH)
    if frames is not None:
        from repro.models import encdec as jencdec

        cache["enc_out"] = jax.jit(functools.partial(jencdec.encode, cfg=jmodel.cfg))(
            jparams, jnp.asarray(frames))
    step = jax.jit(jmodel.decode_step)
    out = []
    for j in range(toks.shape[1]):
        logits, cache = step(jparams, cache, jnp.asarray(toks[:, j].astype(np.int32)),
                             jnp.int32(j))
        out.append(np.asarray(logits))
    assert len(out) == prompt + SERVE_STEPS
    return _jax_prefill(arch, over, prompt), np.stack(out)


_TMP = {}


def _ckpt_dir(name: str) -> str:
    """A directory of this module's run for checkpoint ``name``."""
    import atexit
    import shutil
    import tempfile

    if not _TMP:
        _TMP["root"] = tempfile.mkdtemp(prefix="torch-dist-ckpt-")
        atexit.register(shutil.rmtree, _TMP["root"], True)
    return f"{_TMP['root']}/{name}"


@functools.lru_cache(maxsize=None)
def single_ckpt(arch="smollm-135m"):
    """(the directory, the tree) of a one-process checkpoint after one step."""
    from repro_torch.checkpoint import ckpt

    cfg, ep_size, batch = dist_checks.rows_inputs(arch)
    ctx = ParallelContext(ep_size=ep_size, group_size=2, moe_mode="nimble",
                          moe_chunk_tokens=4, device="cpu")
    _, tree = dist_checks.ckpt_tree(cfg, ctx, batch)
    d = _ckpt_dir("single")
    ckpt.save(d, 1, tree)
    return d, tree
