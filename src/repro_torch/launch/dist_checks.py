"""The multi-process paths' cases, each run in every process of a world.

    from repro_torch.launch.dist import spawn
    from repro_torch.launch import dist_checks
    out = spawn(dist_checks.run_cases, P, [("x", "exchange", dict(n=8, G=4)), ...])

``run_cases`` runs the named cases in order in each process and returns
``{name: result}``; each result holds this process's block of the outputs
as numpy arrays, which the caller holds against the stacked path (every
rank in one process) and the numpy oracle.  Inputs are made from seeds
here, so the caller makes the same ones (``exchange_inputs``,
``layer_inputs``).  The cases:

  * ``exchange`` — :class:`NimbleAllToAll` in each mode on this process's
    block of ``[n, n, C, E]`` buffers: ``y``, ``recv``, the plan's digest,
    the messages sent a hop;
  * ``baseline`` — :func:`baseline_all_to_all` on the same block;
  * ``layer`` — the MoE layer (``make_moe_ffn``: router, dispatch, grouped
    FFN, combine) on this process's rows, forward and the gradients of
    ``sum(y * cot) + aux / P`` with respect to its tokens, the router and
    its expert leaves;
  * ``masked`` — the layer on tokens replicated over the model group (the
    masked branch): forward, and the gradients of each process's ``1 / P``
    share of ``sum(y * cot) + aux``;
  * ``gather`` — ``sharding/gather.py::GatherLeaf`` on a ``(data 2, model
    P / 2)`` mesh over one axis, two axes of one dim, two dims and no dim:
    the whole leaf, and the block's gradient of ``sum(whole * cot)`` with a
    cotangent of each process's own;
  * ``train`` — the EP train step of reduced granite on a ``(data, model)``
    mesh from a given weight tree (``params_from_jax``);
  * ``rows`` — the train step of a reduced arch on a ``(data, model)`` mesh
    (``rows_inputs``), the parameters placed by the full specs: over data x
    model where that divides the batch, else the rows over data, replicated
    over model (``train/step.py::shard_batch``); its gradient blocks, and
    after ``steps`` AdamW steps the parameter blocks, the norms and the
    bytes held;
  * ``serve`` — serving on a ``(data, model)`` mesh: a prefill's logits and
    a run of decode steps (the prompt, then greedy tokens) on this
    process's rows, its blocks of the parameters and of the KV cache;
    ``serve_fed`` the same at full width in bf16, fed given tokens (the
    card's phase 28b);
  * ``ckpt`` — a checkpoint written by the world (gathered, one writer) and
    one written by a single process, restored into this process's blocks;
    with the most gathered leaves the save held whole at once, and the
    shapes the restore uploaded.

Every case builds its mesh over the whole world: ``(data 1, model P)``
unless it says otherwise.  The functions live in the package so that
spawned children can import them.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

MODES = ("direct", "stripe", "nimble")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: the train cases' parameter and compute dtypes (float64: zamba2's step,
#: whose Mamba gradients are near-cancelling sums that a reordered float32
#: sum moves past 1e-5 of their largest value)
FLOATS = dict(DTYPES, f64=torch.float64)


def exchange_inputs(n: int, C: int, E: int, seed: int, dtype: str):
    """Buffers ``[n, n, C, E]`` (zero past each count, values exact in
    ``dtype``) and counts ``[n, n]``."""
    rng = np.random.default_rng(seed)
    x_all = rng.normal(size=(n, n, C, E)).astype(np.float32)
    counts = rng.integers(0, C + 1, size=(n, n)).astype(np.int32)
    for s in range(n):
        for d in range(n):
            x_all[s, d, counts[s, d]:] = 0.0
    x_all = torch.as_tensor(x_all).to(DTYPES[dtype]).float().numpy()
    return x_all, counts


def rank_block(group, n: int) -> slice:
    """This process's block of ``n`` ranks in ``group`` (all without one)."""
    if group is None:
        return slice(0, n)
    import torch.distributed as dist

    L = n // dist.get_world_size(group)
    r0 = dist.get_rank(group) * L
    return slice(r0, r0 + L)


def plan_digest(plan: torch.Tensor) -> str:
    return hashlib.sha256(plan.cpu().numpy().tobytes()).hexdigest()[:16]


def exchange(group, device, n=8, G=4, C=16, E=32, seed=0, dtype="f32",
             chunk_bytes=None) -> Dict[str, dict]:
    from ..core.dataplane import NimbleAllToAll

    x_all, counts = exchange_inputs(n, C, E, seed, dtype)
    blk = rank_block(group, n)
    out = {}
    for mode in MODES:
        comm = NimbleAllToAll(n, G, max_chunks=C, mode=mode, group=group,
                              chunk_bytes=float(chunk_bytes or E * 4))
        y, r = comm(torch.as_tensor(x_all[blk], device=device).to(DTYPES[dtype]),
                    torch.as_tensor(counts[blk], device=device))
        plan = comm.plan_from_counts(comm.gather_counts(
            torch.as_tensor(counts[blk], device=device)))
        out[mode] = dict(y=y.float().cpu().numpy(), recv=r.cpu().numpy(),
                         plan=plan_digest(plan), dtype=str(y.dtype),
                         messages_per_hop=comm.messages_per_hop)
    return out


def baseline(group, device, n=8, C=16, E=32, seed=0) -> np.ndarray:
    from ..core.dataplane import baseline_all_to_all

    x_all, _ = exchange_inputs(n, C, E, seed, "f32")
    return baseline_all_to_all(torch.as_tensor(x_all[rank_block(group, n)], device=device),
                               group).cpu().numpy()


def layer_config(n_experts: int = 8):
    from ..configs.base import get_config

    return dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                               n_experts=n_experts, top_k=2, d_model=32, d_ff=64,
                               moe_capacity_factor=8.0)


def layer_inputs(cfg, B: int, S: int, seed: int = 0):
    """(params of one MoE layer: router, wg, wu, wd; tokens [B, S, D]; the
    output's cotangent) from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": torch.randn(D, E, generator=g) * D ** -0.5,
         "wg": torch.randn(E, D, F, generator=g) * D ** -0.5,
         "wu": torch.randn(E, D, F, generator=g) * D ** -0.5,
         "wd": torch.randn(E, F, D, generator=g) * F ** -0.5}
    return p, torch.randn(B, S, D, generator=g), torch.randn(B, S, D, generator=g)


def _expert_block(p, group, n_experts) -> dict:
    """The layer's params with the expert leaves cut to this process's block."""
    import torch.distributed as dist

    e = n_experts // dist.get_world_size(group)
    e0 = dist.get_rank(group) * e
    return {k: v if k == "router" else v[e0:e0 + e] for k, v in p.items()}


def layer_grads(apply, p, x, cot, share: float = 1.0) -> dict:
    """``apply``'s output and the gradients of ``sum(y * cot) + share * aux``:
    over processes holding shares of the batch, their objectives sum to the
    stacked one's (the load-balance loss is the global batch's)."""
    live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    xl = x.detach().requires_grad_(True)
    y, aux, dropped = apply(live, xl)
    g = torch.autograd.grad((y * cot).sum() + aux * share,
                            [xl] + [live[k] for k in sorted(live)])
    out = {"y": y.detach().cpu().numpy(), "aux": float(aux.detach()),
           "dropped": int(dropped), "x": g[0].cpu().numpy()}
    out.update({k: t.cpu().numpy() for k, t in zip(sorted(live), g[1:])})
    return out


def _layer_ctx(mesh, n, G, mode, device):
    from ..sharding.context import ParallelContext

    return ParallelContext(mesh=mesh, ep_size=n, group_size=G, moe_mode=mode,
                           moe_chunk_tokens=4, device=str(device))


def _on(device, *ts):
    return [{k: v.to(device) for k, v in t.items()} if isinstance(t, dict) else t.to(device)
            for t in ts]


def layer(group, device, mesh=None, n=8, G=4, B=4, S=16, mode="nimble", seed=0) -> dict:
    from ..models.moe import make_moe_ffn

    cfg = layer_config()
    p, x, cot = _on(device, *layer_inputs(cfg, B, S, seed))
    ctx = _layer_ctx(mesh, n, G, mode, device)
    idx, count = ctx.token_block
    b = B // count
    mine = _expert_block(p, group, cfg.n_experts)
    rows = slice(idx * b, (idx + 1) * b)
    return layer_grads(make_moe_ffn(cfg, ctx), mine, x[rows], cot[rows], 1.0 / count)


def masked(group, device, mesh=None, n=4, G=2, N=3, mode="nimble", seed=0) -> dict:
    """The masked branch: every process holds the same N tokens, and its
    objective is its ``1 / P`` share of the stacked one's."""
    import torch.distributed as dist

    from ..models.moe import make_moe_ffn

    cfg = layer_config()
    p, x, cot = _on(device, *layer_inputs(cfg, 1, N, seed))
    ctx = _layer_ctx(mesh, n, G, mode, device)
    mine = _expert_block(p, group, cfg.n_experts)
    share = 1.0 / dist.get_world_size(group)
    return layer_grads(make_moe_ffn(cfg, ctx), mine, x, cot * share, share)


def gather_inputs(P: int, seed: int = 0):
    """{case: (whole leaf [8, 12, 6], its spec)} and each process's cotangent."""
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(8, 12, 6, generator=g)
    cases = {"one axis": (None, "model", None), "two axes": (("data", "model"), None, None),
             "two dims": ("data", "model", None), "no dim": (None, None, None)}
    cots = [torch.randn(8, 12, 6, generator=g) for _ in range(P)]
    return t, cases, cots


def gather(group, device, data=2, seed=0) -> dict:
    """Each case's whole leaf from this process's block and the block's
    gradient of ``sum(whole * cot)`` (``cot`` this process's own)."""
    import torch.distributed as dist

    from ..sharding.gather import COUNTS, Placement, gather_leaf
    from ..sharding.specs import local_shard, mesh_coord, mesh_sizes
    from .mesh import make_test_mesh

    P = dist.get_world_size()
    mesh = make_test_mesh(P, P // data)
    t, cases, cots = gather_inputs(P, seed)
    sizes, coord = mesh_sizes(mesh), mesh_coord(mesh)
    place = Placement(mesh=mesh)
    out = {"coord": coord}
    for name, spec in cases.items():
        before = dict(COUNTS)
        blk = local_shard(t, spec, sizes, coord).contiguous().to(device).requires_grad_(True)
        whole = gather_leaf(blk, place.steps(spec))
        (g,) = torch.autograd.grad((whole * cots[dist.get_rank()].to(device)).sum(), blk,
                                   allow_unused=True)
        out[name] = dict(whole=whole.detach().cpu().numpy(), grad=None if g is None
                         else g.cpu().numpy(), launches={k: v - before.get(k, 0)
                                                         for k, v in COUNTS.items()})
    return out


def train(group, device, tree=None, data=2, model=4, ep_size=4) -> dict:
    """The selftest's train step (reduced granite, 8 experts, top-2, on
    ``ep_size`` EP ranks in groups of 2) on a ``(data, model)`` mesh from the
    weight tree ``tree`` (numpy, the reference's layout)."""
    from .mesh import make_test_mesh
    from .selftest import ep_train_dist

    return ep_train_dist(device, make_test_mesh(data * model, model), tree, ep_size)


def rows_inputs(arch: str, B: int = 2, S: int = 32, device="cpu", capacity: float = 8.0,
                over=()):
    """(reduced ``arch`` at capacity factor ``capacity`` (8: no overflow at
    chunks of 4 tokens) with the config overrides ``over`` ((field, value)
    pairs), EP 4 for moe, a batch of ``B`` sequences of ``S`` tokens from
    seed 1; the audio and vlm families' stub frames or patches from seed 2)."""
    from ..configs.base import get_config

    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(over))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    from ..data.pipeline import add_modality_stubs

    rng = np.random.default_rng(1)
    arrays = {k: rng.integers(0, cfg.vocab, (B, S)) for k in ("tokens", "labels")}
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in add_modality_stubs(arrays, cfg, 2).items()}
    return cfg, 4 if cfg.n_experts else 1, batch


#: the AdamW settings of the cases' steps: no warm-up, so two steps move
#: every parameter; and an ``eps`` that keeps the update smooth in the
#: gradient: with 1e-8, a gradient at the level of the processes' different
#: summation order (1e-7 of the largest) takes a step of the full learning
#: rate of either sign
OPT = dict(lr=1e-2, warmup_steps=1, eps=1e-3)


def _ctx(mesh, ep_size, device, chunk=4):
    from ..sharding.context import ParallelContext

    return ParallelContext(mesh=mesh, ep_size=ep_size, group_size=2, moe_mode="nimble",
                           moe_chunk_tokens=chunk, device=device)


def _arrays(ts) -> list:
    """Tensors as numpy arrays of at least float32 (float64 kept)."""
    return [t.detach().to(torch.promote_types(t.dtype, torch.float32)).cpu().numpy()
            if isinstance(t, torch.Tensor) else t for t in ts]


def held_bytes(*trees) -> int:
    """Bytes of the tensors under ``trees`` (each its own storage)."""
    from ..tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(list(trees))
               if isinstance(t, torch.Tensor))


def rows(group, device, arch="paper-moe-8e", data=2, model=2, B=2, S=32,
         capacity=8.0, tree=None, steps=0, over=(), remat=False, dtype="f32") -> dict:
    """This process's loss, drops and gradient blocks of one train step's
    ``loss_and_grads`` on a ``(data, model)`` mesh, from seed 0's weights or
    the reference's ``tree`` (numpy, through ``params_from_jax``); with
    ``steps``, its parameter blocks after that many steps (:data:`OPT`), each
    step's loss and norm, and the bytes of parameters and moments held.
    ``over``: config overrides (``rows_inputs``); ``remat``: recompute each
    block in the backward; ``dtype``: the parameters' and the compute's
    (:data:`FLOATS`).  ``launches``: the first step's sums over the
    model group, loss maxes and activation gathers (the sLSTM's ``h``;
    ``sharding/tp.py::COUNTS``), and the gathers over "model" of each leaf
    (``sharding/gather.py::LEAF_GATHERS``)."""
    from ..models.registry import build_model
    from ..optim import adamw
    from ..train.step import loss_and_grads, make_train_step
    from ..tree import leaves
    from ..weights import params_from_jax
    from .mesh import make_test_mesh

    from ..sharding import gather, tp

    cfg, ep_size, batch = rows_inputs(arch, B, S, device, capacity, over)
    mesh = make_test_mesh(data * model, model)
    ctx = dataclasses.replace(_ctx(mesh, ep_size, device), remat=remat,
                              param_dtype=FLOATS[dtype], compute_dtype=FLOATS[dtype])
    m = build_model(cfg, ctx)
    stats = {} if cfg.n_experts else None
    params = m.init(0) if tree is None else params_from_jax(tree, cfg, ctx)
    sums, gathers = dict(tp.COUNTS), dict(gather.LEAF_GATHERS)
    loss, grads = loss_and_grads(m, params, batch, stats=stats)
    launches = {k: tp.COUNTS[k] - sums.get(k, 0) for k in ("sum", "max", "gather")}
    launches["model_gathers"] = {p: n - gathers.get((p, a), 0)
                                 for (p, a), n in gather.LEAF_GATHERS.items()
                                 if a == "model" and n > gathers.get((p, a), 0)}
    out = dict(loss=float(loss), dropped=int(stats["dropped"]) if stats else 0,
               grads=_arrays(leaves(grads)), launches=launches,
               coord=dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
               rows=dataclasses.asdict(ctx.row_block(B)))
    if steps:
        step = make_train_step(m, adamw.AdamWConfig(**OPT))
        state = adamw.init(params)
        out["held"] = held_bytes(params, state.m, state.v)
        metrics = []
        for _ in range(steps):
            params, state, met = step(params, state, batch)
            metrics.append((float(met["loss"]), float(met["grad_norm"])))
        out.update(params=_arrays(leaves(params)), metrics=metrics)
    return out


def ckpt_tree(cfg, ctx, batch):
    """(the model, {"params", "opt"} after one step (:data:`OPT`) from seed
    0's weights)."""
    from ..models.registry import build_model
    from ..optim import adamw
    from ..train.step import make_train_step

    model = build_model(cfg, ctx)
    params = model.init(0)
    params, state, _ = make_train_step(model, adamw.AdamWConfig(**OPT))(
        params, adamw.init(params), batch)
    return model, {"params": params, "opt": state}


def ckpt(group, device, arch="smollm-135m", data=2, model=2, write=None, read=None) -> dict:
    """The world's tree after one step, saved whole into ``write``
    (``ckpt.save(place=)``), and the single process's checkpoint in ``read``
    restored as this process's blocks; both as arrays in leaf order.
    ``held_whole``: the most leaves the save had gathered whole and still
    held at once; ``uploaded``: the shape of each leaf the restore moved to
    ``device``, in leaf order."""
    import weakref

    from ..checkpoint import ckpt as ck
    from ..optim import adamw
    from ..tree import leaves
    from .mesh import make_test_mesh

    cfg, ep_size, batch = rows_inputs(arch, device=device)
    mesh = make_test_mesh(data * model, model)
    m, tree = ckpt_tree(cfg, _ctx(mesh, ep_size, device), batch)
    whole, to_torch = ck._whole, ck._to_torch
    alive, held, uploaded = [], [0], []

    def count_whole(leaf, key, place):
        out = whole(leaf, key, place)
        if out is not leaf:
            alive.append(weakref.ref(out))
            held[0] = max(held[0], sum(r() is not None for r in alive))
        return out

    def record_upload(*a, **kw):
        out = to_torch(*a, **kw)
        uploaded.append(tuple(out.shape))
        return out

    ck._whole, ck._to_torch = count_whole, record_upload
    try:
        ck.save(write, 1, tree, place=m.placement)
        got, _ = ck.restore(read, namedtuple_types={"OptState": adamw.OptState},
                            device=device, place=m.placement)
    finally:
        ck._whole, ck._to_torch = whole, to_torch
    return dict(coord=dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
                written=_arrays(leaves(tree)), restored=_arrays(leaves(got)),
                held_whole=held[0], uploaded=uploaded)


def serve_config(arch: str, over=(), capacity: float = 8.0):
    """(reduced ``arch`` in f32 with the overrides ``over``, at capacity
    factor ``capacity`` (8: no drops), its EP size: 4 for moe, 1 else)."""
    cfg, ep_size, _ = rows_inputs(arch, capacity=capacity, over=over)
    return cfg, ep_size


def serve_prompts(cfg, B: int, P: int) -> np.ndarray:
    """[B, P] prompt tokens from seed 3."""
    return np.random.default_rng(3).integers(0, cfg.vocab, (B, P))


def serve_frames(cfg, B: int):
    """The audio family's stub frames [B, F, d] (float32) from seed 4; ``None``
    for the other families."""
    if cfg.arch_type != "audio":
        return None
    return np.random.default_rng(4).normal(
        size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def encoder_states(model, params, frames: torch.Tensor, batch: int) -> torch.Tensor:
    """The audio family's encoder states of this process's rows' ``frames``
    (of a global ``batch``), placed as serving places that batch."""
    place = model.serve_placement(model.serve_rows(batch))
    return model.mod.encode(params, frames, model.cfg, model.ctx, place)


def shapes(tree, prefix="") -> dict:
    """{"a/b": shape} of a (nested) cache's leaves (a list's by index)."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items
                for k, v in shapes(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


def decode_run(model, params, prompts: torch.Tensor, width: int, steps: int, batch: int,
               stats=None, fed=None, frames=None) -> dict:
    """The prompt [b, P] (this process's rows of a global ``batch``) through
    ``decode_step`` at positions 0 ... P-1 into a cache of ``width`` slots,
    then ``steps`` steps on the greedy tokens, or on ``fed`` [b, steps]
    where given: the logits of every step ([P + steps, b, V], float32 on
    the host) and the tokens it took after the prompt ([steps, b]).
    ``frames`` (the audio family, the rows' [b, F, d]): the cache's encoder
    states are theirs (:func:`encoder_states`), not zeros."""
    from ..configs.base import InputShape

    out, toks = [], []
    with torch.no_grad():
        cache = model.init_cache(batch, InputShape("serve", width, batch, "decode"))
        if frames is not None:
            cache["enc_out"].copy_(encoder_states(model, params, frames, batch))
        for j in range(prompts.shape[1]):
            logits, cache = model.decode_step(params, cache, prompts[:, j], j, stats=stats)
            out.append(logits.float().cpu())
        for j in range(steps):
            toks.append(torch.argmax(logits, dim=-1) if fed is None else fed[:, j])
            logits, cache = model.decode_step(params, cache, toks[-1],
                                              prompts.shape[1] + j, stats=stats)
            out.append(logits.float().cpu())
    return dict(logits=torch.stack(out).numpy(), tokens=torch.stack(toks).cpu().numpy(),
                cache=shapes(cache))


def serve_run(model, params, prompts: torch.Tensor, width: int, steps: int,
              batch: int, frames=None) -> dict:
    """Serving on ``prompts`` [b, P] (this process's rows of a global
    ``batch``; ``frames`` their stub frames, the audio family's): the
    prefill's last logits (``forward(last_only=True)`` on
    ``Model.serve_rows(batch)``), then
    :func:`decode_run`'s greedy steps, and this process's drops (moe) in the
    prefill (``prefill_dropped``) and the decode (``dropped``).
    ``launches``: the decode steps' collectives over the model group
    (``sharding/tp.py::COUNTS``)."""
    from ..sharding import tp

    stats = {} if model.cfg.n_experts else None
    pstats = {} if model.cfg.n_experts else None
    inputs = {"tokens": prompts} if frames is None else {"tokens": prompts, "frames": frames}
    with torch.no_grad():
        prefill, _ = model.forward(params, inputs, last_only=True,
                                   rows=model.serve_rows(batch), stats=pstats)
    before = dict(tp.COUNTS)
    out = decode_run(model, params, prompts, width, steps, batch, stats, frames=frames)
    out.update(prefill=prefill[:, 0].float().cpu().numpy(),
               launches={k: tp.COUNTS[k] - before.get(k, 0) for k in ("sum", "max", "gather")},
               dropped=int(stats.get("dropped", 0)) if stats is not None else 0,
               prefill_dropped=int(pstats.get("dropped", 0)) if pstats is not None else 0)
    return out


def serve_fed(group, device, arch="llama3-8b", seed=0, prompts=None, gprompts=None,
              fed=None, width=16, n_layers=None, frames=None) -> dict:
    """Serving at full width in bf16 on a ``(data 1, model P)`` mesh, with
    ``n_layers`` layers where given: the prefill's last logits on
    ``prompts`` (numpy [B, S], where given), then :func:`decode_run` on
    ``gprompts`` (numpy [B, P]) fed the tokens ``fed`` ([B, steps]);
    ``frames`` (numpy [B, F, d]): the audio family's stub frames of both.
    ``launches``: the kernels' launch counts of the run; ``flash_heads``:
    the flash kernel's launches by their query heads."""
    from ..configs.base import get_config
    from ..kernels import launch_counts, reset_launch_counts
    from ..kernels.flash_attention.ops import LAUNCH_HEADS
    from ..models.registry import build_model
    from ..sharding.context import ParallelContext
    from ..sharding.specs import kv_layout
    from .mesh import make_test_mesh

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    mesh = make_test_mesh()
    bf16 = torch.bfloat16
    ctx = ParallelContext(mesh=mesh, param_dtype=bf16, compute_dtype=bf16, device=device)
    model = build_model(cfg, ctx)
    params = model.init(seed)
    out = dict(kind="state" if cfg.arch_type == "ssm"
               else kv_layout(cfg.n_kv_heads, width, mesh.size()).kind)
    as_t = functools.partial(torch.as_tensor, device=device)
    frames = None if frames is None else as_t(frames).to(bf16)
    reset_launch_counts()
    if prompts is not None:
        batch = {"tokens": as_t(prompts)}
        if frames is not None:
            batch["frames"] = frames
        with torch.no_grad():
            logits, _ = model.forward(params, batch, last_only=True,
                                      rows=model.serve_rows(len(prompts)))
        out["prefill"] = logits[:, 0].float().cpu().numpy()
    out.update(decode_run(model, params, as_t(gprompts), width, fed.shape[1], fed.shape[0],
                          fed=as_t(fed), frames=frames))
    out.update(launches=launch_counts(), flash_heads=dict(LAUNCH_HEADS))
    return out


def serve(group, device, arch="llama3-8b", over=(), data=2, model=2, B=4, P=5, steps=6,
          width=16, tree=None, capacity=8.0, chunk=4) -> dict:
    """Serving on a ``(data, model)`` mesh (:func:`serve_run`) from seed 0's
    weights or the reference's ``tree``, the expert layer at ``capacity``
    and chunks of ``chunk`` tokens: this process's rows of the ``B``
    prompts (``Model.serve_rows``: over data where it divides them,
    replicated over model), its
    blocks of the parameters and the cache.  ``kind``: the cache's
    ``KVLayout`` ("state" for xLSTM, which has recurrent states only);
    ``whole``: the shapes of ``shard_cache``'s blocks of the whole cache,
    which the placed one must have."""
    from ..configs.base import InputShape
    from ..models.registry import build_model
    from ..sharding.specs import kv_layout, shard_cache
    from ..weights import params_from_jax
    from .mesh import make_test_mesh

    cfg, ep_size = serve_config(arch, over, capacity)
    mesh = make_test_mesh(data * model, model)
    ctx = _ctx(mesh, ep_size, device, chunk)
    m = build_model(cfg, ctx)
    params = m.init(0) if tree is None else params_from_jax(tree, cfg, ctx)
    rows = m.serve_rows(B)
    b = B // rows.count
    mine = slice(rows.index * b, (rows.index + 1) * b)
    prompts = torch.as_tensor(serve_prompts(cfg, B, P)[mine], device=device)
    frames = serve_frames(cfg, B)
    if frames is not None:
        frames = torch.as_tensor(frames[mine], device=device)
    out = serve_run(m, params, prompts, width, steps, B, frames)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    whole = build_model(cfg, dataclasses.replace(ctx, mesh=None, device="meta")).init_cache(
        B, InputShape("serve", width, B, "decode"))
    out.update(coord=coord, rows=dataclasses.asdict(rows),
               kind=("state" if cfg.arch_type == "ssm"
                     else kv_layout(cfg.n_kv_heads, width, model).kind),
               whole=shapes(shard_cache(whole, {"data": data, "model": model}, coord=coord)))
    return out


CASES = {"exchange": exchange, "baseline": baseline, "layer": layer, "masked": masked,
         "gather": gather, "train": train, "rows": rows, "ckpt": ckpt, "serve": serve,
         "serve_fed": serve_fed}


def run_cases(rank: int, world: int, cases: List[Tuple[str, str, dict]],
              device: str = "cpu") -> dict:
    """Run ``cases`` (key, case name, keyword arguments) in this process on a
    ``(data 1, model world)`` mesh; -> {key: result}."""
    from .mesh import make_test_mesh

    mesh = make_test_mesh(world, world)
    group = mesh.get_group("model")
    out = {}
    for key, name, kw in cases:
        if name in ("layer", "masked"):
            kw = dict(kw, mesh=mesh)
        out[key] = CASES[name](group, device, **kw)
    return out
