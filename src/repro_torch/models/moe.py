"""MoE transformer (paper-moe-8e): GQA + RoPE blocks with a top-k routed FFN.

Counterpart of ``repro/models/moe.py``.  With ``ctx.ep_size > 1`` the
expert layer runs expert-parallel: tokens are dispatched through
:class:`~repro_torch.core.moe_comm.MoEDispatcher` (NIMBLE planner +
scheduled multi-path dataplane), the received tokens of this process's
block of ranks go through the grouped FFN in one call, and the outputs are
combined back.  Without a mesh every rank is stacked in this process; with
``ctx.mesh`` the process hosts ``L = ep_size / model`` ranks, holds the
expert leaves of its block (``[Lr, E L / n, D, F]``, the expert dim over
"model" as ``sharding/specs.py`` places it) and exchanges with the model
group's other processes.  The branch is the reference's
(``repro/models/moe.py:168-178``), chosen from the global token count:

  * ``inner_full`` (the count divides data x ``ep_size``): each process
    takes tokens of its own, and its rank r the contiguous rows ``[r T/L,
    (r+1) T/L)``.  Where the train step replicates a block of rows over the
    model group (``train/step.py::shard_batch``), each process takes its
    contiguous ``1/m`` share of them, and the outputs are gathered back over
    the model group (:class:`_GatherRows`, whose backward sums the
    cotangent's shares: reduce-scatter);
  * ``inner_masked`` (small decode batches): the tokens are replicated over
    the model group, rank r owns token t when ``t % n == r`` and routes only
    what it owns, and the ranks' outputs are summed (the reference's
    ``psum``: over the block, then ``all_reduce`` over the model group, in
    the forward only; under a gradient across processes it raises).

Without a placement (``rows=None``: serving, the layer alone) the rows are
each process's own and the count is the local one times the world, so
``inner_full`` is taken where the local count divides ``L``.

The router's load-balance loss is the reference's over the global batch:
with a mesh its two means are summed over the processes holding distinct
tokens (every process holds as many).

Parameters keep the reference's tree: ``blocks`` has a leading layer axis,
``wg``/``wu`` are [L, E, D, F] and ``wd`` is [L, E, F, D].
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.moe_comm import MoECommConfig, MoEDispatcher
from ..kernels.grouped_ffn.ops import grouped_ffn
from ..sharding.context import SINGLE, ParallelContext
from . import layers as L

#: the reference's block_tokens for the expert FFN (moe.py:85)
_BLOCK_TOKENS = 64


def param_shapes(cfg: ModelConfig) -> Dict[str, object]:
    """The parameter tree's shapes, keyed as the reference's."""
    Lr, D, E, F = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = L.attention_shapes(D, H, Hkv, dh, cfg.qkv_bias, lead=(Lr,))
    return {
        "embed": (cfg.vocab, D),
        "blocks": {
            "ln1": (Lr, D), "attn": attn, "ln2": (Lr, D),
            "router": (Lr, D, E),
            "wg": (Lr, E, D, F), "wu": (Lr, E, D, F), "wd": (Lr, E, F, D),
        },
        "final_norm": (D,),
        "lm_head": (D, cfg.vocab),
    }


def init(seed: int, cfg: ModelConfig, ctx: ParallelContext = SINGLE):
    """Random weights from ``seed`` (the reference's scales, not its values)."""
    dt, dev = ctx.param_dtype, ctx.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    Lr, D, E, F = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(d_in, d_out, lead=(Lr,)):
        return L.dense_init(gen, d_in, d_out, dt, dev, lead=lead)

    attn = L.init_attention(gen, D, H, Hkv, dh, dt, dev, cfg.qkv_bias, lead=(Lr,))
    ones = torch.ones((Lr, D), dtype=dt, device=dev)
    return {
        "embed": L.embed_init(gen, cfg.vocab, D, dt, dev),
        "blocks": {
            "ln1": ones.clone(), "attn": attn, "ln2": ones.clone(),
            "router": dense(D, E),
            "wg": dense(D, F, (Lr, E)), "wu": dense(D, F, (Lr, E)),
            "wd": dense(F, D, (Lr, E)),
        },
        "final_norm": torch.ones((D,), dtype=dt, device=dev),
        "lm_head": dense(D, cfg.vocab, ()),
    }


def _global_mean(t: torch.Tensor, groups) -> torch.Tensor:
    """This process's mean -> the mean over every process of ``groups``
    (each holding as many tokens), with a gradient; ``t`` itself without
    groups."""
    if not groups:
        return t
    t = t * (1.0 / math.prod(dist.get_world_size(g) for g in groups))
    for g in groups:
        t = dist_nn.all_reduce(t, group=g)
    return t


def _router(p, xf: torch.Tensor, cfg: ModelConfig, groups=()):
    """xf [N, D] -> (top_idx [N,k], top_w [N,k], aux_loss scalar).

    ``groups``: the process groups over which the batch's tokens are
    spread; the load-balance loss's means are taken over all of them."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # [N, E]
    top_w, top_idx = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # switch-style load-balance loss
    frac = torch.zeros(cfg.n_experts, dtype=torch.float32, device=xf.device)
    frac = frac.index_add(0, top_idx.reshape(-1),
                          torch.ones(top_idx.numel(), device=xf.device))
    frac = _global_mean(frac / top_idx.numel(), groups)
    aux = cfg.n_experts * torch.sum(frac * _global_mean(probs.mean(0), groups))
    return top_idx, top_w, aux


class _GatherRows(torch.autograd.Function):
    """``x`` [T, ...] of each process of ``group`` -> their concatenation
    [m T, ...] (``all_gather``); the backward sums the cotangent's rows
    ``[j T, (j+1) T)`` over the group into process j's (``reduce_scatter``):
    every process's loss reads all the rows, so each share's gradient is the
    group's sum, not a slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        m = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // m, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def _moe_local(p, xf, top_idx, top_w, cfg: ModelConfig):
    """Single-device expert compute through the grouped FFN."""
    n, d = xf.shape
    k = cfg.top_k
    y = grouped_ffn(xf.repeat_interleave(k, dim=0), top_idx.reshape(-1),
                    p["wg"], p["wu"], p["wd"], block_tokens=_BLOCK_TOKENS)
    return (y.view(n, k, d) * top_w[..., None].to(y.dtype)).sum(1)


def make_moe_ffn(cfg: ModelConfig, ctx: ParallelContext):
    """Build the MoE FFN: ``apply(p, x [B,S,D]) -> (y, aux, dropped)``."""
    group = ctx.model_group
    # the processes holding distinct tokens (sharded over data x model)
    mesh_groups = ctx.data_groups + ((group,) if group is not None else ())
    if ctx.ep_size <= 1:
        if ctx.model_procs > 1:
            raise ValueError(f"{cfg.name}: the mesh splits the experts over "
                             f"{ctx.model_procs} processes; ep_size must be a multiple "
                             f"of that, got {ctx.ep_size}")

        def apply_local(p, x, rows=None):
            b, s, d = x.shape
            xf = x.reshape(-1, d)
            ti, tw, aux = _router(p, xf, cfg, mesh_groups)
            y = _moe_local(p, xf, ti, tw, cfg)
            dropped = torch.zeros((), dtype=torch.int64, device=x.device)
            return y.reshape(b, s, d).to(x.dtype), aux, dropped
        return apply_local

    n = ctx.ep_size
    L = n // ctx.model_procs                 # ranks this process hosts
    r0 = 0 if group is None else dist.get_rank(group) * L
    comm_cfg = MoECommConfig(
        n_devices=n,
        n_experts=cfg.n_experts,
        d_model=cfg.d_model,
        chunk_tokens=ctx.moe_chunk_tokens,
        capacity_factor=cfg.moe_capacity_factor,
        group_size=ctx.group_size,
        alt_frac=ctx.moe_alt_frac,
        mode=ctx.moe_mode,
        payload_dtype=ctx.compute_dtype,
    )
    if ctx.session is not None:
        # endpoint API: the session supplies cost model, planner config,
        # and (when adaptive) runtime telemetry wiring
        dispatcher = ctx.session.moe_dispatcher(comm_cfg, group=group)
    else:
        dispatcher = MoEDispatcher(comm_cfg, group=group)
    epd = dispatcher.cfg.experts_per_device

    def experts(p, recv, e_local):
        """The block's received tokens through the grouped FFN, in one call,
        on the block's experts (ids local to this process's leaves).

        On the CPU it drops the rows the reference's per-rank calls drop:
        rows and experts both grow by the number of ranks, so the ``dense``
        branch's test and its capacity per expert are a rank's; and a block
        of L ranks takes the branch of the call that stacks all n.
        """
        if p["wg"].shape[0] != epd * L:
            raise ValueError(f"expert leaves hold {p['wg'].shape[0]} experts; this "
                             f"process's {L} ranks own {epd * L}")
        d = recv.shape[-1]
        rank = torch.arange(L, device=recv.device)[:, None, None, None]
        eg = torch.where(e_local >= 0, e_local + rank * epd, -1)
        y = grouped_ffn(recv.reshape(-1, d), eg.reshape(-1), p["wg"], p["wu"],
                        p["wd"], block_tokens=_BLOCK_TOKENS, cpu_rule_scale=n // L)
        return y.view(recv.shape)

    def inner_full(p, xf, ti, tw):
        N, d = xf.shape
        T, k = N // L, ti.shape[-1]
        recv, e_local, st = dispatcher.dispatch(xf.view(L, T, d), ti.view(L, T, k))
        out = dispatcher.combine(experts(p, recv, e_local), st, tw.view(L, T, k))
        return out.reshape(N, d), st["dropped"]

    def inner_masked(p, xf, ti, tw):
        N, d = xf.shape
        ranks = r0 + torch.arange(L, device=xf.device)
        owned = (torch.arange(N, device=xf.device) % n)[None, :] == ranks[:, None]
        recv, e_local, st = dispatcher.dispatch(
            xf.expand(L, N, d), ti.expand(L, *ti.shape), token_valid=owned)
        out = dispatcher.combine(experts(p, recv, e_local), st,
                                 tw.expand(L, *tw.shape)).sum(0)
        if L < n:                            # the reference's psum, across processes
            if torch.is_grad_enabled() and out.requires_grad:
                raise RuntimeError(
                    "the masked MoE branch (tokens replicated over the model group, "
                    f"{N} tokens for {L} ranks a process) has no gradient across "
                    "processes; give each process a multiple of its ranks' count of "
                    "tokens")
            dist.all_reduce(out, group=group)
        return out, st["dropped"]

    def apply(p, x, rows=None):
        """``rows``: the batch's ``RowBlock`` (``train/step.py``), or ``None``."""
        b, s, d = x.shape
        xf = x.reshape(-1, d)
        N = xf.shape[0]
        # the model group holds these rows: the global count is N x count,
        # else N x world (and N x world divides data x n iff N divides L)
        shared = rows is not None and not rows.split_over_model and group is not None
        full = N * rows.count % (ctx.data_procs * n) == 0 if shared else N % L == 0
        if full and shared:
            m = ctx.model_procs
            j = dist.get_rank(group)
            share = xf[j * (N // m):(j + 1) * (N // m)]
            ti, tw, aux = _router(p, share, cfg, mesh_groups)
            y, dropped = inner_full(p, share, ti, tw)
            y = _GatherRows.apply(y, group)
        else:
            ti, tw, aux = _router(p, xf, cfg, mesh_groups if full else ctx.data_groups)
            y, dropped = (inner_full if full else inner_masked)(p, xf, ti, tw)
        return y.reshape(b, s, d).to(x.dtype), aux, dropped

    return apply


def _add_dropped(stats: Optional[dict], dropped) -> None:
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + dropped


def _block_fwd(p, x, cfg: ModelConfig, moe_apply, window):
    """One block -> (x, aux, dropped)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention_forward(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, causal=True,
        window=window)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux, dropped = moe_apply(p, h)
    return x + y, aux, dropped


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ParallelContext = SINGLE, *, window=None, last_only: bool = False,
            moe_apply=None, stats: Optional[dict] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] or [B, 1, V], aux_loss scalar).

    ``stats``, when given, accumulates the dispatcher's capacity drops
    under ``"dropped"``.  With ``ctx.remat`` each block's activations are
    recomputed in the backward (``torch.utils.checkpoint``), as the
    reference's ``jax.checkpoint`` does.
    """
    moe_apply = moe_apply or make_moe_ffn(cfg, ctx)
    x = params["embed"][tokens].to(ctx.compute_dtype)
    blocks = params["blocks"]
    auxs = []
    for i in range(blocks["ln1"].shape[0]):
        args = (L.layer(blocks, i), x, cfg, moe_apply, window)
        if ctx.remat and torch.is_grad_enabled():
            x, aux, dropped = checkpoint(_block_fwd, *args, use_reentrant=False)
        else:
            x, aux, dropped = _block_fwd(*args)
        auxs.append(aux)
        _add_dropped(stats, dropped)
    if last_only:
        x = x[:, -1:]                    # slice before lm_head
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], torch.stack(auxs).mean()


# -- serving ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               ctx: ParallelContext = SINGLE):
    return L.init_kv_cache(cfg.n_layers, batch, cfg.n_kv_heads, cache_len,
                           cfg.head_dim, ctx.compute_dtype, ctx.device)


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig,
                ctx: ParallelContext = SINGLE, *, moe_apply=None,
                stats: Optional[dict] = None):
    """token [B] at position ``pos`` -> (logits [B, V], cache updated in place)."""
    moe_apply = moe_apply or make_moe_ffn(cfg, ctx)
    x = params["embed"][token][:, None, :].to(ctx.compute_dtype)
    blocks = params["blocks"]
    for i in range(blocks["ln1"].shape[0]):
        p = L.layer(blocks, i)
        c = {k: v[i] for k, v in cache.items()}
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + L.attention_decode(
            p["attn"], h, c, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        y, _, dropped = moe_apply(p, h)
        x = x + y
        _add_dropped(stats, dropped)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"])[:, 0], cache
