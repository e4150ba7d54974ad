"""MoE transformer (paper-moe-8e): GQA + RoPE blocks with a top-k routed FFN.

Counterpart of ``repro/models/moe.py``.  With ``ctx.ep_size > 1`` the
expert layer runs expert-parallel over stacked ranks: tokens are dispatched
through :class:`~repro_torch.core.moe_comm.MoEDispatcher` (NIMBLE planner +
scheduled multi-path dataplane), every rank's received tokens go through
the grouped FFN in one call, and the outputs are combined back.  The token
layout follows the reference's two ``shard_map`` branches:

  * ``_inner_full`` (token count divisible by ``ep_size``): rank r holds
    the contiguous rows ``[r T/n, (r+1) T/n)``;
  * ``_inner_masked`` (small decode batches): every rank holds every
    token, owns token t when ``t % n == r``, routes only what it owns, and
    the ranks' outputs are summed (the reference's ``psum``).

Parameters keep the reference's tree: ``blocks`` has a leading layer axis,
``wg``/``wu`` are [L, E, D, F] and ``wd`` is [L, E, F, D].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
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


def _router(p, xf: torch.Tensor, cfg: ModelConfig):
    """xf [N, D] -> (top_idx [N,k], top_w [N,k], aux_loss scalar)."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # [N, E]
    top_w, top_idx = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # switch-style load-balance loss
    frac = torch.zeros(cfg.n_experts, dtype=torch.float32, device=xf.device)
    frac = frac.index_add(0, top_idx.reshape(-1),
                          torch.ones(top_idx.numel(), device=xf.device))
    frac = frac / top_idx.numel()
    aux = cfg.n_experts * torch.sum(frac * probs.mean(0))
    return top_idx, top_w, aux


def _moe_local(p, xf, top_idx, top_w, cfg: ModelConfig):
    """Single-device expert compute through the grouped FFN."""
    n, d = xf.shape
    k = cfg.top_k
    y = grouped_ffn(xf.repeat_interleave(k, dim=0), top_idx.reshape(-1),
                    p["wg"], p["wu"], p["wd"], block_tokens=_BLOCK_TOKENS)
    return (y.view(n, k, d) * top_w[..., None].to(y.dtype)).sum(1)


def make_moe_ffn(cfg: ModelConfig, ctx: ParallelContext):
    """Build the MoE FFN: ``apply(p, x [B,S,D]) -> (y, aux, dropped)``."""
    if ctx.ep_size <= 1:
        def apply_local(p, x):
            b, s, d = x.shape
            xf = x.reshape(-1, d)
            ti, tw, aux = _router(p, xf, cfg)
            y = _moe_local(p, xf, ti, tw, cfg)
            dropped = torch.zeros((), dtype=torch.int64, device=x.device)
            return y.reshape(b, s, d).to(x.dtype), aux, dropped
        return apply_local

    n = ctx.ep_size
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
        dispatcher = ctx.session.moe_dispatcher(comm_cfg)
    else:
        dispatcher = MoEDispatcher(comm_cfg)
    epd = dispatcher.cfg.experts_per_device

    def experts(p, recv, e_local):
        """Every rank's received tokens through the grouped FFN, in one call."""
        d = recv.shape[-1]
        rank = torch.arange(n, device=recv.device)[:, None, None, None]
        eg = torch.where(e_local >= 0, e_local + rank * epd, -1)   # global ids
        y = grouped_ffn(recv.reshape(-1, d), eg.reshape(-1), p["wg"], p["wu"],
                        p["wd"], block_tokens=_BLOCK_TOKENS)
        return y.view(recv.shape)

    def inner_full(p, xf, ti, tw):
        N, d = xf.shape
        T, k = N // n, ti.shape[-1]
        recv, e_local, st = dispatcher.dispatch(xf.view(n, T, d), ti.view(n, T, k))
        out = dispatcher.combine(experts(p, recv, e_local), st, tw.view(n, T, k))
        return out.reshape(N, d), st["dropped"]

    def inner_masked(p, xf, ti, tw):
        N, d = xf.shape
        ranks = torch.arange(n, device=xf.device)
        owned = (torch.arange(N, device=xf.device) % n)[None, :] == ranks[:, None]
        recv, e_local, st = dispatcher.dispatch(
            xf.expand(n, N, d), ti.expand(n, *ti.shape), token_valid=owned)
        out = dispatcher.combine(experts(p, recv, e_local), st,
                                 tw.expand(n, *tw.shape))
        return out.sum(0), st["dropped"]                  # the reference's psum

    def apply(p, x):
        b, s, d = x.shape
        xf = x.reshape(-1, d)
        ti, tw, aux = _router(p, xf, cfg)
        inner = inner_full if xf.shape[0] % n == 0 else inner_masked
        y, dropped = inner(p, xf, ti, tw)
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
