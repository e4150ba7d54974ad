"""Dense llama-family transformer (smollm, tinyllama, llama3, qwen2.5).

Counterpart of ``repro/models/dense.py``: pre-norm GQA + SwiGLU blocks,
RoPE, an optional QKV bias (qwen2.5) and optional sliding-window attention.
Parameters keep the reference's tree: ``blocks`` has a leading layer axis on
every leaf (the reference's ``vmap``-ed block init), so leaves, their order
and checkpoints line up with the reference's one for one.  The forward
loops over the layers where the reference scans them; full-sequence
attention goes through the ``attention`` dispatch (the flash kernel for
``Sq >= 128``), the decode step through the plain ring-buffer attention.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..sharding.context import SINGLE, ParallelContext
from . import layers as L


def param_shapes(cfg: ModelConfig) -> Dict[str, object]:
    """The parameter tree's shapes, keyed as the reference's."""
    Lr, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    shapes = {
        "embed": (cfg.vocab, D),
        "blocks": {
            "ln1": (Lr, D),
            "attn": L.attention_shapes(D, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                       cfg.qkv_bias, lead=(Lr,)),
            "ln2": (Lr, D),
            "mlp": {"wg": (Lr, D, F), "wu": (Lr, D, F), "wd": (Lr, F, D)},
        },
        "final_norm": (D,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab)
    return shapes


def init(seed: int, cfg: ModelConfig, ctx: ParallelContext = SINGLE):
    """Random weights from ``seed`` (the reference's scales, not its values)."""
    dt, dev = ctx.param_dtype, ctx.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    Lr, D = cfg.n_layers, cfg.d_model
    ones = torch.ones((Lr, D), dtype=dt, device=dev)
    params = {
        "embed": L.embed_init(gen, cfg.vocab, D, dt, dev),
        "blocks": {
            "ln1": ones.clone(),
            "attn": L.init_attention(gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                     dt, dev, cfg.qkv_bias, lead=(Lr,)),
            "ln2": ones.clone(),
            "mlp": L.init_swiglu(gen, D, cfg.d_ff, dt, dev, lead=(Lr,)),
        },
        "final_norm": torch.ones((D,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, D, cfg.vocab, dt, dev)
    return params


def _block_fwd(p, x: torch.Tensor, cfg: ModelConfig, window: Optional[int]) -> torch.Tensor:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention_forward(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, window=window)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.swiglu(p["mlp"], h)


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    return x @ (params["embed"].T if head is None else head)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx: ParallelContext = SINGLE,
            *, window: Optional[int] = None, inputs_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V], or [B, 1, V] with ``last_only``
    (the hidden state is sliced before the head).  Full attention unless
    ``window``.  ``inputs_embeds`` [B, S', D], when given, replaces the
    tokens' embeddings (the vlm family's patches + text).  With ``ctx.remat`` each block's activations are recomputed
    in the backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` does."""
    x = params["embed"][tokens] if inputs_embeds is None else inputs_embeds
    x = x.to(ctx.compute_dtype)
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i)
        if ctx.remat and torch.is_grad_enabled():
            x = checkpoint(_block_fwd, p, x, cfg, window, use_reentrant=False)
        else:
            x = _block_fwd(p, x, cfg, window)
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg)


# -- serving ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: ParallelContext = SINGLE):
    return L.init_kv_cache(cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.head_dim,
                           ctx.compute_dtype, ctx.device)


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig,
                ctx: ParallelContext = SINGLE):
    """token [B] at position ``pos`` -> (logits [B, V], cache updated in place)."""
    x = params["embed"][token][:, None, :].to(ctx.compute_dtype)
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i)
        c = {k: v[i] for k, v in cache.items()}
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + L.attention_decode(
            p["attn"], h, c, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.swiglu(p["mlp"], h)
    return _logits(params, x, cfg)[:, 0], cache
