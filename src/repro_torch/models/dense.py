"""Dense llama-family transformer (smollm, tinyllama, llama3, qwen2.5).

Counterpart of ``repro/models/dense.py``: pre-norm GQA + SwiGLU blocks,
RoPE, an optional QKV bias (qwen2.5) and optional sliding-window attention.
Parameters keep the reference's tree: ``blocks`` has a leading layer axis on
every leaf (the reference's ``vmap``-ed block init), so leaves, their order
and checkpoints line up with the reference's one for one.  The forward
loops over the layers where the reference scans them; full-sequence
attention goes through the ``attention`` dispatch (the flash kernel for
``Sq >= 128``), the decode step through the plain ring-buffer attention.
Over a mesh each leaf is held as its block and read whole
(``sharding/gather.py``): a layer's leaves as the layer runs, ``embed`` and
``lm_head`` where they are read.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..sharding.context import SINGLE, ParallelContext
from ..sharding.gather import placement
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


def _block_fwd(p, x: torch.Tensor, cfg: ModelConfig, window: Optional[int],
               place) -> torch.Tensor:
    """One block on ``p``'s leaves as ``place`` (the blocks' placement) gave
    them: tensor-parallel where it keeps their "model" blocks."""
    x = x + L.attention_forward(
        p["attn"], x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, window=window, tp=place.tp_at("attn"),
        norm=(p["ln1"], cfg.norm_eps))
    return x + L.swiglu(p["mlp"], x, place.tp_at("mlp"), norm=(p["ln2"], cfg.norm_eps))


def _layer_fwd(blocks, i: int, place, x: torch.Tensor, cfg: ModelConfig,
               window: Optional[int]) -> torch.Tensor:
    """Layer i of the stacked ``blocks``, its leaves gathered here (so that
    under remat the backward gathers them again)."""
    return _block_fwd(L.layer(blocks, i, place), x, cfg, window, place)


def _logits(params, x: torch.Tensor, cfg: ModelConfig, place) -> torch.Tensor:
    """The logits, or under TP use with ``place.vocab`` this process's vocab
    block of them."""
    if "lm_head" not in params:
        w = place.vocab_rows(place.at("embed").whole(params["embed"])).T
    else:
        w = place.at("lm_head").whole(params["lm_head"])
    norm = place.at("final_norm").whole(params["final_norm"])
    return L.norm_linear(x, norm, cfg.norm_eps, [w])[0]


def embed(params, tokens: torch.Tensor, place) -> torch.Tensor:
    """The tokens' rows of the (gathered) embedding."""
    return place.at("embed").whole(params["embed"])[tokens]


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx: ParallelContext = SINGLE,
            *, window: Optional[int] = None, inputs_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False, place=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V], or [B, 1, V] with ``last_only``
    (the hidden state is sliced before the head).  Full attention unless
    ``window``.  ``inputs_embeds`` [B, S', D], when given, replaces the
    tokens' embeddings (the vlm family's patches + text).  With ``ctx.remat`` each block's activations are recomputed
    in the backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` does.  ``place``: the parameters' placement
    (``sharding/gather.py::placement``; TP use from ``Model.loss``)."""
    place = placement(param_shapes, cfg, ctx) if place is None else place
    x = embed(params, tokens, place) if inputs_embeds is None else inputs_embeds
    x = x.to(ctx.compute_dtype)
    for i in range(cfg.n_layers):
        args = (params["blocks"], i, place.at("blocks"), x, cfg, window)
        if ctx.remat and torch.is_grad_enabled():
            x = checkpoint(_layer_fwd, *args, use_reentrant=False)
        else:
            x = _layer_fwd(*args)
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg, place)


# -- serving ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: ParallelContext = SINGLE,
               place=None):
    """``batch`` rows' ring of ``cache_len`` slots; ``place``: serving's
    placement (``Model.serve_placement``), under TP use this process's block
    of the ring over the model group (``sharding/specs.py::KVLayout``)."""
    kv = None if place is None else place.kv_layout(cfg.n_kv_heads, cache_len)
    return L.init_kv_cache(cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.head_dim,
                           ctx.compute_dtype, ctx.device, kv)


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig,
                ctx: ParallelContext = SINGLE, *, place=None):
    """token [B] at position ``pos`` -> (logits [B, V], cache updated in place).
    ``place``: the parameters' placement (serving's TP use from
    ``Model.decode_step``: the logits are then this process's vocab block)."""
    place = placement(param_shapes, cfg, ctx) if place is None else place
    blocks = place.at("blocks")
    kv = place.kv_layout(cfg.n_kv_heads, cache["slot_pos"].shape[-1])
    x = embed(params, token, place)[:, None, :].to(ctx.compute_dtype)
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i, blocks)
        c = {k: v[i] for k, v in cache.items()}
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + L.attention_decode(
            p["attn"], h, c, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, tp=blocks.tp_at("attn"), kv=kv)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.swiglu(p["mlp"], h, blocks.tp_at("mlp"))
    return _logits(params, x, cfg, place)[:, 0], cache
