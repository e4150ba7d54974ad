"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block.

Counterpart of ``repro/models/hybrid.py``.  Zamba2 [arXiv:2411.15242]
interleaves a single *shared* full-attention (+MLP) block into a Mamba2
tower: the same attention parameters are reused at every invocation point
(every ``cfg.attn_every`` layers).  The per-invocation LoRA deltas of the
released model are omitted, as in the reference.

Layer schedule for n_layers=38, attn_every=6: mamba x5, [shared attn],
mamba x5, [shared attn], ... (6 invocations), then the trailing mamba
layers.  The mamba leaves are stacked over the 32 mamba layers (the
reference's vmapped init); the forward loops over them where the reference
scans, and the attention block runs ``flash_attention`` through the
``attention`` dispatch (``Sq >= 128``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..sharding.context import SINGLE, ParallelContext
from . import layers as L
from . import ssm

F32_PARAMS = ssm.F32_PARAMS


def layer_schedule(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[('mamba', count), ('attn', 1), ...] — segments in order."""
    per = max(cfg.attn_every, 1)
    segs: List[Tuple[str, int]] = []
    remaining = cfg.n_layers
    while remaining > 0:
        m = min(per - 1, remaining)
        if m:
            segs.append(("mamba", m))
            remaining -= m
        if remaining > 0:
            segs.append(("attn", 1))
            remaining -= 1
    return segs


def n_mamba_layers(cfg: ModelConfig) -> int:
    return sum(c for kind, c in layer_schedule(cfg) if kind == "mamba")


def n_attn_calls(cfg: ModelConfig) -> int:
    return sum(1 for kind, _ in layer_schedule(cfg) if kind == "attn")


def param_shapes(cfg: ModelConfig) -> Dict[str, object]:
    """The parameter tree's shapes, keyed as the reference's."""
    D, F = cfg.d_model, cfg.d_ff
    return {
        "embed": (cfg.vocab, D),
        "mamba": ssm.mamba_shapes(cfg, lead=(n_mamba_layers(cfg),)),
        "shared_attn": {
            "ln1": (D,),
            "attn": L.attention_shapes(D, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
            "ln2": (D,),
            "mlp": {"wg": (D, F), "wu": (D, F), "wd": (F, D)},
        },
        "final_norm": (D,),
        "lm_head": (D, cfg.vocab),
    }


def init(seed: int, cfg: ModelConfig, ctx: ParallelContext = SINGLE):
    """Random weights from ``seed`` (the reference's scales, not its values)."""
    dt, dev = ctx.param_dtype, ctx.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = cfg.d_model
    return {
        "embed": L.embed_init(gen, cfg.vocab, D, dt, dev),
        "mamba": ssm.init_mamba_block(gen, cfg, dt, dev, lead=(n_mamba_layers(cfg),)),
        "shared_attn": {
            "ln1": torch.ones((D,), dtype=dt, device=dev),
            "attn": L.init_attention(gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                     dt, dev),
            "ln2": torch.ones((D,), dtype=dt, device=dev),
            "mlp": L.init_swiglu(gen, D, cfg.d_ff, dt, dev),
        },
        "final_norm": torch.ones((D,), dtype=dt, device=dev),
        "lm_head": L.dense_init(gen, D, cfg.vocab, dt, dev),
    }


def _attn_block(p, x: torch.Tensor, cfg: ModelConfig, window=None, pos_offset: int = 0):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention_forward(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, window=window, pos_offset=pos_offset)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.swiglu(p["mlp"], h)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx: ParallelContext = SINGLE,
            *, window: Optional[int] = None, last_only: bool = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V], or [B, 1, V] with ``last_only``.

    The shared attention block is full attention; ``window`` applies only in
    the long-context mode, as in the reference.  With ``ctx.remat`` each
    mamba block's activations are recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
    """
    x = params["embed"][tokens].to(ctx.compute_dtype)
    off = 0
    for kind, count in layer_schedule(cfg):
        if kind == "attn":
            x = _attn_block(params["shared_attn"], x, cfg, window)
            continue
        for i in range(off, off + count):
            p = L.layer(params["mamba"], i)
            if ctx.remat and torch.is_grad_enabled():
                x = x + checkpoint(ssm.mamba_forward, p, x, cfg, use_reentrant=False)
            else:
                x = x + ssm.mamba_forward(p, x, cfg)
        off += count
    if last_only:
        x = x[:, -1:]                    # slice before lm_head
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"]


# -- serving ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: ParallelContext = SINGLE):
    """Each mamba layer's conv and SSM states, and one ring-buffer KV cache
    per invocation of the shared attention block."""
    return {
        "mamba": ssm.init_mamba_cache(cfg, batch, ctx.compute_dtype, ctx.device,
                                      lead=(n_mamba_layers(cfg),)),
        "attn": L.init_kv_cache(n_attn_calls(cfg), batch, cfg.n_kv_heads, cache_len,
                                cfg.head_dim, ctx.compute_dtype, ctx.device),
    }


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig,
                ctx: ParallelContext = SINGLE):
    """token [B] at position ``pos`` -> (logits [B, V], cache updated in place)."""
    x = params["embed"][token][:, None, :].to(ctx.compute_dtype)
    m_off = a_off = 0
    for kind, count in layer_schedule(cfg):
        if kind == "mamba":
            for i in range(m_off, m_off + count):
                c = {k: v[i] for k, v in cache["mamba"].items()}
                y, new = ssm.mamba_decode(L.layer(params["mamba"], i), x, c, cfg)
                for k, v in new.items():
                    c[k].copy_(v)
                x = x + y
            m_off += count
            continue
        p = params["shared_attn"]
        c = {k: v[a_off] for k, v in cache["attn"].items()}
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + L.attention_decode(
            p["attn"], h, c, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.swiglu(p["mlp"], h)
        a_off += 1
    lg = L.rms_norm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"]
    return lg[:, 0], cache
