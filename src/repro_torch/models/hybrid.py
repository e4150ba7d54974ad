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
``attention`` dispatch (``Sq >= 128``).  Over a mesh each leaf is held as
its block and read whole (``sharding/gather.py``): a mamba layer's leaves
as the layer runs, the shared block's at each of its calls.  Where the
model group holds the rows replicated (training's and serving's TP use,
``sharding/tp.py``) it shares the work: each Mamba layer by SSM heads
(``ssm.py::_local``), the shared block's attention by heads and its MLP on
d_ff, the logits by vocab; the serving caches hold the process's SSM heads
and its block of the KV cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..sharding.context import SINGLE, ParallelContext
from ..sharding.gather import placement
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


def _attn_block(p, x: torch.Tensor, cfg: ModelConfig, window=None, pos_offset: int = 0,
                place=None):
    """The shared block on ``p``'s leaves as ``place`` (the shared block's
    placement) gave them: tensor-parallel under TP use."""
    tp_attn = None if place is None else place.tp_at("attn")
    tp_mlp = None if place is None else place.tp_at("mlp")
    x = x + L.attention_forward(
        p["attn"], x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, window=window, pos_offset=pos_offset,
        tp=tp_attn, norm=(p["ln1"], cfg.norm_eps))
    return x + L.swiglu(p["mlp"], x, tp_mlp, norm=(p["ln2"], cfg.norm_eps))


def _mamba_at(blocks, i: int, place, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mamba layer i of the stacked ``blocks``, its leaves gathered here; on
    this process's SSM heads under TP use (``place.tp_at()``)."""
    return ssm.mamba_forward(L.layer(blocks, i, place), x, cfg, place.tp_at())


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx: ParallelContext = SINGLE,
            *, window: Optional[int] = None, last_only: bool = False,
            place=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V], or [B, 1, V] with ``last_only``.

    The shared attention block is full attention; ``window`` applies only in
    the long-context mode, as in the reference.  With ``ctx.remat`` each
    mamba block's activations are recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
    ``place``: the parameters' placement (``sharding/gather.py::placement``;
    TP use from ``Model.loss`` or serving: the Mamba layers by SSM heads, the
    shared block's attention by heads and its MLP on d_ff, the logits by
    vocab).
    """
    place = placement(param_shapes, cfg, ctx) if place is None else place
    x = place.at("embed").whole(params["embed"])[tokens].to(ctx.compute_dtype)
    shared = place.at("shared_attn")
    off = 0
    for kind, count in layer_schedule(cfg):
        if kind == "attn":
            x = _attn_block(shared.whole(params["shared_attn"]), x, cfg, window, place=shared)
            continue
        for i in range(off, off + count):
            args = (params["mamba"], i, place.at("mamba"), x, cfg)
            if ctx.remat and torch.is_grad_enabled():
                x = x + checkpoint(_mamba_at, *args, use_reentrant=False)
            else:
                x = x + _mamba_at(*args)
        off += count
    if last_only:
        x = x[:, -1:]                    # slice before lm_head
    return L.lm_head(params, x, cfg.norm_eps, place)


# -- serving ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: ParallelContext = SINGLE,
               place=None):
    """Each mamba layer's conv and SSM states, and one ring-buffer KV cache
    per invocation of the shared attention block.  ``place``: serving's
    placement (``Model.serve_placement``): under TP use this process's SSM
    heads of the mamba states and its block of the KV cache over the model
    group (``sharding/specs.py::KVLayout``)."""
    tp = kv = None
    if place is not None:
        tp, kv = place.tp_at("mamba"), place.kv_layout(cfg.n_kv_heads, cache_len)
    return {
        "mamba": ssm.init_mamba_cache(cfg, batch, ctx.compute_dtype, ctx.device,
                                      lead=(n_mamba_layers(cfg),), tp=tp),
        "attn": L.init_kv_cache(n_attn_calls(cfg), batch, cfg.n_kv_heads, cache_len,
                                cfg.head_dim, ctx.compute_dtype, ctx.device, kv),
    }


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig,
                ctx: ParallelContext = SINGLE, *, place=None):
    """token [B] at position ``pos`` -> (logits [B, V], cache updated in place).
    ``place``: the parameters' placement (serving's TP use from
    ``Model.decode_step``: the logits are then this process's vocab block)."""
    place = placement(param_shapes, cfg, ctx) if place is None else place
    mamba, shared = place.at("mamba"), place.at("shared_attn")
    kv = place.kv_layout(cfg.n_kv_heads, cache["attn"]["slot_pos"].shape[-1])
    x = place.at("embed").whole(params["embed"])[token][:, None, :].to(ctx.compute_dtype)
    m_off = a_off = 0
    for kind, count in layer_schedule(cfg):
        if kind == "mamba":
            for i in range(m_off, m_off + count):
                c = {k: v[i] for k, v in cache["mamba"].items()}
                p = L.layer(params["mamba"], i, mamba)
                y, new = ssm.mamba_decode(p, x, c, cfg, mamba.tp_at())
                for k, v in new.items():
                    c[k].copy_(v)
                x = x + y
            m_off += count
            continue
        p = shared.whole(params["shared_attn"])
        c = {k: v[a_off] for k, v in cache["attn"].items()}
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + L.attention_decode(
            p["attn"], h, c, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, tp=shared.tp_at("attn"), kv=kv)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.swiglu(p["mlp"], h, shared.tp_at("mlp"))
        a_off += 1
    return L.lm_head(params, x, cfg.norm_eps, place)[:, 0], cache
