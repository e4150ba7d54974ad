"""Whisper-style encoder-decoder [arXiv:2212.04356].

Counterpart of ``repro/models/encdec.py``.  The mel-spectrogram + conv
feature extractor is a stub, as in the reference: the encoder consumes
precomputed frame embeddings ``frames [B, n_audio_frames, d]``, adds
sinusoidal positions, and runs bidirectional pre-LN attention blocks.  The
decoder is causal self-attention + cross-attention to the encoder output,
with learned positions, and its logits are tied to ``embed.T``.

Attention goes through the ``attention`` dispatch (the flash kernel for
``Sq >= 128``): the encoder's self-attention is non-causal over the 1500
frames, the decoder's cross-attention non-causal with Sq != Sk.  The
``enc``/``dec`` leaves carry a leading layer axis (the reference's vmapped
block inits).

Serving: the cache holds a ring-buffer self-attention cache per decoder
layer and the encoder output, from which each decode step projects the
cross-attention K/V, as the reference does; ``init_cache`` without
``enc_out`` holds zeros.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import attention
from ..sharding.context import SINGLE, ParallelContext
from . import layers as L

#: the decoder's learned positions
_DEC_POS = 4096
_PROJ = ("wq", "wk", "wv", "wo")


def _xattn_shapes(d: int, lead) -> Dict[str, tuple]:
    return {k: (*lead, d, d) for k in _PROJ}


def param_shapes(cfg: ModelConfig) -> Dict[str, object]:
    """The parameter tree's shapes, keyed as the reference's."""
    d, F = cfg.d_model, cfg.d_ff
    le, ld = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": (cfg.vocab, d),
        "dec_pos": (_DEC_POS, d),
        "enc": {"ln1": (*le, d), "b_ln1": (*le, d), "attn": _xattn_shapes(d, le),
                "ln2": (*le, d), "b_ln2": (*le, d), "mlp": L.mlp_shapes(d, F, le)},
        "dec": {"ln1": (*ld, d), "b_ln1": (*ld, d), "self_attn": _xattn_shapes(d, ld),
                "ln_x": (*ld, d), "b_ln_x": (*ld, d), "cross_attn": _xattn_shapes(d, ld),
                "ln2": (*ld, d), "b_ln2": (*ld, d), "mlp": L.mlp_shapes(d, F, ld)},
        "enc_norm": (d,), "b_enc_norm": (d,),
        "dec_norm": (d,), "b_dec_norm": (d,),
    }


def init(seed: int, cfg: ModelConfig, ctx: ParallelContext = SINGLE):
    """Random weights from ``seed`` (the reference's scales, not its values)."""
    dt, dev = ctx.param_dtype, ctx.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def ones(lead=()):
        return torch.ones((*lead, d), dtype=dt, device=dev)

    def zeros(lead=()):
        return torch.zeros((*lead, d), dtype=dt, device=dev)

    def xattn(lead):
        return {k: L.dense_init(gen, d, d, dt, dev, lead) for k in _PROJ}

    le, ld = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": L.embed_init(gen, cfg.vocab, d, dt, dev),
        "dec_pos": (torch.randn((_DEC_POS, d), generator=gen, device=dev) * 0.01).to(dt),
        "enc": {"ln1": ones(le), "b_ln1": zeros(le), "attn": xattn(le),
                "ln2": ones(le), "b_ln2": zeros(le),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, dev, le)},
        "dec": {"ln1": ones(ld), "b_ln1": zeros(ld), "self_attn": xattn(ld),
                "ln_x": ones(ld), "b_ln_x": zeros(ld), "cross_attn": xattn(ld),
                "ln2": ones(ld), "b_ln2": zeros(ld),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, dev, ld)},
        "enc_norm": ones(), "b_enc_norm": zeros(),
        "dec_norm": ones(), "b_dec_norm": zeros(),
    }


def _attn_out(q, k, v, n_heads: int, head_dim: int, causal: bool, pos_offset: int = 0):
    b, s, _ = q.shape
    sk = k.shape[1]
    qh = q.reshape(b, s, n_heads, head_dim).transpose(1, 2)
    kh = k.reshape(b, sk, n_heads, head_dim).transpose(1, 2)
    vh = v.reshape(b, sk, n_heads, head_dim).transpose(1, 2)
    o = attention(qh, kh, vh, causal, None, pos_offset)
    return o.transpose(1, 2).reshape(b, s, n_heads * head_dim)


def _attn_out_proj(p, q, k, v, cfg: ModelConfig, causal: bool = False, pos_offset: int = 0):
    return _attn_out(q, k, v, cfg.n_heads, cfg.head_dim, causal, pos_offset) @ p["wo"]


def _cross(p, h, enc_out, cfg: ModelConfig):
    """Cross-attention of h [B, S, d] to the encoder states [B, F, d]."""
    q = h @ p["wq"]
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    return _attn_out_proj(p, q, k, v, cfg, causal=False)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           ctx: ParallelContext = SINGLE) -> torch.Tensor:
    """frames [B, F, d] (stub conv output) -> encoder states [B, F, d]."""
    b, f, d = frames.shape
    cdt = ctx.compute_dtype
    x = frames.to(cdt) + L.sinusoidal_positions(f, d, frames.device).to(cdt)
    for i in range(params["enc"]["ln1"].shape[0]):
        p = L.layer(params["enc"], i)
        h = L.layer_norm(x, p["ln1"], p["b_ln1"], cfg.norm_eps)
        a = p["attn"]
        x = x + _attn_out_proj(a, h @ a["wq"], h @ a["wk"], h @ a["wv"], cfg)
        h = L.layer_norm(x, p["ln2"], p["b_ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
    return L.layer_norm(x, params["enc_norm"], params["b_enc_norm"], cfg.norm_eps)


def decode(params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
           ctx: ParallelContext = SINGLE, last_only: bool = False) -> torch.Tensor:
    """tokens [B, S], enc_out [B, F, d] -> logits [B, S, V]."""
    s = tokens.shape[1]
    cdt = ctx.compute_dtype
    x = params["embed"][tokens].to(cdt) + params["dec_pos"][:s].to(cdt)
    for i in range(params["dec"]["ln1"].shape[0]):
        p = L.layer(params["dec"], i)
        h = L.layer_norm(x, p["ln1"], p["b_ln1"], cfg.norm_eps)
        a = p["self_attn"]
        x = x + _attn_out_proj(a, h @ a["wq"], h @ a["wk"], h @ a["wv"], cfg, causal=True)
        h = L.layer_norm(x, p["ln_x"], p["b_ln_x"], cfg.norm_eps)
        x = x + _cross(p["cross_attn"], h, enc_out, cfg)
        h = L.layer_norm(x, p["ln2"], p["b_ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
    if last_only:
        x = x[:, -1:]                    # slice before the head
    x = L.layer_norm(x, params["dec_norm"], params["b_dec_norm"], cfg.norm_eps)
    return x @ params["embed"].T         # whisper ties its output to the embedding


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx: ParallelContext = SINGLE,
            *, frames: Optional[torch.Tensor] = None, last_only: bool = False, **_):
    if frames is None:
        raise ValueError("the audio family needs stub frame embeddings (frames)")
    enc_out = encode(params, frames, cfg, ctx)
    return decode(params, tokens, enc_out, cfg, ctx, last_only=last_only)


# -- serving ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: ParallelContext = SINGLE,
               enc_out: Optional[torch.Tensor] = None):
    """Self-attention ring caches and the encoder states (zeros without ``enc_out``)."""
    self_c = L.init_kv_cache(cfg.n_layers, batch, cfg.n_heads, cache_len, cfg.head_dim,
                             ctx.compute_dtype, ctx.device)
    if enc_out is None:
        enc_out = torch.zeros((batch, cfg.n_audio_frames, cfg.d_model),
                              dtype=ctx.compute_dtype, device=ctx.device)
    return {"self": self_c, "enc_out": enc_out}


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig,
                ctx: ParallelContext = SINGLE):
    """token [B] at position ``pos`` -> (logits [B, V], cache updated in place)."""
    cdt = ctx.compute_dtype
    x = params["embed"][token][:, None, :].to(cdt)
    x = x + params["dec_pos"][pos:pos + 1].to(cdt)
    enc_out = cache["enc_out"]
    for i in range(params["dec"]["ln1"].shape[0]):
        p = L.layer(params["dec"], i)
        c = {k: v[i] for k, v in cache["self"].items()}
        h = L.layer_norm(x, p["ln1"], p["b_ln1"], cfg.norm_eps)
        x = x + L.attention_decode(p["self_attn"], h, c, pos, n_heads=cfg.n_heads,
                                   n_kv=cfg.n_heads, head_dim=cfg.head_dim,
                                   rope_theta=None)
        h = L.layer_norm(x, p["ln_x"], p["b_ln_x"], cfg.norm_eps)
        x = x + _cross(p["cross_attn"], h, enc_out, cfg)
        h = L.layer_norm(x, p["ln2"], p["b_ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
    x = L.layer_norm(x, params["dec_norm"], params["b_dec_norm"], cfg.norm_eps)
    return (x @ params["embed"].T)[:, 0], cache
