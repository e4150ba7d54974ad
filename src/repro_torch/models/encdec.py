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
layer and the encoder output, which each decode step's cross attention
reads, as the reference does (its products in the other order:
:func:`_cross_step`); ``init_cache`` without ``enc_out`` holds zeros.

Over a mesh each leaf is held as its block and read whole
(``sharding/gather.py``): a layer's leaves as the layer runs, the tied
``embed`` at each of its two reads.  Where the model group holds the rows
replicated (training's and serving's TP use, ``sharding/tp.py``), every
attention runs on the process's heads (unevenly where the heads do not
divide the group), the MLP on its d_ff block, the logits on its vocab
block where the vocab divides; the serving cache holds the self caches'
block and the encoder states whole.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import attention
from ..sharding.context import SINGLE, ParallelContext
from ..sharding.gather import placement
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


def _heads(p, cfg: ModelConfig, tp):
    """(``p`` on this process's heads, their count): under ``tp``, the
    columns of ``wq``/``wk``/``wv`` and the rows of ``wo`` of its heads
    (``layers.local_heads``: the blocks as held, or cut from whole leaves
    where the heads do not divide the group)."""
    if tp is None:
        return p, cfg.n_heads
    p, _, hq = L.local_heads(p, cfg.n_heads, cfg.head_dim, tp, cols=("wq", "wk", "wv"))
    return p, hq


def _attn_out_proj(p, q, k, v, heads: int, cfg: ModelConfig, causal: bool = False,
                   pos_offset: int = 0, tp=None):
    """``heads`` of q, k, v, then ``wo`` (under ``tp`` its rows of them, the
    output summed over the model group)."""
    y = _attn_out(q, k, v, heads, cfg.head_dim, causal, pos_offset) @ p["wo"]
    return y if tp is None else tp.sum(y)


def _self(p, h, cfg: ModelConfig, causal: bool, tp=None):
    """Self-attention of h [B, S, d], on this process's heads under ``tp``."""
    p, heads = _heads(p, cfg, tp)
    return _attn_out_proj(p, h @ p["wq"], h @ p["wk"], h @ p["wv"], heads, cfg, causal,
                          tp=tp)


def _cross(p, h, enc_out, cfg: ModelConfig, tp=None):
    """Cross-attention of h [B, S, d] to the encoder states [B, F, d]; under
    ``tp`` the K/V of ``enc_out`` are projected for this process's heads only."""
    p, heads = _heads(p, cfg, tp)
    q = h @ p["wq"]
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    return _attn_out_proj(p, q, k, v, heads, cfg, causal=False, tp=tp)


def _cross_step(p, h, enc_out, cfg: ModelConfig, tp=None):
    """The decode step's cross attention: one token h [B, 1, d] to the
    encoder states [B, F, d] (all of them visible), on this process's heads
    under ``tp``.  The reference's products in the other order, equal in
    exact arithmetic: the scores ``(q_h wk_h^T) enc_out^T`` and the output
    ``(p_h enc_out) wv_h``, so that the F frames are read once a head where
    projecting them to K and V costs ``4 F d dh`` flops a head and row
    (whisper-small: 1500 frames, 64 times the ``4 F d`` here).  The scores
    and softmax in at least float32, as ``mha_ref``'s."""
    p, heads = _heads(p, cfg, tp)
    b, dh = h.shape[0], cfg.head_dim
    q = (h @ p["wq"]).reshape(b, heads, dh)
    u = torch.einsum("bhe,dhe->bhd", q, p["wk"].reshape(-1, heads, dh))      # [B, h, d]
    e = L.up32(enc_out)
    w = torch.softmax(torch.einsum("bhd,bfd->bhf", L.up32(u), e) / math.sqrt(dh), dim=-1)
    c = torch.einsum("bhf,bfd->bhd", w, e).to(h.dtype)                        # [B, h, d]
    o = torch.einsum("bhd,dhe->bhe", c, p["wv"].reshape(-1, heads, dh))
    y = o.reshape(b, 1, heads * dh) @ p["wo"]
    return y if tp is None else tp.sum(y)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           ctx: ParallelContext = SINGLE, place=None) -> torch.Tensor:
    """frames [B, F, d] (stub conv output) -> encoder states [B, F, d];
    ``place`` as :func:`forward` takes it."""
    b, f, d = frames.shape
    cdt = ctx.compute_dtype
    place = placement(param_shapes, cfg, ctx) if place is None else place
    enc = place.at("enc")
    x = frames.to(cdt) + L.sinusoidal_positions(f, d, frames.device).to(cdt)
    for i in range(params["enc"]["ln1"].shape[0]):
        p = L.layer(params["enc"], i, enc)
        h = L.layer_norm(x, p["ln1"], p["b_ln1"], cfg.norm_eps)
        x = x + _self(p["attn"], h, cfg, causal=False, tp=enc.tp_at("attn"))
        h = L.layer_norm(x, p["ln2"], p["b_ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, enc.tp_at("mlp"))
    top = _top(params, place, "enc_norm", "b_enc_norm")
    return L.layer_norm(x, top["enc_norm"], top["b_enc_norm"], cfg.norm_eps)


def _top(params, place, *keys):
    """The top-level leaves ``keys``, whole."""
    return {k: place.at(k).whole(params[k]) for k in keys}


def _embed(params, tokens, place, pos: slice, dtype) -> torch.Tensor:
    """The tokens' embeddings plus the decoder's learned positions ``pos``."""
    top = _top(params, place, "embed", "dec_pos")
    return top["embed"][tokens].to(dtype) + top["dec_pos"][pos].to(dtype)


def _logits(params, x, cfg: ModelConfig, place) -> torch.Tensor:
    """The decoder's final norm, then its logits, tied to ``embed.T`` (under
    TP use with ``place.vocab``, this process's vocab block of them)."""
    top = _top(params, place, "dec_norm", "b_dec_norm", "embed")
    x = L.layer_norm(x, top["dec_norm"], top["b_dec_norm"], cfg.norm_eps)
    return x @ place.vocab_rows(top["embed"]).T   # whisper ties its output to the embedding


def decode(params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
           ctx: ParallelContext = SINGLE, last_only: bool = False,
           place=None) -> torch.Tensor:
    """tokens [B, S], enc_out [B, F, d] -> logits [B, S, V]; ``place`` as
    :func:`forward` takes it."""
    place = placement(param_shapes, cfg, ctx) if place is None else place
    dec = place.at("dec")
    x = _embed(params, tokens, place, slice(0, tokens.shape[1]), ctx.compute_dtype)
    for i in range(params["dec"]["ln1"].shape[0]):
        p = L.layer(params["dec"], i, dec)
        h = L.layer_norm(x, p["ln1"], p["b_ln1"], cfg.norm_eps)
        x = x + _self(p["self_attn"], h, cfg, causal=True, tp=dec.tp_at("self_attn"))
        h = L.layer_norm(x, p["ln_x"], p["b_ln_x"], cfg.norm_eps)
        x = x + _cross(p["cross_attn"], h, enc_out, cfg, dec.tp_at("cross_attn"))
        h = L.layer_norm(x, p["ln2"], p["b_ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, dec.tp_at("mlp"))
    if last_only:
        x = x[:, -1:]                    # slice before the head
    return _logits(params, x, cfg, place)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx: ParallelContext = SINGLE,
            *, frames: Optional[torch.Tensor] = None, last_only: bool = False,
            place=None, **_):
    """``place``: the parameters' placement (``sharding/gather.py::placement``;
    TP use from ``Model.loss`` or serving: the encoder's, the decoder's and
    the cross attention by whole heads, unevenly where they do not divide,
    the MLP on d_ff, the tied logits by vocab where it divides)."""
    if frames is None:
        raise ValueError("the audio family needs stub frame embeddings (frames)")
    enc_out = encode(params, frames, cfg, ctx, place)
    return decode(params, tokens, enc_out, cfg, ctx, last_only=last_only, place=place)


# -- serving ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: ParallelContext = SINGLE,
               enc_out: Optional[torch.Tensor] = None, place=None):
    """Self-attention ring caches and the encoder states (zeros without
    ``enc_out``).  ``place``: serving's placement (``Model.serve_placement``),
    under TP use this process's block of the self caches over the model
    group (``sharding/specs.py::KVLayout``, its heads or slots); the encoder
    states stay whole over the group, as in the reference's cache."""
    kv = None if place is None else place.kv_layout(cfg.n_heads, cache_len)
    self_c = L.init_kv_cache(cfg.n_layers, batch, cfg.n_heads, cache_len, cfg.head_dim,
                             ctx.compute_dtype, ctx.device, kv)
    if enc_out is None:
        enc_out = torch.zeros((batch, cfg.n_audio_frames, cfg.d_model),
                              dtype=ctx.compute_dtype, device=ctx.device)
    return {"self": self_c, "enc_out": enc_out}


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig,
                ctx: ParallelContext = SINGLE, *, place=None):
    """token [B] at position ``pos`` -> (logits [B, V], cache updated in place).
    ``place``: the parameters' placement (serving's TP use from
    ``Model.decode_step``: the self caches' block (``init_cache``), each
    attention on this process's heads, the cross attention reading the
    encoder states for them only (:func:`_cross_step`); the logits are then
    this process's vocab block where the vocab divides)."""
    place = placement(param_shapes, cfg, ctx) if place is None else place
    dec = place.at("dec")
    kv = place.kv_layout(cfg.n_heads, cache["self"]["slot_pos"].shape[-1])
    x = _embed(params, token[:, None], place, slice(pos, pos + 1), ctx.compute_dtype)
    enc_out = cache["enc_out"]
    for i in range(params["dec"]["ln1"].shape[0]):
        p = L.layer(params["dec"], i, dec)
        c = {k: v[i] for k, v in cache["self"].items()}
        h = L.layer_norm(x, p["ln1"], p["b_ln1"], cfg.norm_eps)
        x = x + L.attention_decode(p["self_attn"], h, c, pos, n_heads=cfg.n_heads,
                                   n_kv=cfg.n_heads, head_dim=cfg.head_dim,
                                   rope_theta=None, tp=dec.tp_at("self_attn"), kv=kv)
        h = L.layer_norm(x, p["ln_x"], p["b_ln_x"], cfg.norm_eps)
        x = x + _cross_step(p["cross_attn"], h, enc_out, cfg, dec.tp_at("cross_attn"))
        h = L.layer_norm(x, p["ln2"], p["b_ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, dec.tp_at("mlp"))
    return _logits(params, x, cfg, place)[:, 0], cache
