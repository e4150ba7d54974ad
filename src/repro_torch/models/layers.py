"""Shared model layers: norms, RoPE, GQA attention with a ring-buffer cache, SwiGLU,
the GELU MLP and sinusoidal positions.

Counterpart of ``repro/models/layers.py``.  Parameters are plain dicts of tensors with the
reference's keys and layouts; ``lead`` gives stacked leaves a leading
layer axis, as the reference's ``vmap``-ed block inits do.  Full-sequence attention goes through the ``attention`` dispatch
(the flash kernel for ``Sq >= 128``); the decode step is plain tensor code,
as in the reference.

Tensor-parallel compute (``sharding/tp.py``): given a ``tp``
(:class:`~repro_torch.sharding.tp.TensorParallel`), the blocks' products run
on this process's "model" blocks of the leaves: :func:`attention_forward`
on its ``H / m`` query heads and the KV heads they read, :func:`swiglu` and
:func:`mlp` on its d_ff block; the row-parallel output is summed over the
model group (``tp.sum``), and a bias after it added once, after the sum.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention.ops import attention

Params = Dict[str, torch.Tensor]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               lead: Tuple[int, ...] = (), scale: Optional[float] = None):
    """N(0, scale^2) weights [*lead, d_in, d_out], scale 1/sqrt(d_in) by default,
    as the reference scales them."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=device)
    w = w / math.sqrt(d_in) if scale is None else w * scale
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    """N(0, 0.02^2) embeddings [vocab, d], as the reference scales them."""
    return (torch.randn((vocab, d), generator=gen, device=device) * 0.02).to(dtype)


def init_attention(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype, device, qkv_bias: bool = False,
                   lead: Tuple[int, ...] = ()) -> Params:
    """GQA projections; zero q, k, v biases with ``qkv_bias`` (qwen2.5)."""
    p = {"wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device, lead),
         "wk": dense_init(gen, d_model, n_kv * head_dim, dtype, device, lead),
         "wv": dense_init(gen, d_model, n_kv * head_dim, dtype, device, lead),
         "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device, lead)}
    if qkv_bias:
        for key, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[key] = torch.zeros((*lead, width * head_dim), dtype=dtype, device=device)
    return p


def attention_shapes(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                     qkv_bias: bool = False, lead: Tuple[int, ...] = ()) -> Dict[str, tuple]:
    """The shapes of :func:`init_attention`'s leaves."""
    shapes = {"wq": (*lead, d_model, n_heads * head_dim),
              "wk": (*lead, d_model, n_kv * head_dim),
              "wv": (*lead, d_model, n_kv * head_dim),
              "wo": (*lead, n_heads * head_dim, d_model)}
    if qkv_bias:
        shapes.update(bq=(*lead, n_heads * head_dim), bk=(*lead, n_kv * head_dim),
                      bv=(*lead, n_kv * head_dim))
    return shapes


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
                lead: Tuple[int, ...] = ()) -> Params:
    return {"wg": dense_init(gen, d_model, d_ff, dtype, device, lead),
            "wu": dense_init(gen, d_model, d_ff, dtype, device, lead),
            "wd": dense_init(gen, d_ff, d_model, dtype, device, lead)}


def swiglu(p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``tp``: ``wg``/``wu``/``wd`` are this process's d_ff blocks."""
    y = (torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return y if tp is None else tp.sum(y)


def layer(blocks: Params, i: int, place=None) -> Params:
    """Layer i's parameters out of a stacked ``blocks`` tree: views, or with
    ``place`` (the blocks' ``sharding.gather.Placement``) the layer's whole
    leaves, gathered from the blocks this process holds."""
    views = {k: (layer(v, i) if isinstance(v, dict) else v[i]) for k, v in blocks.items()}
    return views if place is None else place.whole(views, lead=1)


def lm_head(params: Params, x: torch.Tensor, eps: float, place) -> torch.Tensor:
    """``final_norm`` then ``lm_head``, each read whole through ``place`` (the
    parameters' ``sharding.gather.Placement``)."""
    x = rms_norm(x, place.at("final_norm").whole(params["final_norm"]), eps)
    return x @ place.at("lm_head").whole(params["lm_head"])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, dh]; pos: [S] absolute positions.  Interleaved pairs."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = pos[..., :, None].float() * freqs                 # [S, dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _project_qkv(p: Params, x, n_heads, n_kv, head_dim):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, n_heads, head_dim).transpose(1, 2)
    k = k.reshape(b, s, n_kv, head_dim).transpose(1, 2)
    v = v.reshape(b, s, n_kv, head_dim).transpose(1, 2)
    return q, k, v


def _local_qkv(p: Params, x, n_heads, n_kv, head_dim, tp):
    """This process's query heads (``wq``'s column block r: heads ``r H/m``
    to ``(r+1) H/m - 1``, whole heads in the reshape's order) and the KV
    heads they read: the KV block as held where ``Hkv % m == 0``, else the
    columns of the heads read out of the whole ``wk``/``wv``, each local
    query head given its own copy where they do not share them evenly."""
    hq = n_heads // tp.size
    if n_kv % tp.size == 0:
        return _project_qkv(p, x, hq, n_kv // tp.size, head_dim)
    first, count, index = tp.kv_heads(n_heads, n_kv)
    cols = slice(first * head_dim, (first + count) * head_dim)
    local = dict(p, **{k: p[k][..., cols] for k in ("wk", "wv", "bk", "bv") if k in p})
    q, k, v = _project_qkv(local, x, hq, count, head_dim)
    if index is not None:
        k, v = k[:, index], v[:, index]
    return q, k, v


def attention_forward(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                      head_dim: int, rope_theta: Optional[float],
                      causal: bool = True, window: Optional[int] = None,
                      pos_offset: int = 0, tp=None) -> torch.Tensor:
    """Full-sequence attention (prefill path): x [B, S, D] -> [B, S, D].
    ``tp``: on this process's heads (:func:`_local_qkv`), ``wo`` its rows of
    them, the output summed over the model group."""
    b, s, _ = x.shape
    if tp is None:
        q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)
    else:
        q, k, v = _local_qkv(p, x, n_heads, n_kv, head_dim, tp)
    if rope_theta is not None:
        pos = torch.arange(s, device=x.device) + pos_offset
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    o = attention(q, k, v, causal, window, pos_offset)
    y = o.transpose(1, 2).reshape(b, s, q.shape[1] * head_dim) @ p["wo"]
    return y if tp is None else tp.sum(y)


# -- KV caches ------------------------------------------------------------------


def init_kv_cache(n_layers: int, batch: int, n_kv: int, cache_len: int,
                  head_dim: int, dtype, device) -> Params:
    """Ring-buffer KV cache, stacked over layers; ``cache_len`` = window or seq."""
    return {
        "k": torch.zeros((n_layers, batch, n_kv, cache_len, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, n_kv, cache_len, head_dim),
                         dtype=dtype, device=device),
        "slot_pos": torch.full((n_layers, cache_len), -1, dtype=torch.int64,
                               device=device),
    }


def attention_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, *,
                     n_heads: int, n_kv: int, head_dim: int,
                     rope_theta: Optional[float]) -> torch.Tensor:
    """One decode step against one layer's ring-buffer cache.

    x [B, 1, D] is the token at absolute position ``pos``.  RoPE is applied
    at write time.  The cache tensors (``k``, ``v`` [B, Hkv, W, dh],
    ``slot_pos`` [W]) are updated in place, where the reference returns new
    ones.
    """
    b = x.shape[0]
    W = cache["k"].shape[2]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)   # [B,H,1,dh]
    if rope_theta is not None:
        ppos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q, ppos, rope_theta)
        k = apply_rope(k, ppos, rope_theta)
    slot = pos % W                                           # ring write
    cache["k"][:, :, slot] = k[:, :, 0]
    cache["v"][:, :, slot] = v[:, :, 0]
    cache["slot_pos"][slot] = pos
    g = n_heads // n_kv
    kk = cache["k"].repeat_interleave(g, dim=1).float()      # [B,H,W,dh]
    vv = cache["v"].repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(head_dim)
    spos = cache["slot_pos"]
    valid = (spos >= 0) & (spos <= pos)                      # [W]
    s = torch.where(valid[None, None, None, :], s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", w, vv).to(x.dtype)
    o = o.transpose(1, 2).reshape(b, 1, n_heads * head_dim)
    return o @ p["wo"]


# -- GELU MLP (whisper-style) --------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             lead: Tuple[int, ...] = ()) -> Params:
    return {"w1": dense_init(gen, d_model, d_ff, dtype, device, lead),
            "b1": torch.zeros((*lead, d_ff), dtype=dtype, device=device),
            "w2": dense_init(gen, d_ff, d_model, dtype, device, lead),
            "b2": torch.zeros((*lead, d_model), dtype=dtype, device=device)}


def mlp_shapes(d_model: int, d_ff: int, lead: Tuple[int, ...] = ()) -> Dict[str, tuple]:
    """The shapes of :func:`init_mlp`'s leaves."""
    return {"w1": (*lead, d_model, d_ff), "b1": (*lead, d_ff),
            "w2": (*lead, d_ff, d_model), "b2": (*lead, d_model)}


def mlp(p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation.  ``tp``:
    ``w1``/``b1``/``w2`` are this process's d_ff blocks; ``b2`` is added
    after the sum."""
    h = torch.nn.functional.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    y = h @ p["w2"]
    return (y if tp is None else tp.sum(y)) + p["b2"]


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """[n, d] float32: sines of the first d/2 frequencies, then cosines."""
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
