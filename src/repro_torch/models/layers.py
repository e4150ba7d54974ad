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
on its query heads (``tp.heads``: whole heads, unevenly where they do not
divide the group, cut from the whole leaves by :func:`local_heads`) and
the KV heads they read, :func:`swiglu` and
:func:`mlp` on its d_ff block; the row-parallel output is summed over the
model group (``tp.sum``), and a bias after it added once, after the sum.
:func:`attention_decode` does the same at one position, over a cache split
by KV heads or by slots (``sharding/specs.py::KVLayout``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels.flash_attention.ops import attention
from ..sharding.tp import chunk_rows, head_range, row_chunks

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


def swiglu(p: Params, x: torch.Tensor, tp=None, norm=None) -> torch.Tensor:
    """``tp``: ``wg``/``wu``/``wd`` are this process's d_ff blocks.  ``norm``:
    as :func:`attention_forward`'s."""
    g, u = _project(x, (p["wg"], p["wu"]), norm)
    y = (torch.nn.functional.silu(g) * u) @ p["wd"]
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
    return norm_linear(x, place.at("final_norm").whole(params["final_norm"]), eps,
                       [place.at("lm_head").whole(params["lm_head"])])[0]


def up32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least float32: bf16 and float32 as float32, float64 kept
    (a float64 run stays float64 end to end)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


#: float32 bytes a row chunk of the norms' forward and backward holds (a
#: few such chunks are their float32 working set)
NORM_CHUNK_BYTES = 1 << 26


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float):
    """(the norm, ``rstd`` [.., 1] in ``up32``'s dtype), over row chunks of
    :data:`NORM_CHUNK_BYTES`: no float32 copy of x beyond a chunk's."""
    d = x.shape[-1]
    f = torch.promote_types(x.dtype, torch.float32)
    xr = x.reshape(-1, d)
    y = torch.empty(xr.shape, dtype=torch.promote_types(x.dtype, w.dtype), device=x.device)
    rstd = torch.empty((xr.shape[0], 1), dtype=f, device=x.device)
    n = chunk_rows(d, NORM_CHUNK_BYTES)
    for xc, yc, rc in zip(xr.split(n), y.split(n), rstd.split(n)):
        xf = xc.to(f, copy=True)                     # scaled in place below
        torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps, out=rc)
        torch.mul(xf.mul_(rc).to(x.dtype), w, out=yc)
    return y.view(x.shape), rstd.view(*x.shape[:-1], 1)


def _rms_norm_bwd(x, w, rstd, gy, need_x: bool, need_w: bool, reuse: bool = False):
    """(dx, dw) of :func:`rms_norm` for its output's gradient ``gy``, each row
    chunk at a time: with ``x̂ = x * rstd`` in float32 and ``a = gy * w``
    rounded to x's dtype, ``dx = rstd * (a - x̂ * mean(a * x̂))``, ``dw`` the
    sum over the rows of ``gy * round(x̂)`` (the rounding to x's dtype
    before the weight differentiated as the identity).  ``reuse``: gy is
    the caller's own, and dx may take its place where they agree in dtype."""
    d = x.shape[-1]
    f = rstd.dtype
    xr, gr, rr = x.reshape(-1, d), gy.reshape(-1, d), rstd.reshape(-1, 1)
    same = reuse and gy.dtype == x.dtype and gy.is_contiguous()
    dx = (gr if same else torch.empty_like(xr)) if need_x else xr
    dw = torch.zeros(d, dtype=f, device=x.device) if need_w else None
    n = chunk_rows(d, NORM_CHUNK_BYTES)
    for xc, gc, rc, dxc in zip(xr.split(n), gr.split(n), rr.split(n), dx.split(n)):
        xhat = xc.to(f, copy=True).mul_(rc)
        if need_w:
            dw += (gc * xhat.to(x.dtype)).to(f).sum(0)
        if need_x:
            g = (gc * w).to(x.dtype).to(f)
            m = (g * xhat).mean(-1, keepdim=True)
            torch.mul(rc, g.sub_(xhat.mul_(m)), out=dxc)
    return (dx.view(x.shape) if need_x else None,
            dw.sum_to_size(w.shape).to(w.dtype) if need_w else None)


class _RMSNorm(torch.autograd.Function):
    """:func:`rms_norm` keeping x in its own dtype and ``rstd`` for the
    backward (:func:`_rms_norm_bwd`): no float32 copy of x, as XLA's fusion
    keeps none."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = _rms_norm(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w, rstd = ctx.saved_tensors
        return (*_rms_norm_bwd(x, w, rstd, gy, *ctx.needs_input_grad[:2]), None)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps))`` in at least float32, rounded to x's
    dtype, times ``w``; under autograd through :class:`_RMSNorm`."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _rms_norm(x, w, eps)[0]


class _NormLinear(torch.autograd.Function):
    """``[rms_norm(x, w) @ W for W in ws]`` keeping x, not the norm's output:
    the backward recomputes the norm (its output and ``rstd``, the same
    bits) for the weights' gradients, sums the products' input gradients
    into one tensor (``addmm_``) and takes it through :func:`_rms_norm_bwd`.
    A block's norm output is then never held between its forward and its
    backward, as under XLA's remat it is recomputed only where its
    products' backward needs it."""

    @staticmethod
    def forward(ctx, x, w, eps, *ws):
        h = _rms_norm(x, w, eps)[0]
        ctx.save_for_backward(x, w, *ws)
        ctx.eps = eps
        return tuple(h @ W for W in ws)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gys):
        x, w, *ws = ctx.saved_tensors
        h, rstd = _rms_norm(x, w, ctx.eps)
        h = h.reshape(-1, x.shape[-1])
        gys = [g.reshape(h.shape[0], g.shape[-1]) for g in gys]   # W may have 0 columns
        dws = [(h.t() @ g).to(W.dtype) if need else None
               for g, W, need in zip(gys, ws, ctx.needs_input_grad[3:])]
        del h
        dh = None
        for g, W in zip(gys, ws):
            dh = g @ W.t() if dh is None else dh.addmm_(g, W.t())
        dx, dw = _rms_norm_bwd(x, w, rstd, dh, *ctx.needs_input_grad[:2], reuse=True)
        return (dx, dw, None, *dws)


def norm_linear(x: torch.Tensor, w: torch.Tensor, eps: float, ws) -> list:
    """``[rms_norm(x, w, eps) @ W for W in ws]``; under autograd through
    :class:`_NormLinear`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, *ws)):
        return list(_NormLinear.apply(x, w, eps, *ws))
    h = rms_norm(x, w, eps)
    return [h @ W for W in ws]


def _nll_rows(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.gather(torch.log_softmax(up32(z), dim=-1), -1, labels[:, None])[:, 0]


class _NLL(torch.autograd.Function):
    """:func:`nll` over row chunks (``sharding/tp.py::row_chunks``), keeping
    the logits in their own dtype for the backward: no float32 copy of the
    logits, nor their log-softmax, lives past a chunk.  The backward
    recomputes each chunk's log-softmax: ``dz = g * (exp(lp) - onehot)``."""

    @staticmethod
    def forward(ctx, z, labels):
        ctx.save_for_backward(z, labels)
        return nll(z, labels)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        z, labels = ctx.saved_tensors
        v = z.shape[-1]
        zr, lr, gr = z.reshape(-1, v), labels.reshape(-1), g.reshape(-1)
        dz = torch.empty_like(zr)
        for a, b in row_chunks(zr.shape[0], v):
            d = torch.exp(torch.log_softmax(up32(zr[a:b]), dim=-1)) * gr[a:b, None]
            dz[a:b] = d.scatter_add_(-1, lr[a:b, None], -gr[a:b, None])
        return dz.view(z.shape), None


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's ``-log_softmax(logits)[label]``, in at least float32
    (the reference's loss); under autograd through :class:`_NLL`."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _NLL.apply(logits, labels)
    v = logits.shape[-1]
    zr, lr = logits.reshape(-1, v), labels.reshape(-1)
    return torch.cat([_nll_rows(zr[a:b], lr[a:b])
                      for a, b in row_chunks(zr.shape[0], v)]).view(labels.shape)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = up32(x)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, dh]; pos: [S] absolute positions.  Interleaved pairs."""
    dh = x.shape[-1]
    f = torch.promote_types(x.dtype, torch.float32)
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=f, device=x.device) / dh))
    ang = pos[..., :, None].to(f) * freqs                   # [S, dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _project(x: torch.Tensor, ws, norm=None) -> list:
    """``[x @ W for W in ws]``, or with ``norm`` (the weight and eps of an
    RMSNorm that x has not had yet) :func:`norm_linear`'s."""
    return [x @ W for W in ws] if norm is None else norm_linear(x, *norm, ws)


def _project_qkv(p: Params, x, n_heads, n_kv, head_dim, norm=None):
    b, s, _ = x.shape
    q, k, v = _project(x, (p["wq"], p["wk"], p["wv"]), norm)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, n_heads, head_dim).transpose(1, 2)
    k = k.reshape(b, s, n_kv, head_dim).transpose(1, 2)
    v = v.reshape(b, s, n_kv, head_dim).transpose(1, 2)
    return q, k, v


def local_heads(p: Params, n_heads: int, head_dim: int, tp, cols=("wq", "bq"),
                rows=("wo",)) -> Tuple[Params, int, int]:
    """(``p`` on this process's query heads, the first of them, their count):
    heads ``tp.heads(H)`` (``sharding/tp.py::head_range``), the columns of
    the leaves ``cols`` and the rows of ``rows``.  Where the heads divide the
    group these are the leaves' "model" blocks, held as they are; where
    they do not, ``sharding/gather.py`` reads the leaves whole and they are
    cut here, the gather's reduce-scatter then summing the processes'
    disjoint shares into the whole leaf's gradient."""
    h0, hq = tp.heads(n_heads)
    if p["wq"].shape[-1] != n_heads * head_dim:          # the blocks as held
        return p, h0, hq
    cut = slice(h0 * head_dim, (h0 + hq) * head_dim)
    out = dict(p)
    out.update({k: p[k][..., cut] for k in cols if k in p})
    out.update({k: p[k][cut] for k in rows})
    return out, h0, hq


def _local_qkv(p: Params, x, n_heads, n_kv, head_dim, tp, norm=None):
    """The q of ``p``'s query heads (``p`` from :func:`local_heads`) and the KV
    heads they read: the KV block as held where ``Hkv % m == 0``, else the
    columns of the heads read out of the whole ``wk``/``wv``, each local
    query head given its own copy where they do not share them evenly."""
    hq = p["wq"].shape[-1] // head_dim
    if n_kv % tp.size == 0:
        return _project_qkv(p, x, hq, n_kv // tp.size, head_dim, norm)
    first, count, index = tp.kv_heads(n_heads, n_kv)
    cols = slice(first * head_dim, (first + count) * head_dim)
    local = dict(p, **{k: p[k][..., cols] for k in ("wk", "wv", "bk", "bv") if k in p})
    q, k, v = _project_qkv(local, x, hq, count, head_dim, norm)
    if index is not None:
        k, v = k[:, index], v[:, index]
    return q, k, v


def attention_forward(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                      head_dim: int, rope_theta: Optional[float],
                      causal: bool = True, window: Optional[int] = None,
                      pos_offset: int = 0, tp=None, norm=None) -> torch.Tensor:
    """Full-sequence attention (prefill path): x [B, S, D] -> [B, S, D].
    ``tp``: on this process's heads (:func:`local_heads`, :func:`_local_qkv`;
    none at all where it holds no head), ``wo`` its rows of them, the output
    summed over the model group.  ``norm``: (weight, eps) of the RMSNorm
    that x takes first, fused into the projections (:func:`norm_linear`)."""
    b, s, _ = x.shape
    if tp is None:
        q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, norm)
    else:
        p, _, _ = local_heads(p, n_heads, head_dim, tp)
        q, k, v = _local_qkv(p, x, n_heads, n_kv, head_dim, tp, norm)
    if rope_theta is not None:
        pos = torch.arange(s, device=x.device) + pos_offset
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    o = attention(q, k, v, causal, window, pos_offset)
    y = o.transpose(1, 2).reshape(b, s, q.shape[1] * head_dim) @ p["wo"]
    return y if tp is None else tp.sum(y)


# -- KV caches ------------------------------------------------------------------


def init_kv_cache(n_layers: int, batch: int, n_kv: int, cache_len: int,
                  head_dim: int, dtype, device, kv=None) -> Params:
    """Ring-buffer KV cache, stacked over layers; ``cache_len`` = window or seq.
    ``kv``: this process's block of it over the model group
    (``sharding/specs.py::KVLayout``: its KV heads, its slots); ``slot_pos``
    always covers the whole ring."""
    shape = (n_layers, batch, n_kv, cache_len, head_dim) if kv is None else (
        n_layers, batch, kv.heads(n_kv), kv.slots, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((n_layers, cache_len), -1, dtype=torch.int64,
                               device=device),
    }


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
            head_dim: int, group=None) -> torch.Tensor:
    """q [B, H, 1, dh] over the slots of k, v [B, H, W, dh] where ``valid`` [W],
    in at least float32.  ``group``: the slots are this process's block of
    the ring (``"seq"``), and the blocks are combined over the group's
    processes as a flash-decoding step: the scores' max by one MAX
    all_reduce, then ``[sum exp(s - max) v, sum exp(s - max)]`` by one sum."""
    s = torch.einsum("bhqd,bhkd->bhqk", up32(q), up32(k)) / math.sqrt(head_dim)
    s = torch.where(valid[None, None, None, :], s, float("-inf"))
    if group is None:
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), up32(v))
    mx = group.max(s.amax(-1, keepdim=True))         # a slot of pos is always valid
    e = torch.exp(s - mx)
    parts = group.sum(torch.cat([torch.einsum("bhqk,bhkd->bhqd", e, up32(v)),
                                 e.sum(-1, keepdim=True)], dim=-1))
    return parts[..., :-1] / parts[..., -1:]


def _gather_heads(q, k, v, n_heads: int, tp):
    """The new token's q of every query head and k, v of every KV head, over
    the model group in head order, from each process's q of its heads and
    k, v of the KV heads they read: one copy a query head, padded to
    ``ceil(H / m)`` heads (the gather takes equal sizes), gathered, the
    pads dropped (the caller keeps every ``H / Hkv``-th k, v copy)."""
    hq, m = q.shape[1], tp.size
    if hq and k.shape[1] != hq:
        k, v = (t.repeat_interleave(hq // t.shape[1], dim=1) for t in (k, v))
    most = -(-n_heads // m)
    qkv = torch.nn.functional.pad(torch.stack([q, k, v]), (0, 0, 0, 0, 0, most - hq))
    qkv = tp.gather(qkv).movedim(0, 2).flatten(2, 3)        # [3, B, m most, 1, dh]
    if n_heads % m:
        keep = [r * most + j for r in range(m) for j in range(head_range(n_heads, m, r)[1])]
        qkv = qkv[:, :, keep]
    return qkv[0], qkv[1], qkv[2]


def attention_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, *,
                     n_heads: int, n_kv: int, head_dim: int,
                     rope_theta: Optional[float], tp=None, kv=None) -> torch.Tensor:
    """One decode step against one layer's ring-buffer cache.

    x [B, 1, D] is the token at absolute position ``pos``.  RoPE is applied
    at write time.  The cache tensors (``k``, ``v`` [B, Hkv, W, dh],
    ``slot_pos`` [W]) are updated in place, where the reference returns new
    ones.

    Over a model group that holds the rows replicated (serving's TP use):
    ``tp``, this process's place in the group, whose query heads
    (:func:`local_heads`: ``wq``/``bq`` columns and ``wo`` rows, blocks as
    held or cut from whole leaves) it computes, and ``kv`` the cache's
    ``sharding/specs.py::KVLayout`` (``None``: each process holds it whole;
    a split cache needs ``tp``).

      * ``"heads"``: the process's query heads and its ``Hkv / m`` KV heads
        (:func:`_local_qkv`), its KV heads' slot written, its rows of ``wo``,
        then ``tp.sum``: ``attention_forward``'s rule at one position;
      * ``"seq"``: the process holds every KV head at its block of slots.
        Its heads' q and the KV heads they read are projected
        (:func:`_local_qkv`) and gathered over the group in head order
        (:func:`_gather_heads`).  The slot's owner writes k and v, every
        process ``slot_pos``; every head runs over the process's slots,
        combined over the group (:func:`_attend`); then its heads' rows of
        ``wo`` and ``tp.sum``;
      * whole: every process writes every KV head (``wk``/``wv`` read
        whole), runs its query heads over the KV heads they read, its rows
        of ``wo``, then ``tp.sum``.

    A process of no query head (``H < m``) adds zeros to the sum.
    """
    b = x.shape[0]
    W = cache["k"].shape[2]
    width = cache["slot_pos"].shape[0]
    seq = kv is not None and kv.kind == "seq"
    h0 = 0
    if tp is None:
        q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)
    else:
        p, h0, _ = local_heads(p, n_heads, head_dim, tp)
        if kv is not None:                  # "heads", "seq": the KV heads its heads read
            q, k, v = _local_qkv(p, x, n_heads, n_kv, head_dim, tp)
        else:                               # whole: every KV head
            q, k, v = _project_qkv(p, x, p["wq"].shape[-1] // head_dim, n_kv, head_dim)
    if rope_theta is not None:
        ppos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q, ppos, rope_theta)
        k = apply_rope(k, ppos, rope_theta)
    hq, g = q.shape[1], n_heads // n_kv
    if seq:
        q, k, v = _gather_heads(q, k, v, n_heads, tp)
        k, v = k[:, ::g], v[:, ::g]          # query head h reads KV head h // g
    slot = pos % width                                       # ring write
    if not seq or kv.owner(pos) == kv.rank:
        cache["k"][:, :, slot % W] = k[:, :, 0]
        cache["v"][:, :, slot % W] = v[:, :, 0]
    cache["slot_pos"][slot] = pos
    spos = cache["slot_pos"]
    if seq:
        spos = spos[kv.rank * W:(kv.rank + 1) * W]
    valid = (spos >= 0) & (spos <= pos)                      # [W]
    kk, vv = cache["k"], cache["v"]
    if tp is not None and kv is None:                        # whole: this process's heads
        reads = [(h0 + j) // g for j in range(hq)]
        kk, vv = kk[:, reads], vv[:, reads]
    else:
        kk = kk.repeat_interleave(q.shape[1] // kk.shape[1], dim=1)   # [B,H,W,dh]
        vv = vv.repeat_interleave(q.shape[1] // vv.shape[1], dim=1)
    o = _attend(q, kk, vv, valid, head_dim, tp if seq else None).to(x.dtype)
    if seq:
        o = o[:, h0:h0 + hq]
    y = o.transpose(1, 2).reshape(b, 1, o.shape[1] * head_dim) @ p["wo"]
    return y if tp is None else tp.sum(y)


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
