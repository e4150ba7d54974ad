"""Attention: the hand-written flash kernel, its plain versions, and the dispatch.

Counterpart of ``repro/kernels/flash_attention``.  :func:`flash_attention`
launches a CUDA kernel (``csrc/flash_attention.cu``) on CUDA tensors, by
dtype: bfloat16 on tensor cores (wgmma, K/V tiles by TMA), float32 on CUDA
cores.  It uses :func:`mha_ref`, the plain version, only on CPU tensors.
:func:`chunked_attention` is the reference's online softmax over key
chunks in plain torch (``ops.py:30-77``).  :func:`attention` takes the
reference's rule (``ops.py:104-116``, :func:`route`) with the card in the
TPU's place: on the card the kernel for ``Sq >= 128``; below that, and on
the CPU, :func:`chunked_attention` for ``Sk > 4096`` and :func:`mha_ref`
otherwise, differentiated by autograd.  The kernel's gradient is an
``autograd.Function`` whose backward is the reference's ``_attention_tpu``
VJP (``ops.py:86-98``): the VJP of :func:`chunked_attention`, recomputed
in float32, over chunks of 2048 keys or of all the keys where there are
fewer.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F_
from torch.autograd.function import once_differentiable

from .. import _build

#: C entry point and launch-count name of each dtype's route
_ROUTES = {torch.bfloat16: ("flash_attention_tc", "flash_attention"),
           torch.float32: ("flash_attention", "flash_attention_f32")}
_HEAD_DIMS = (64, 128)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [
    ctypes.c_int] * 3 + [ctypes.c_void_p]
#: keys a chunk of :func:`chunked_attention` (the reference's ``_CHUNK``)
_CHUNK = 2048
#: query rows a block of :func:`attention_bwd`
_BLOCK = 1024
#: the kernel's launches by their query heads (a model group's uneven heads
#: each launch on their own count); ``reset_launch_counts`` clears it
LAUNCH_HEADS: collections.Counter = collections.Counter()


def _mask(sq: int, sk: int, causal: bool, window: Optional[int], q_offset: int,
          device) -> torch.Tensor:
    """[Sq, Sk] bool: key kpos visible to query qpos = row + q_offset, that is
    ``0 <= qpos - kpos`` (causal) and ``qpos - kpos < window``: the band
    between two diagonals."""
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril(q_offset)
    if window is not None:
        mask = mask.triu(q_offset - window + 1)
    return mask


def attention_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
                    q_offset: int) -> int:
    """Query-key pairs that :func:`_mask` keeps, counted row by row."""
    total = 0
    for qpos in range(q_offset, q_offset + sq):
        hi = min(sk - 1, qpos) if causal else sk - 1
        lo = max(0, qpos - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def flash_cost(q_shape, k_numel: int, causal: bool, window: Optional[int],
               q_offset: int, sk: int, itemsize: int):
    """(flops, bytes) of one :func:`flash_attention` launch (``chip_smoke.py``'s
    bound): 4 dh flops a kept score pair, q, k, v read and o written once."""
    b, h, sq, dh = q_shape
    pairs = attention_pairs(sq, sk, causal, window, q_offset) * b * h
    q_numel = b * h * sq * dh
    return 4.0 * dh * pairs, itemsize * (2 * q_numel + 2 * k_numel)


def mha_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
            q_offset: int = 0, with_lse: bool = False):
    """Plain version: q [B,H,Sq,Dh], k/v [B,Hkv,Sk,Dh] -> [B,H,Sq,Dh].

    ``with_lse``: also each row's log-sum-exp [B,H,Sq] (its max and sum),
    what :func:`attention_bwd` takes."""
    b, h, sq, dh = q.shape
    g = h // k.shape[1]
    f = torch.promote_types(q.dtype, torch.float32)     # float64 stays float64
    kk = k.repeat_interleave(g, dim=1).to(f)
    vv = v.repeat_interleave(g, dim=1).to(f)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f), kk)
    c = torch.tensor(math.sqrt(dh), dtype=torch.float32)
    mask = _mask(sq, k.shape[2], causal, window, q_offset, q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        s = torch.where(mask[None, None], s / c, float("-inf"))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        p = p / den
    else:                    # the same arithmetic in place: one [.., Sq, Sk] tensor
        p = s.div_(c).masked_fill_(~mask, float("-inf"))
        m = p.amax(-1, keepdim=True)
        den = p.sub_(m).exp_().sum(-1, keepdim=True)
        p.div_(den)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
    return (o, (m + torch.log(den))[..., 0]) if with_lse else o


def chunked_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, chunk: int = _CHUNK, with_lse: bool = False):
    """Online softmax over key chunks of ``chunk``: flash's algorithm in plain torch.

    The reference's function in its order of operations: q scaled in
    float32 before the product, keys padded to whole chunks (the pad
    masked), GQA by repeating each key head, masked scores ``-1e30``,
    ``m``, ``l`` and the accumulator in float32 and rescaled by
    ``exp(m - m_new)``, the output ``acc / max(l, 1e-30)`` in q's dtype.
    Autograd through the loop keeps each chunk's scores for the backward.
    ``with_lse``: also each row's log-sum-exp ``m + log(l)`` [B,H,Sq].
    """
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    nc = -(-sk // chunk)
    pad = nc * chunk - sk
    if pad:
        k = F_.pad(k, (0, 0, 0, pad))
        v = F_.pad(v, (0, 0, 0, pad))
    qf = q.float() / (dh ** 0.5)
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, h, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for ci in range(nc):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk].repeat_interleave(g, dim=1).float()
        vb = v[:, :, ci * chunk:(ci + 1) * chunk].repeat_interleave(g, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = kpos[None, :] < sk
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return (o, m + torch.log(l)) if with_lse else o


def _flash(q, k, v, *, causal: bool, window: Optional[int], q_offset: int) -> torch.Tensor:
    """The forward, without a graph: the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in _ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (b, hkv, sk, dh) or tuple(v.shape) != tuple(k.shape)
            or h % hkv or dh not in _HEAD_DIMS):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"(head dim must be one of {_HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    entry, count = _ROUTES[q.dtype]
    fn = _build.function("flash_attention", entry, _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, hkv,
             sq, sk, dh, 1.0 / math.sqrt(dh), int(causal),
             0 if window is None else int(window), int(q_offset),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    _build.LAUNCHES[count] += 1
    LAUNCH_HEADS[h] += 1
    _build.report(count, lambda: (*flash_cost(q.shape, k.numel(), causal, window, q_offset,
                                              sk, q.element_size()), q.dtype))
    return o


def _visible(q0: int, q1: int, k0: int, k1: int, causal: bool,
             window: Optional[int]) -> Tuple[bool, bool]:
    """(any, every) query position of [q0, q1] sees a key of [k0, k1] under
    :func:`_mask`'s rule (positions inclusive; the band ``0 <= q - k <
    window`` meets the rectangle where its extremes of ``q - k`` do)."""
    lo, hi = q0 - k1, q1 - k0                         # q - k over the rectangle
    top = hi if window is None else min(hi, window - 1)
    bottom = max(lo, 0) if causal else lo
    every = (not causal or lo >= 0) and (window is None or hi <= window - 1)
    return bottom <= top, every


def _blocks(sq: int, sk: int, q_offset: int, causal: bool, window: Optional[int],
            chunk: int, block: int):
    """(k0, k1, q0, q1, every) of each (key chunk, query block) pair the mask
    does not hide entirely, key chunks outermost; ``every``: no key of the
    pair is masked."""
    for k0 in range(0, sk, chunk):
        k1 = min(sk, k0 + chunk)
        for q0 in range(0, sq, block):
            q1 = min(sq, q0 + block)
            anyv, every = _visible(q0 + q_offset, q1 - 1 + q_offset, k0, k1 - 1,
                                   causal, window)
            if anyv:
                yield k0, k1, q0, q1, every


def _root(dh: int) -> float:
    """``sqrt(dh)`` rounded to float32, the scale :func:`mha_ref` and
    :func:`chunked_attention` divide by (float64 inputs too)."""
    return ctypes.c_float(math.sqrt(dh)).value


def _rows(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, H, S, ...] -> [B Hkv, S G, ...]: each KV head's G query heads as the
    rows of one product, position-major (a query block's rows contiguous)."""
    b, h, sq = t.shape[:3]
    t = t.reshape(b, hkv, h // hkv, sq, *t.shape[3:]).transpose(2, 3)
    return t.reshape(b * hkv, sq * (h // hkv), *t.shape[4:])


def _heads(t: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """:func:`_rows`'s inverse."""
    hkv = t.shape[0] // b
    sq = t.shape[1] * hkv // h
    t = t.reshape(b, hkv, sq, h // hkv, *t.shape[2:]).transpose(2, 3)
    return t.reshape(b, h, sq, *t.shape[4:])


def attention_lse(q, k, *, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, chunk: int = _CHUNK, block: int = _BLOCK) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores [B,H,Sq], in
    ``promote_types(q.dtype, float32)``: one product a (query block, key
    chunk) pair the mask leaves, online over the chunks as
    :func:`chunked_attention` takes them (a row that sees no key: ``-inf``)."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    grp = h // hkv
    f = torch.promote_types(q.dtype, torch.float32)
    with torch.no_grad():
        qs = _rows(q.to(f) / _root(dh), hkv)
        kf = k.to(f).reshape(b * hkv, sk, dh)
        m = torch.full(qs.shape[:2], -1e30, dtype=f, device=q.device)
        l = torch.zeros(qs.shape[:2], dtype=f, device=q.device)
        for k0, k1, q0, q1, every in _blocks(sq, sk, q_offset, causal, window, chunk, block):
            r0, r1 = q0 * grp, q1 * grp
            s = torch.bmm(qs[:, r0:r1], kf[:, k0:k1].transpose(1, 2))
            if not every:
                s.view(-1, q1 - q0, grp, k1 - k0).masked_fill_(
                    ~_mask(q1 - q0, k1 - k0, causal, window, q0 + q_offset - k0,
                           q.device)[:, None], float("-inf"))
            mb, lb = m[:, r0:r1], l[:, r0:r1]
            m_new = torch.maximum(mb, s.amax(-1))
            lb.mul_(torch.exp(mb - m_new)).add_(s.sub_(m_new[..., None]).exp_().sum(-1))
            mb.copy_(m_new)
        return _heads(m + torch.log(l), b, h)


def attention_bwd(q, k, v, o, g, lse: Optional[torch.Tensor] = None, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0, chunk: int = _CHUNK,
                  block: int = _BLOCK):
    """(dq, dk, dv) of attention's output o for its gradient g, from o and the
    rows' log-sum-exp ``lse`` [B,H,Sq] (None: :func:`attention_lse` first).

    FlashAttention-2's backward in plain torch: ``D = rowsum(g * o)``, then
    for each key chunk of ``chunk`` and query block of ``block`` rows that
    the mask does not hide entirely, ``P = exp(S - lse)``, ``dV += P^T g``,
    ``dP = g V^T``, ``dS = P * (dP - D)``, ``dQ += dS K``, ``dK += dS^T Q``
    (GQA: the query heads of a KV head are one product's rows, so dK and dV
    sum over them).  What it holds at once beyond the gradients is one
    block x chunk a tensor; nothing of Sq x Sk.  A hidden pair is exact to
    skip for a row that sees a key: :func:`chunked_attention` gives its
    masked scores ``-1e30``, whose weights ``exp(-1e30 - m)`` are 0.  A row
    that sees no key keeps ``m = -1e30`` there and weighs each key of the
    ``ceil(Sk / chunk)`` chunks, pad included, 1: its output is their mean,
    so its VJP adds ``g / (that many keys)`` to every key's dV and nothing
    to dQ or dK.  Computed in ``promote_types(dtype, float32)`` (float64
    stays float64), each gradient returned in its input's dtype.
    """
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    grp = h // hkv
    f = torch.promote_types(q.dtype, torch.float32)
    if lse is None:
        lse = attention_lse(q, k, causal=causal, window=window, q_offset=q_offset,
                            chunk=chunk, block=block)
    c = _root(dh)
    qpos = torch.arange(q_offset, q_offset + sq, device=q.device)
    hi = torch.clamp(qpos, max=sk - 1) if causal else torch.full_like(qpos, sk - 1)
    lo = torch.clamp(qpos - window + 1, min=0) if window is not None else torch.zeros_like(qpos)
    empty = hi < lo                                   # rows that see no key
    gf = g.to(f)
    D = _rows((gf * o.to(f)).sum(-1), hkv)
    lse = _rows(torch.where(empty, float("inf"), lse.to(f)), hkv)
    qs, gr = _rows(q.to(f) / c, hkv), _rows(gf, hkv)
    kf, vf = k.to(f).reshape(b * hkv, sk, dh), v.to(f).reshape(b * hkv, sk, dh)
    dq, dk, dv = torch.zeros_like(qs), torch.zeros_like(kf), torch.zeros_like(vf)
    for k0, k1, q0, q1, every in _blocks(sq, sk, q_offset, causal, window, chunk, block):
        r0, r1 = q0 * grp, q1 * grp
        qb, gb, kc, vc = qs[:, r0:r1], gr[:, r0:r1], kf[:, k0:k1], vf[:, k0:k1]
        p = torch.bmm(qb, kc.transpose(1, 2))                               # S, then P
        if not every:
            p.view(-1, q1 - q0, grp, k1 - k0).masked_fill_(
                ~_mask(q1 - q0, k1 - k0, causal, window, q0 + q_offset - k0,
                       q.device)[:, None], float("-inf"))
        p.sub_(lse[:, r0:r1, None]).exp_()
        dv[:, k0:k1].baddbmm_(p.transpose(1, 2), gb)
        ds = torch.bmm(gb, vc.transpose(1, 2)).sub_(D[:, r0:r1, None]).mul_(p)  # dP, then dS
        del p
        dq[:, r0:r1].baddbmm_(ds, kc)
        dk[:, k0:k1].baddbmm_(ds.transpose(1, 2), qb)
        del ds
    gsum = (gf * empty[:, None]).sum(2).reshape(b, hkv, grp, dh).sum(2)
    dv += gsum.reshape(b * hkv, 1, dh) / (-(-sk // chunk) * chunk)
    return (_heads(dq, b, h).div_(c).to(q.dtype), dk.view(k.shape).to(k.dtype),
            dv.view(v.shape).to(v.dtype))


def flash_attention_bwd(q, k, v, g, *, causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0):
    """(dq, dk, dv) for the output's gradient g: the VJP of :func:`chunked_attention`.

    The reference's ``_bwd`` (``ops.py:90-98``) by :func:`attention_bwd`:
    o and the rows' log-sum-exp recomputed by :func:`chunked_attention` from
    q, k and v in float32, without a graph.  Gradients come back in the
    inputs' dtypes.  The chunk is the reference's 2048 keys, or all of them
    where there are fewer: one chunk either way, and the reference's pad to
    2048 adds only masked keys, whose probabilities are exact zeros.
    """
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=min(_CHUNK, k.shape[2]))
    with torch.no_grad():
        qf, kf, vf = (t.detach().float() for t in (q, k, v))
        o, lse = chunked_attention(qf, kf, vf, with_lse=True, **kw)
        dq, dk, dv = attention_bwd(qf, kf, vf, o, g.float(), lse, **kw)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    """Attention differentiated as the reference's ``_attention_tpu`` custom VJP
    is, for every route: the forward is the route's own function (``name``:
    :func:`route`'s), and only q, k, v, o and the rows' log-sum-exp are kept
    for :func:`attention_bwd` (the kernel's forward writes none: there the
    backward computes it).  The backward's chunk is 2048 keys, or all of
    them where there are fewer, as :func:`flash_attention_bwd`'s."""

    @staticmethod
    def forward(ctx, q, k, v, name, causal, window, q_offset):
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        if name == "flash_attention":
            o, lse = _flash(q, k, v, **ctx.mask), None
        elif name == "chunked_attention":
            o, lse = chunked_attention(q, k, v, with_lse=True, **ctx.mask)
        else:                # by query blocks: one block x Sk of scores at a time
            parts = [mha_ref(q[:, :, a:a + _BLOCK], k, v, causal=causal, window=window,
                             q_offset=q_offset + a, with_lse=True)
                     for a in range(0, q.shape[2], _BLOCK)]
            o, lse = (torch.cat(t, 2) if len(t) > 1 else t[0] for t in zip(*parts))
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        grads = attention_bwd(q, k, v, o, g, lse, chunk=min(_CHUNK, k.shape[2]), **ctx.mask)
        return (*grads, None, None, None, None)


def _differentiable(q, k, v) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention; GQA via Hkv | H.

    Differentiable in q, k and v (:class:`_Attention`); without a gradient
    to take it builds no graph.
    """
    if _differentiable(q, k, v):
        return _Attention.apply(q, k, v, "flash_attention", causal, window, q_offset)
    return _flash(q, k, v, causal=causal, window=window, q_offset=q_offset)


def route(device_type: str, sq: int, sk: int) -> str:
    """The function :func:`attention` takes for ``sq`` queries over ``sk`` keys.

    The reference's rule with the card in the TPU's place: the kernel on
    the card from 128 queries; else :func:`chunked_attention` above ``2 *
    _CHUNK`` keys and :func:`mha_ref` below.
    """
    if device_type == "cuda" and sq >= 128:
        return "flash_attention"
    return "chunked_attention" if sk > 2 * _CHUNK else "mha_ref"


def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """[B,H,Sq,Dh] x [B,Hkv,Sk,Dh]^2 -> [B,H,Sq,Dh]; GQA via Hkv | H.

    H = 0 (a process of the model group that holds no query head,
    ``sharding/tp.py::head_range``): the empty output, launched nowhere,
    still reads q, k and v, so that the gathers of their leaves run their
    backward in this process as in the others."""
    if q.shape[1] == 0:
        return q + (k.sum() + v.sum()).to(q.dtype) * 0
    name = route(q.device.type, q.shape[2], k.shape[2])
    if name == "flash_attention":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, q_offset=q_offset)
    if _differentiable(q, k, v):
        return _Attention.apply(q, k, v, name, causal, window, q_offset)
    if name == "chunked_attention":
        return chunked_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
