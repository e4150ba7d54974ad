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
from typing import Optional

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
#: the kernel's launches by their query heads (a model group's uneven heads
#: each launch on their own count); ``reset_launch_counts`` clears it
LAUNCH_HEADS: collections.Counter = collections.Counter()


def _mask(sq: int, sk: int, causal: bool, window: Optional[int], q_offset: int,
          device) -> torch.Tensor:
    """[Sq, Sk] bool: key kpos visible to query qpos."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
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
            q_offset: int = 0) -> torch.Tensor:
    """Plain version: q [B,H,Sq,Dh], k/v [B,Hkv,Sk,Dh] -> [B,H,Sq,Dh]."""
    b, h, sq, dh = q.shape
    g = h // k.shape[1]
    f = torch.promote_types(q.dtype, torch.float32)     # float64 stays float64
    kk = k.repeat_interleave(g, dim=1).to(f)
    vv = v.repeat_interleave(g, dim=1).to(f)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f), kk)
    s = s / torch.tensor(math.sqrt(dh), dtype=torch.float32)
    mask = _mask(sq, k.shape[2], causal, window, q_offset, q.device)
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, chunk: int = _CHUNK) -> torch.Tensor:
    """Online softmax over key chunks of ``chunk``: flash's algorithm in plain torch.

    The reference's function in its order of operations: q scaled in
    float32 before the product, keys padded to whole chunks (the pad
    masked), GQA by repeating each key head, masked scores ``-1e30``,
    ``m``, ``l`` and the accumulator in float32 and rescaled by
    ``exp(m - m_new)``, the output ``acc / max(l, 1e-30)`` in q's dtype.
    Autograd through the loop keeps each chunk's scores for the backward.
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
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


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


def flash_attention_bwd(q, k, v, g, *, causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0):
    """(dq, dk, dv) for the output's gradient g: the VJP of :func:`chunked_attention`.

    The reference's ``_bwd`` (``ops.py:90-98``): :func:`chunked_attention`
    recomputed from q, k and v in float32 and differentiated by
    ``torch.autograd.grad``.  Gradients come back in the inputs' dtypes.
    The chunk is the reference's 2048 keys, or all of them where there are
    fewer: one chunk either way, and the reference's pad to 2048 adds only
    masked keys, whose probabilities are exact zeros.
    """
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
        o = chunked_attention(qf, kf, vf, causal=causal, window=window, q_offset=q_offset,
                              chunk=min(_CHUNK, k.shape[2]))
        dq, dk, dv = torch.autograd.grad(o, (qf, kf, vf), g.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_attention_tpu`` custom VJP: kernel forward, chunked backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return _flash(q, k, v, **ctx.mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (*flash_attention_bwd(*ctx.saved_tensors, g, **ctx.mask), None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention; GQA via Hkv | H.

    Differentiable in q, k and v (``flash_attention_bwd``); without a
    gradient to take it builds no graph.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
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
    if name == "chunked_attention":
        return chunked_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
