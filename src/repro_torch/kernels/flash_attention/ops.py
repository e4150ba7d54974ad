"""Attention: the hand-written flash kernel, its plain version, and the dispatch.

Counterpart of ``repro/kernels/flash_attention``.  :func:`flash_attention`
launches the CUDA kernel (``csrc/flash_attention.cu``) on CUDA tensors and
uses :func:`mha_ref`, the plain version, only on CPU tensors.
:func:`attention` keeps the reference's shape rule (``ops.py:104-116``):
the kernel for ``Sq >= 128``, the plain version below that.  The reference's
``chunked_attention`` (its non-TPU long-sequence path) is not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [
    ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def mha_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
            q_offset: int = 0) -> torch.Tensor:
    """Plain version: q [B,H,Sq,Dh], k/v [B,Hkv,Sk,Dh] -> [B,H,Sq,Dh]."""
    b, h, sq, dh = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk)
    s = s / torch.tensor(math.sqrt(dh), dtype=torch.float32)
    mask = _mask(sq, k.shape[2], causal, window, q_offset, q.device)
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention; GQA via Hkv | H."""
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    fn = _build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, hkv,
             sq, sk, dh, 1.0 / math.sqrt(dh), int(causal),
             0 if window is None else int(window), int(q_offset), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return o



def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """[B,H,Sq,Dh] x [B,Hkv,Sk,Dh]^2 -> [B,H,Sq,Dh]; GQA via Hkv | H."""
    if q.shape[2] >= 128:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, q_offset=q_offset)
    return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
