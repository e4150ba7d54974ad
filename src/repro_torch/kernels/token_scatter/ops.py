"""Row gather ``out[i] = x[idx[i]]`` (zero row where ``idx[i] < 0``).

Counterpart of ``repro/kernels/token_scatter``.  :func:`token_gather`
launches the hand-written CUDA kernel (``csrc/token_gather.cu``) on a CUDA
tensor and uses :func:`token_gather_ref`, the plain version, only on a CPU
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
    ctypes.c_int, ctypes.c_void_p]


def token_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[i] = x[clip(idx[i])]`` for ``idx[i] >= 0`` else 0."""
    safe = idx.clamp(0, x.shape[0] - 1).long()
    out = x[safe]
    return torch.where((idx >= 0)[:, None], out, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))


def token_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [N, D] float32 or bfloat16, idx: [M] int32/int64 -> [M, D]."""
    if x.device.type == "cpu":
        return token_gather_ref(x, idx)
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError(f"token_gather: x on {x.device}, idx on {idx.device}")
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"token_gather: x {tuple(x.shape)}, idx {tuple(idx.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"token_gather: unsupported dtype {x.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"token_gather: index dtype {idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("token_gather: x and idx must be contiguous")
    if x.shape[0] == 0:
        raise ValueError("token_gather: x has no rows")
    m = idx.shape[0]
    out = torch.empty((m, x.shape[1]), dtype=x.dtype, device=x.device)
    if m == 0 or x.shape[1] == 0:
        return out
    fn = _build.function("token_gather", "token_gather", _ARGTYPES)
    err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], m,
             x.shape[1] * x.element_size(), idx.element_size(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "token_gather")
    _build.LAUNCHES["token_gather"] += 1
    return out

