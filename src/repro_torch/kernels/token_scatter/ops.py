"""Row gather ``out[i] = x[idx[i]]`` (zero row where ``idx[i] < 0``).

Counterpart of ``repro/kernels/token_scatter``.  :func:`token_gather`
launches the hand-written CUDA kernel (``csrc/token_gather.cu``) on a CUDA
tensor and uses :func:`token_gather_ref`, the plain version, only on a CPU
tensor.  :func:`geometry` is the kernel's launch geometry, computed here so
that a CPU test can check that it covers every byte of every row once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import _build

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p]

THREADS = 256       #: threads a block (csrc/token_gather.cu)
UNROLL = 4          #: loads in flight a thread (csrc/token_gather.cu: kUnroll)
SEG_BYTES = 16384   #: bytes of a row one unit copies at most


class Geometry(NamedTuple):
    """How the kernel cuts the copy: words, segments, units and the grid."""

    word: int                 # bytes a thread moves a load: 16, 4 or 2
    row_words: int
    seg_words: int            # words of a row one unit copies
    group: int                # threads a unit (a power of two)
    grid: Tuple[int, int]     # (blocks of THREADS // group rows, segments a row)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def geometry(row_bytes: int, m: int, align: int) -> Geometry:
    """The launch for ``m`` rows of ``row_bytes`` (even) bytes.

    ``align`` is the bitwise or of the two base addresses.  A unit is a
    group of threads that copies one segment of at most ``SEG_BYTES`` of a
    row, each thread ``UNROLL`` words at a time; narrow rows pack several
    units into a block.
    """
    if row_bytes < 2 or row_bytes % 2:
        raise ValueError(f"token_gather: row of {row_bytes} bytes")
    word = next(w for w in (16, 4, 2) if row_bytes % w == 0 and align % w == 0)
    row_words = row_bytes // word
    seg = min(row_words, max(1, SEG_BYTES // word))
    group = _pow2_at_least(-(-seg // UNROLL))
    group = min(THREADS, max(group, min(4, _pow2_at_least(seg))))
    units = THREADS // group
    return Geometry(word, row_words, seg, group, (-(-m // units), -(-row_words // seg)))


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.function("token_gather", "token_gather", _ARGTYPES)


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
    row_bytes = x.shape[1] * x.element_size()
    g = geometry(row_bytes, m, (x.data_ptr() | out.data_ptr()) & 15)
    err = _entry()(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], m, row_bytes,
                   idx.element_size(), g.word, g.seg_words, g.group, *g.grid,
                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "token_gather")
    _build.LAUNCHES["token_gather"] += 1
    return out
