"""Row gather ``out[i] = x[idx[i]]`` (zero row where ``idx[i] < 0``) and its backward.

Counterpart of ``repro/kernels/token_scatter``.  :func:`token_gather`
launches the hand-written CUDA kernel (``csrc/token_gather.cu``) on a CUDA
tensor and uses :func:`token_gather_ref`, the plain version, only on a CPU
tensor.  :func:`geometry` is the kernel's launch geometry, computed here so
that a CPU test can check that it covers every byte of every row once.

Where ``x`` needs a gradient (and grad mode is on), :func:`token_gather`
is an ``autograd.Function`` whose backward is the reference's ``_bwd``
(``ops.py:30-36``): ``gx[n] = sum of g[i] over idx[i] = n`` for
``idx[i] >= 0`` (indices past the last row clip to it), no gradient for
``idx``.  It saves only ``idx`` and ``N``.  The backward runs
:func:`token_scatter_add`, the port's own kernel
(``csrc/token_scatter_add.cu``; the reference's is an XLA scatter-add):
one launch builds the inverse index (a counting sort, equal to
:func:`inverse_index`, the plain version), a second sums each row's
sources in increasing ``i`` in float32 (a single source is copied as it
is), without atomics on data, so a second run gives the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import _build

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p]
_ADD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong] + [
    ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p]
_INDEX_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_int] + [
    ctypes.c_void_p] * 3

THREADS = 256       #: threads a block (csrc/token_gather.cu, csrc/token_scatter_add.cu)
UNROLL = 4          #: words in flight a thread (both kernels' kUnroll)
SEG_BYTES = 16384   #: bytes of a row one unit copies at most
INDEX_KEYS = 512    #: row ids one block of the inverse-index launch counts (kKeys)


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


@functools.lru_cache(maxsize=None)
def _add_entry():
    return _build.function("token_scatter_add", "token_scatter_add", _ADD_ARGTYPES)


@functools.lru_cache(maxsize=None)
def _index_entry():
    return _build.function("token_scatter_add", "token_scatter_index", _INDEX_ARGTYPES)


def gather_bytes(valid: int, m: int, row_bytes: int, index_bytes: int) -> int:
    """Least bytes of one :func:`token_gather` launch (``chip_smoke.py``'s
    bound): the ``valid`` rows it reads (index >= 0), the ``m`` rows it
    writes and the indices."""
    return (valid + m) * row_bytes + m * index_bytes


def scatter_add_bytes(valid: int, n: int, row_bytes: int, m: int, index_bytes: int) -> int:
    """Least bytes of one :func:`token_scatter_add` call (``chip_smoke.py``'s
    bound): the ``valid`` rows of g it reads, the ``n`` rows it writes and
    the ``m`` indices."""
    return (valid + n) * row_bytes + m * index_bytes


def inverse_index_bytes(m: int, n: int, index_bytes: int) -> int:
    """Least bytes of one :func:`build_inverse_index` launch: the indices
    read, ``order`` [m] and ``offsets`` [n + 1] (int64) written."""
    return m * index_bytes + (m + n + 1) * 8


def _valid(idx: torch.Tensor) -> int:
    return int((idx >= 0).sum())


def _check_cuda(name: str, t: torch.Tensor, idx: torch.Tensor) -> None:
    if t.device.type != "cuda" or idx.device != t.device:
        raise ValueError(f"{name}: tensor on {t.device}, idx on {idx.device}")
    if t.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: tensor {tuple(t.shape)}, idx {tuple(idx.shape)}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: index dtype {idx.dtype}")
    if not (t.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: tensor and idx must be contiguous")


def token_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[i] = x[clip(idx[i])]`` for ``idx[i] >= 0`` else 0."""
    safe = idx.clamp(0, x.shape[0] - 1).long()
    out = x[safe]
    return torch.where((idx >= 0)[:, None], out, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The forward, without a graph: the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return token_gather_ref(x, idx)
    _check_cuda("token_gather", x, idx)
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
    _build.report("token_gather", lambda: (
        0.0, gather_bytes(_valid(idx), m, row_bytes, idx.element_size()), x.dtype))
    return out


class _TokenGather(torch.autograd.Function):
    """``token_gather`` with the reference's scatter-add VJP."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = x.shape[0]
        return _gather(x, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return token_scatter_add(g.contiguous(), idx, ctx.n_rows), None


def token_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [N, D] float32 or bfloat16, idx: [M] int32/int64 -> [M, D].

    Differentiable in ``x``; a call whose ``x`` needs no gradient builds no
    graph.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        return _TokenGather.apply(x, idx)
    return _gather(x, idx)


# -- the backward: scatter-add of rows ----------------------------------------------


def token_scatter_add_ref(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version: ``gx[r] = sum of g[i] over clip(idx[i]) = r, idx[i] >= 0``.

    Summed in float32 by ``index_add_`` and cast to ``g``'s dtype once.  Rows
    with ``idx < 0`` are summed into a dump row ``n``, dropped after, so no
    shape depends on the data.
    """
    safe = torch.where(idx >= 0, idx.clamp(0, n - 1), n).long()
    out = torch.zeros((n + 1, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, safe, g.float())[:n].to(g.dtype)


def inverse_index(idx: torch.Tensor, n: int):
    """Plain version of the inverse index: (order [M] int64, offsets [n + 1]
    int64); output row r sums the rows ``order[offsets[r]:offsets[r + 1]]``
    of g, in increasing i.

    A stable sort of the clipped 32-bit index (negative entries sort last,
    past ``offsets[n]``) and each row's first position in it by a binary
    search.  :func:`build_inverse_index` is its kernel.
    """
    key = torch.where(idx < 0, n, idx.clamp_max(n - 1)).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    rows = torch.arange(n + 1, dtype=torch.int32, device=idx.device)
    return order, torch.searchsorted(sorted_key, rows)


def _index_checks(idx: torch.Tensor, n: int) -> None:
    if n < 1 or n >= 2**31 - 1 or idx.shape[0] >= 2**31 - 1:
        raise ValueError(f"inverse index: {n} rows, {idx.shape[0]} indices")


def build_inverse_index(idx: torch.Tensor, n: int):
    """:func:`inverse_index` by the hand-written launch (``csrc/token_scatter_add.cu``,
    ``inverse_index``): a counting sort in one launch, no host read-back.

    Equal to :func:`inverse_index` bit for bit; on a CPU tensor it is that
    plain version.  One block per ``INDEX_KEYS`` of the ``n + 1`` row ids
    (the last for ``idx < 0``), each reading every index.
    """
    if idx.device.type == "cpu":
        return inverse_index(idx, n)
    if idx.device.type != "cuda" or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"build_inverse_index: idx {tuple(idx.shape)} on {idx.device}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"build_inverse_index: index dtype {idx.dtype}")
    _index_checks(idx, n)
    order = torch.empty(idx.shape[0], dtype=torch.int64, device=idx.device)
    offsets = torch.empty(n + 1, dtype=torch.int64, device=idx.device)
    err = _index_entry()(idx.data_ptr(), idx.shape[0], n, idx.element_size(),
                         order.data_ptr(), offsets.data_ptr(),
                         torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check(err, "token_scatter_index")
    _build.LAUNCHES["token_scatter_index"] += 1
    _build.report("token_scatter_index", lambda: (
        0.0, inverse_index_bytes(idx.shape[0], n, idx.element_size()), idx.dtype))
    return order, offsets


def token_scatter_add(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g: [M, D] float32 or bfloat16, idx: [M] int32/int64 -> gx [n, D] in g's dtype.

    On CUDA one call, two launches: the inverse index
    (:func:`build_inverse_index`'s) and the row sums.
    """
    if g.device.type == "cpu":
        return token_scatter_add_ref(g, idx, n)
    _check_cuda("token_scatter_add", g, idx)
    if idx.shape[0] != g.shape[0]:
        raise ValueError(f"token_scatter_add: g {tuple(g.shape)}, idx {tuple(idx.shape)}")
    if n < 1:
        raise ValueError(f"token_scatter_add: {n} output rows")
    out = torch.empty((n, g.shape[1]), dtype=g.dtype, device=g.device)
    if g.shape[1] == 0:
        return out
    if g.shape[0] == 0:
        return out.zero_()
    _index_checks(idx, n)
    order = torch.empty(idx.shape[0], dtype=torch.int64, device=g.device)
    offsets = torch.empty(n + 1, dtype=torch.int64, device=g.device)
    row_bytes = g.shape[1] * g.element_size()
    geo = geometry(row_bytes, n, (g.data_ptr() | out.data_ptr()) & 15)
    err = _add_entry()(g.data_ptr(), idx.data_ptr(), idx.element_size(), idx.shape[0],
                       order.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, row_bytes,
                       int(g.dtype == torch.bfloat16), geo.word, geo.seg_words, geo.group,
                       *geo.grid, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "token_scatter_add")
    _build.LAUNCHES["token_scatter_index"] += 1
    _build.LAUNCHES["token_scatter_add"] += 1
    # one bound for the call, as chip_smoke.py counts it: the index launch's
    # order and offsets are the call's scratch
    _build.report("token_scatter_index", lambda: (0.0, 0, idx.dtype))
    _build.report("token_scatter_add", lambda: (
        0.0, scatter_add_bytes(_valid(idx), n, row_bytes, idx.shape[0], idx.element_size()),
        g.dtype))
    return out
