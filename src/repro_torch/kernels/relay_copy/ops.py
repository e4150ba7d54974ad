"""Staged relay copy: an identity copy through two staging slots.

Counterpart of ``repro/kernels/relay_copy``, the staging discipline of the
paper's relay buffers (§IV-C).  :func:`relay_copy` is its own entry point:
nothing in the port calls it yet (nor does anything in the reference; the
dataplane's relay hop would, once a multi-GPU executor exists).  On a CUDA
tensor it launches the hand-written kernel (``csrc/relay_copy.cu``), which
moves the [N, D] input chunk by chunk (``block_chunk`` rows) through two
shared-memory slots, the slot of each chunk read on the device from
``slot_map``; on a CPU tensor it uses :func:`relay_copy_ref`, the plain
version.  The host never reads ``slot_map``'s values, so a new schedule is
a new argument to the same loaded kernel.  :func:`geometry` cuts the copy
into tiles and picks the route: Hopper's bulk-copy engine where the chunk
size and both pointers are 16-byte aligned, else 4- or 2-byte words.

The kernel has no backward (nor has the reference's): on the card, with
grad mode on and ``x`` needing a gradient, it raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .. import _build

N_SLOTS = 2
SLOT_BYTES = 96 * 1024       #: the bulk route's largest tile, one slot (kMaxTile)
WORD_SLOT_BYTES = 32 * 1024  #: the word routes' tile (kWordTile)
WORD_BLOCKS_PER_SM = 3       #: the word routes' blocks a SM
_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] + [
    ctypes.c_longlong] * 3 + [ctypes.c_void_p]
#: launch-count name of each word size's route
_COUNTS = {16: "relay_copy", 4: "relay_copy_w4", 2: "relay_copy_w2"}


class Geometry(NamedTuple):
    """How the kernel cuts the copy: its route, tiles and grid."""

    word: int              # 16: the bulk route; 4 or 2: the word routes
    tile_bytes: int        # one slot; the last tile of a chunk is shorter
    tiles_per_chunk: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def geometry(n_chunks: int, chunk_bytes: int, align: int, sms: int) -> Geometry:
    """The launch for ``n_chunks`` chunks of ``chunk_bytes`` (even) bytes.

    ``align`` is the bitwise or of the two base addresses, ``sms`` the
    card's SM count.  Tiles are dealt round-robin in address order.  The
    bulk route runs one block a SM and takes a tile of at most
    ``SLOT_BYTES`` (a multiple of 16) for which the busiest block moves at
    most 2% more than the fewest bytes it could; among those, the one whose
    blocks' consecutive tiles alternate slots most often under the default
    parity map.
    """
    if n_chunks < 1 or chunk_bytes < 2 or chunk_bytes % 2:
        raise ValueError(f"relay_copy: {n_chunks} chunks of {chunk_bytes} bytes")
    word = next(w for w in (16, 4, 2) if chunk_bytes % w == 0 and align % w == 0)
    if word != 16:
        tile = min(chunk_bytes, WORD_SLOT_BYTES // word * word)
        per = -(-chunk_bytes // tile)
        return Geometry(word, tile, per, min(n_chunks * per, sms * WORD_BLOCKS_PER_SM))
    t0 = -(-chunk_bytes // SLOT_BYTES)
    options = []
    for t in range(t0, 4 * t0 + 1):
        tile = -(-chunk_bytes // (16 * t)) * 16
        per = -(-chunk_bytes // tile)
        blocks = min(sms, n_chunks * per)
        busiest = -(-(n_chunks * per) // blocks) * tile
        options.append((busiest, _alternation(blocks, per), Geometry(16, tile, per, blocks)))
    least = min(o[0] for o in options)
    return max((o for o in options if o[0] <= 1.02 * least), key=lambda o: (o[1], -o[0]))[2]


def _alternation(blocks: int, per: int) -> float:
    """The share of a block's consecutive tiles (``blocks`` tiles apart, ``per``
    tiles a chunk) that lie in chunks of other parity: under the parity map
    their load overlaps the store before them."""
    k, r = divmod(blocks, per)
    return (r if k % 2 == 0 else per - r) / per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.function("relay_copy", "relay_copy", _ARGTYPES)


def parity_slot_map(n_chunks: int, device="cpu") -> torch.Tensor:
    """The default double-buffer schedule: slot = chunk parity."""
    return torch.arange(n_chunks, dtype=torch.int32, device=device) % N_SLOTS


def _check(x: torch.Tensor, slot_map: Optional[torch.Tensor], block_chunk: int) -> int:
    """The reference's shape rules; returns the number of chunks."""
    if x.dim() != 2:
        raise ValueError(f"relay_copy: x must be [N, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"relay_copy: unsupported dtype {x.dtype}")
    n = x.shape[0]
    bc = min(block_chunk, n)
    if bc < 1 or n % bc:
        raise ValueError(f"relay_copy: {n} rows do not split into chunks of {bc}")
    n_chunks = n // bc
    if slot_map is not None:
        if tuple(slot_map.shape) != (n_chunks,) or slot_map.dtype != torch.int32:
            raise ValueError(f"relay_copy: slot_map {tuple(slot_map.shape)} "
                             f"{slot_map.dtype}, want ({n_chunks},) int32")
        if slot_map.device != x.device:
            raise ValueError(f"relay_copy: slot_map on {slot_map.device}, x on {x.device}")
    return n_chunks


def relay_bytes(numel: int, itemsize: int, n_chunks: int) -> int:
    """Least bytes of one :func:`relay_copy` launch: x read and written once
    and the int32 slot map read."""
    return 2 * numel * itemsize + n_chunks * 4


def relay_copy_ref(x: torch.Tensor, slot_map: Optional[torch.Tensor] = None, *,
                   block_chunk: int = 256) -> torch.Tensor:
    """Plain version: a copy of ``x``, after the same shape checks."""
    _check(x, slot_map, block_chunk)
    return x.clone()


def relay_copy(x: torch.Tensor, slot_map: Optional[torch.Tensor] = None, *,
               block_chunk: int = 256) -> torch.Tensor:
    """Identity copy of x [N, D] (float32, bfloat16 or int32) -> a new tensor.

    ``slot_map`` [N / block_chunk] int32 gives each chunk's staging slot
    (default: :func:`parity_slot_map`); any map gives the same bits.
    """
    if x.device.type == "cpu":
        return relay_copy_ref(x, slot_map, block_chunk=block_chunk)
    if x.device.type != "cuda":
        raise ValueError(f"relay_copy: x on {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("relay_copy: the CUDA kernel has no backward (nor has the "
                           "reference's); x needs a gradient")
    n_chunks = _check(x, slot_map, block_chunk)
    if slot_map is None:
        slot_map = parity_slot_map(n_chunks, x.device)
    if not (x.is_contiguous() and slot_map.is_contiguous()):
        raise ValueError("relay_copy: x and slot_map must be contiguous")
    out = torch.empty_like(x)
    chunk_bytes = x.numel() // n_chunks * x.element_size()
    if chunk_bytes == 0:
        return out
    geo = geometry(n_chunks, chunk_bytes, (x.data_ptr() | out.data_ptr()) & 15,
                   _sm_count(x.device.index if x.device.index is not None
                             else torch.cuda.current_device()))
    err = _entry()(x.data_ptr(), out.data_ptr(), slot_map.data_ptr(), n_chunks, chunk_bytes,
                   *geo, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "relay_copy")
    _build.LAUNCHES[_COUNTS[geo.word]] += 1
    _build.report(_COUNTS[geo.word], lambda: (
        0.0, relay_bytes(x.numel(), x.element_size(), n_chunks), x.dtype))
    return out
