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
a new argument to the same loaded kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

N_SLOTS = 2
_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]


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
    n_chunks = _check(x, slot_map, block_chunk)
    if slot_map is None:
        slot_map = parity_slot_map(n_chunks, x.device)
    if not (x.is_contiguous() and slot_map.is_contiguous()):
        raise ValueError("relay_copy: x and slot_map must be contiguous")
    out = torch.empty_like(x)
    chunk_bytes = x.numel() // n_chunks * x.element_size()
    if chunk_bytes == 0:
        return out
    fn = _build.function("relay_copy", "relay_copy", _ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), slot_map.data_ptr(), n_chunks, chunk_bytes,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "relay_copy")
    _build.LAUNCHES["relay_copy"] += 1
    return out
