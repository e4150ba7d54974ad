"""Grouped (per-expert) SwiGLU FFN: ragged tokens -> sort/pad -> blocked kernel.

Counterpart of ``repro/kernels/grouped_ffn``.  :func:`grouped_ffn` takes
tokens in any order with ``expert_id[i] in [0, E)`` or ``-1`` for padding,
and

  1. sorts them by expert (stable) and pads each expert's segment to a
     multiple of ``block_tokens`` (``_arrange``, as ``ops.py:32-52`` of the
     reference), moving the rows with :func:`token_gather`;
  2. runs :func:`grouped_ffn_blocked` with per-block expert ids;
  3. gathers the results back into the original order.

:func:`grouped_ffn_blocked` launches the hand-written CUDA kernel
(``csrc/grouped_ffn.cu``) on CUDA tensors and uses
:func:`grouped_ffn_blocked_ref`, the plain version, only on CPU tensors.
The reference's capacity-dropping ``dense`` branch and its ``scan`` branch
are not ported: the blocked kernel is the reference's TPU branch and drops
nothing.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F_

from .. import _build
from ..token_scatter.ops import token_gather

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: the CUDA kernel's tile: rows per tile, and the widths D and F must divide by
_TILE_ROWS, _TILE_D, _TILE_F = 64, 128, 64


def _arrange(expert_id: torch.Tensor, n_experts: int, block: int):
    """Padded positions and per-block experts for ragged grouping."""
    dev = expert_id.device
    n = expert_id.shape[0]
    m_pad = (-(-n // block) + n_experts) * block  # block-aligned worst case
    key = torch.where(expert_id < 0, n_experts, expert_id).long()
    order = torch.argsort(key, stable=True)                     # sorted rows
    counts = torch.bincount(key.clamp(0, n_experts), minlength=n_experts + 1)
    aligned = (counts[:-1] + block - 1) // block * block
    aligned_off = torch.cumsum(aligned, 0) - aligned            # [E]
    seg_off = torch.cumsum(counts[:-1], 0) - counts[:-1]
    key_sorted = key[order]
    kc = key_sorted.clamp(0, n_experts - 1)
    rank = torch.arange(n, device=dev) - seg_off[kc]
    pos_sorted = aligned_off[kc] + rank
    pos_sorted = torch.where(key_sorted >= n_experts, m_pad - 1, pos_sorted)
    # block -> expert (blocks past the last segment clamp to E-1, all-zero)
    blk_start = torch.arange(m_pad // block, device=dev) * block
    blk_expert = (aligned_off[None, :] <= blk_start[:, None]).sum(1) - 1
    blk_expert = blk_expert.clamp(0, n_experts - 1)
    return order, pos_sorted, blk_expert, m_pad


def grouped_ffn_blocked_ref(x, block_expert, wg, wu, wd, *, block_tokens: int):
    """Plain version of the blocked kernel, in float32.

    Row r uses expert ``block_expert[r // block_tokens]``; the per-expert
    form of ``ref.py``: each expert's rows go through three float32
    products with that expert's weights.
    """
    row_expert = block_expert.long().repeat_interleave(block_tokens)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(wg.shape[0]):
        rows = torch.nonzero(row_expert == e).squeeze(1)
        if rows.numel() == 0:
            continue
        xe = x[rows].float()
        h = F_.silu(xe @ wg[e].float()) * (xe @ wu[e].float())
        out[rows] = h @ wd[e].float()
    return out.to(x.dtype)


def grouped_ffn_blocked(x, block_expert, wg, wu, wd, *, block_tokens: int):
    """x [M, D] sorted+padded, block_expert [M // block_tokens] -> [M, D]."""
    if x.device.type == "cpu":
        return grouped_ffn_blocked_ref(x, block_expert, wg, wu, wd,
                                       block_tokens=block_tokens)
    m, d = x.shape
    e, _, f = wg.shape
    if x.device.type != "cuda" or any(
        t.device != x.device for t in (block_expert, wg, wu, wd)
    ):
        raise ValueError("grouped_ffn_blocked: all tensors must be on one CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (wg, wu, wd)):
        raise TypeError(f"grouped_ffn_blocked: dtypes {x.dtype}, {wg.dtype}, "
                        f"{wu.dtype}, {wd.dtype}")
    if block_expert.dtype != torch.int32:
        raise TypeError("grouped_ffn_blocked: block_expert must be int32")
    if (tuple(wu.shape) != (e, d, f) or tuple(wd.shape) != (e, f, d)
            or tuple(block_expert.shape) != (m // block_tokens,)):
        raise ValueError(
            f"grouped_ffn_blocked: shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
            f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}, "
            f"block_expert {tuple(block_expert.shape)}")
    if (m % block_tokens or block_tokens % _TILE_ROWS or d % _TILE_D
            or f % _TILE_F):
        raise ValueError(
            f"grouped_ffn_blocked: needs M % block_tokens == 0, block_tokens % "
            f"{_TILE_ROWS} == 0, D % {_TILE_D} == 0, F % {_TILE_F} == 0; got "
            f"M={m}, block_tokens={block_tokens}, D={d}, F={f}")
    if not all(t.is_contiguous() for t in (x, block_expert, wg, wu, wd)):
        raise ValueError("grouped_ffn_blocked: inputs must be contiguous")
    y = torch.empty_like(x)
    if m == 0:
        return y
    h = torch.empty((m, f), dtype=torch.float32, device=x.device)  # pass-1 scratch
    fn = _build.function("grouped_ffn", "grouped_ffn_blocked", _ARGTYPES)
    err = fn(x.data_ptr(), block_expert.data_ptr(), wg.data_ptr(), wu.data_ptr(),
             wd.data_ptr(), h.data_ptr(), y.data_ptr(), m, d, f, block_tokens,
             _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "grouped_ffn_blocked")
    _build.LAUNCHES["grouped_ffn_blocked"] += 1
    return y


def grouped_ffn(x, expert_id, wg, wu, wd, *, block_tokens: int = 128):
    """out[i] = SwiGLU_{expert_id[i]}(x[i]); rows with expert_id < 0 -> 0."""
    n = x.shape[0]
    order, pos, blk_expert, m_pad = _arrange(expert_id, wg.shape[0], block_tokens)
    # sort/pad as a gather: padded row pos[i] takes token order[i]; the rows
    # of invalid tokens all land on m_pad - 1, which no valid token uses
    valid_sorted = expert_id[order] >= 0
    src = torch.full((m_pad,), -1, dtype=torch.int64, device=x.device)
    src.index_put_((pos,), torch.where(valid_sorted, order, -1))
    x_pad = token_gather(x.contiguous(), src)
    y_pad = grouped_ffn_blocked(x_pad, blk_expert.to(torch.int32), wg, wu, wd,
                                block_tokens=block_tokens)
    back = torch.empty(n, dtype=torch.int64, device=x.device)
    back[order] = pos
    back = torch.where(expert_id >= 0, back, -1)
    return token_gather(y_pad, back)
