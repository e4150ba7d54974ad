"""Grouped (per-expert) SwiGLU FFN: ragged tokens -> sort/pad -> blocked kernel.

Counterpart of ``repro/kernels/grouped_ffn``.  :func:`grouped_ffn` takes
tokens in any order with ``expert_id[i] in [0, E)`` or ``-1`` for padding,
and

  1. sorts them by expert (stable) and pads each expert's segment to a
     multiple of ``block_tokens`` (``_arrange``, as ``ops.py:32-52`` of the
     reference), moving the rows with :func:`token_gather`;
  2. runs :func:`grouped_ffn_blocked` with per-block expert ids and per-block
     token counts (``_block_rows``), so blocks of padding are skipped;
  3. gathers the results back into the original order.

Its gradient (:func:`grouped_ffn_bwd`, through an ``autograd.Function``)
is the VJP of the reference's ``grouped_ffn_ref``, as the reference's
``_grouped_ffn`` custom VJP takes it (``ops.py:163-195``), in plain torch.

:func:`grouped_ffn_blocked` launches the hand-written CUDA kernels
(``csrc/grouped_ffn.cu``) on CUDA tensors, by dtype: bfloat16 on tensor cores
(wgmma fed by TMA, a bf16 ``[M, F]`` scratch between the passes), float32 on
CUDA cores (an f32 scratch).  It uses :func:`grouped_ffn_blocked_ref`, the
plain version, only on CPU tensors.

:func:`grouped_ffn` takes the reference's rule (``ops.py:133-160``) with
the card in the TPU's place: on the card the blocked kernel, which drops
nothing; on the CPU, above ``4 * block_tokens`` rows, the reference's
non-TPU branches in plain torch, differentiated by autograd:
:func:`grouped_ffn_dense` (one buffer of ``[E, cap, D]`` rows, rows past
the capacity dropped) when ``N >= 2 E block_tokens`` and
``NIMBLE_FFN_IMPL`` is not ``"scan"``, else :func:`grouped_ffn_scan`.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F_
from torch.autograd.function import once_differentiable

from .. import _build
from ..token_scatter.ops import token_gather

#: C entry point, argument types and launch-count name of each dtype's route
_ROUTES = {
    torch.bfloat16: ("grouped_ffn_blocked_tc",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                     "grouped_ffn_blocked"),
    torch.float32: ("grouped_ffn_blocked",
                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                    "grouped_ffn_blocked_f32"),
}
#: the CUDA kernels' tile: rows per tile, and the widths D and F must divide by
_TILE_ROWS, _TILE_D, _TILE_F = 64, 128, 64
#: the tensor-core route's most 64-row tiles a call (its pair list in shared memory)
_MAX_TILES = 4096


def ffn_cost(valid: int, used: int, d: int, f: int, itemsize: int):
    """(flops, bytes) of one :func:`grouped_ffn_blocked` launch
    (``chip_smoke.py``'s bound): 6 D F flops a token row, the token rows
    read and written and each used expert's three matrices read once."""
    return 6.0 * valid * d * f, (2 * valid * d + 3 * used * d * f) * itemsize


def _ffn_launch_cost(x, block_expert, block_rows, f: int):
    if block_rows is None:
        valid, used = x.shape[0], torch.unique(block_expert).numel()
    else:
        valid = int(block_rows.sum())
        used = torch.unique(block_expert[block_rows > 0]).numel()
    return (*ffn_cost(valid, used, x.shape[1], f, x.element_size()), x.dtype)


def _bincount(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(keys, minlength=n)`` for int64 keys in [0, n): the
    same integers, by an ``index_add_`` of ones, in a shape that does not
    depend on the data (fake tensors have no ``bincount``)."""
    return torch.zeros(n, dtype=torch.int64, device=keys.device).index_add_(
        0, keys, torch.ones_like(keys))


def _arrange(expert_id: torch.Tensor, n_experts: int, block: int):
    """Padded positions and per-block experts for ragged grouping."""
    dev = expert_id.device
    n = expert_id.shape[0]
    m_pad = (-(-n // block) + n_experts) * block  # block-aligned worst case
    key = torch.where(expert_id < 0, n_experts, expert_id).long()
    order = torch.argsort(key, stable=True)                     # sorted rows
    counts = _bincount(key.clamp(0, n_experts), n_experts + 1)
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


def _block_rows(expert_id: torch.Tensor, n_experts: int, block: int) -> torch.Tensor:
    """int32 [m_pad // block]: token rows in each block of ``_arrange``'s layout.

    An expert's segment of ``count`` rows starts at its aligned offset, so its
    blocks hold ``block`` rows each but the last, which holds the rest; blocks
    past the last segment hold 0.  Torch ops only: no read on the host.
    """
    n = expert_id.shape[0]
    m_pad = (-(-n // block) + n_experts) * block
    key = torch.where(expert_id < 0, n_experts, expert_id).long()
    counts = _bincount(key.clamp(0, n_experts), n_experts + 1)[:-1]
    aligned = (counts + block - 1) // block * block
    aligned_off = torch.cumsum(aligned, 0) - aligned
    blk_start = torch.arange(m_pad // block, device=expert_id.device) * block
    e = ((aligned_off[None, :] <= blk_start[:, None]).sum(1) - 1).clamp(0, n_experts - 1)
    rows = counts[e] - (blk_start - aligned_off[e])
    return rows.clamp(0, block).to(torch.int32)


def _tile_pairs(block_expert: torch.Tensor, block_rows, block_tokens: int,
                m: int) -> torch.Tensor:
    """int32 [m // 64]: the pairs of 64-row tiles the tensor-core route computes.

    Plain version of the pairing that the kernel's blocks do for themselves.
    Entry c is ``2 t + two`` for the c-th pair, then -1: tile t, and tile
    t + 1 too when ``two``.  Tiles that hold a token (all of them without
    ``block_rows``) are paired along each run of adjacent tiles of one
    expert, from the run's first tile, so the two tiles of a pair share
    their weights.  Torch ops only: no read on the host.
    """
    dev = block_expert.device
    per = block_tokens // _TILE_ROWS
    n = m // _TILE_ROWS
    t = torch.arange(n, device=dev)
    tile_e = block_expert.long().repeat_interleave(per)
    if block_rows is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        rows = block_rows.long().repeat_interleave(per) - (t % per) * _TILE_ROWS
        live = rows > 0
    # tile t continues the run of tile t - 1: both hold tokens, same expert
    cont = torch.zeros(n, dtype=torch.bool, device=dev)
    cont[1:] = live[1:] & live[:-1] & (tile_e[1:] == tile_e[:-1])
    first = torch.cummax(torch.where(live & ~cont, t, -1), 0).values  # run's first tile
    start = live & ((t - first) % 2 == 0)
    two = torch.zeros(n, dtype=torch.bool, device=dev)
    two[:-1] = start[:-1] & cont[1:]
    order = torch.argsort((~start).to(torch.int8), stable=True)   # pair starts first
    code = (2 * t + two)[order]
    return torch.where(t < start.sum(), code, -1).to(torch.int32)


def grouped_ffn_blocked_ref(x, block_expert, wg, wu, wd, *, block_tokens: int,
                            block_rows=None):
    """Plain version of the blocked kernel, in float32.

    Row r uses expert ``block_expert[r // block_tokens]``; the per-expert
    form of ``ref.py``: each expert's rows go through three float32
    products with that expert's weights.  With ``block_rows``, rows at or
    past their block's count are 0.
    """
    row_expert = block_expert.long().repeat_interleave(block_tokens)
    if block_rows is not None:
        in_block = torch.arange(x.shape[0], device=x.device) % block_tokens
        live = in_block < block_rows.long().repeat_interleave(block_tokens)
        row_expert = torch.where(live, row_expert, -1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(wg.shape[0]):
        rows = torch.nonzero(row_expert == e).squeeze(1)
        if rows.numel() == 0:
            continue
        xe = x[rows].float()
        h = F_.silu(xe @ wg[e].float()) * (xe @ wu[e].float())
        out[rows] = h @ wd[e].float()
    return out.to(x.dtype)


def grouped_ffn_blocked(x, block_expert, wg, wu, wd, *, block_tokens: int,
                        block_rows=None):
    """x [M, D] sorted+padded, block_expert [M // block_tokens] -> [M, D].

    ``block_rows`` (int32 [M // block_tokens], optional): the token rows at
    the head of each block; rows at or past it come out 0 and 64-row tiles
    that hold none are not computed.  Without it every row is computed.
    """
    if x.device.type == "cpu":
        return grouped_ffn_blocked_ref(x, block_expert, wg, wu, wd,
                                       block_tokens=block_tokens, block_rows=block_rows)
    m, d = x.shape
    e, _, f = wg.shape
    per_block = (block_expert,) if block_rows is None else (block_expert, block_rows)
    if x.device.type != "cuda" or any(
        t.device != x.device for t in (*per_block, wg, wu, wd)
    ):
        raise ValueError("grouped_ffn_blocked: all tensors must be on one CUDA device")
    if x.dtype not in _ROUTES or any(t.dtype != x.dtype for t in (wg, wu, wd)):
        raise TypeError(f"grouped_ffn_blocked: dtypes {x.dtype}, {wg.dtype}, "
                        f"{wu.dtype}, {wd.dtype}")
    if any(t.dtype != torch.int32 for t in per_block):
        raise TypeError("grouped_ffn_blocked: block_expert and block_rows must be int32")
    if (tuple(wu.shape) != (e, d, f) or tuple(wd.shape) != (e, f, d)
            or any(tuple(t.shape) != (m // block_tokens,) for t in per_block)):
        raise ValueError(
            f"grouped_ffn_blocked: shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
            f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}, "
            f"block_expert {tuple(block_expert.shape)}"
            + ("" if block_rows is None else f", block_rows {tuple(block_rows.shape)}"))
    if (m % block_tokens or block_tokens % _TILE_ROWS or d % _TILE_D
            or f % _TILE_F):
        raise ValueError(
            f"grouped_ffn_blocked: needs M % block_tokens == 0, block_tokens % "
            f"{_TILE_ROWS} == 0, D % {_TILE_D} == 0, F % {_TILE_F} == 0; got "
            f"M={m}, block_tokens={block_tokens}, D={d}, F={f}")
    if x.dtype == torch.bfloat16 and m // _TILE_ROWS > _MAX_TILES:
        raise ValueError(f"grouped_ffn_blocked: M={m} is more than {_MAX_TILES} tiles of "
                         f"{_TILE_ROWS} rows")
    if not all(t.is_contiguous() for t in (x, *per_block, wg, wu, wd)):
        raise ValueError("grouped_ffn_blocked: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, wg, wu, wd)):
        raise ValueError("grouped_ffn_blocked: x and the weights must be 16-byte aligned")
    y = torch.empty_like(x)
    if m == 0:
        return y
    # pass-1 scratch H [M, F] in the route's dtype; only computed tiles' rows
    # are written, and only those are read
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    entry, argtypes, count = _ROUTES[x.dtype]
    fn = _build.function("grouped_ffn", entry, argtypes)
    sizes = (m, d, f, e) if x.dtype == torch.bfloat16 else (m, d, f)
    err = fn(x.data_ptr(), block_expert.data_ptr(),
             None if block_rows is None else block_rows.data_ptr(), wg.data_ptr(),
             wu.data_ptr(), wd.data_ptr(), h.data_ptr(), y.data_ptr(), *sizes,
             block_tokens, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, entry)
    _build.LAUNCHES[count] += 1
    _build.report(count, lambda: _ffn_launch_cost(x, block_expert, block_rows, f))
    return y


def _layout(expert_id: torch.Tensor, n_experts: int, block: int):
    """``_arrange``'s sort/pad as two gather indices, and its block experts.

    ``src`` [m_pad] fills the padded layout: padded row pos[i] takes token
    order[i], and the rows of invalid tokens all land on m_pad - 1, which no
    valid token uses.  ``back`` [n] reads each token's row back out (-1 for
    an invalid token).
    """
    order, pos, blk_expert, m_pad = _arrange(expert_id, n_experts, block)
    dev = expert_id.device
    src = torch.full((m_pad,), -1, dtype=torch.int64, device=dev)
    src.index_put_((pos,), torch.where(expert_id[order] >= 0, order, -1))
    back = torch.empty(expert_id.shape[0], dtype=torch.int64, device=dev)
    back[order] = pos
    return src, torch.where(expert_id >= 0, back, -1), blk_expert


def _grouped_ffn_forward(x, expert_id, wg, wu, wd, block_tokens: int):
    """sort/pad gather, blocked kernel, unsort gather; no graph."""
    src, back, blk_expert = _layout(expert_id, wg.shape[0], block_tokens)
    x_pad = token_gather(x.contiguous(), src)
    y_pad = grouped_ffn_blocked(x_pad, blk_expert.to(torch.int32), wg, wu, wd,
                                block_tokens=block_tokens,
                                block_rows=_block_rows(expert_id, wg.shape[0], block_tokens))
    return token_gather(y_pad, back)


#: the backward pads each expert's rows to a multiple of this, so its
#: products take few distinct shapes: the experts' row counts change every
#: step, and cuBLAS picks an algorithm on the host for each new shape while
#: the card waits
_BWD_ROWS = 256


def _mm_f32(a, b):
    """``a @ b`` as float32: the exact products of the operands summed in float32.

    bf16 operands on the card take one cuBLAS product with a float32 output
    (``torch.mm(..., out_dtype=torch.float32)``); the CPU has no kernel for
    that, so there the operands are upcast first.
    """
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _hi_lo(t, dt):
    """A float32 [r, F] as an operand of dtype ``dt``: ``t`` itself for
    float32, else [2r, F]: ``t`` rounded to ``dt`` over the rest rounded to
    ``dt``.  A product over the rows then sums both halves (against the
    other operand's rows stacked twice) and carries ``t`` to about 2^-17 of
    its value, in one product with twice the depth."""
    if dt == torch.float32:
        return t
    hi = t.to(dt)
    return torch.cat((hi, (t - hi.float()).to(dt)))


def grouped_ffn_bwd(g, x, expert_id, wg, wu, wd):
    """The VJP of ``grouped_ffn_ref``: (gx, gwg, gwu, gwd) for the output's gradient g.

    Expert by expert over that expert's rows, in ``_arrange``'s order (a
    stable sort by expert, each expert's rows padded with zero rows to a
    multiple of ``_BWD_ROWS``, gathered with ``token_gather``): it
    recomputes ``a = x wg``, ``b = x wu`` and ``h = silu(a) b``, then

        gwd = h^T g,  dh = g wd^T,  da = dh b silu'(a),  db = dh silu(a),
        gx = da wg^T + db wu^T,  gwg = x^T da,  gwu = x^T db.

    Zero rows add nothing to the weights' gradients.  The reference's VJP
    of ``grouped_ffn_ref`` computes in float32 and rounds only its outputs;
    here products take operands in the weights' dtype and sum in float32.
    ``a``, ``b``, ``dh`` and gx's two terms come out in float32
    (:func:`_mm_f32`), and the SwiGLU derivative is float32.  ``h``,
    ``da`` and ``db`` must enter the next products as operands in the
    weights' dtype: with bf16 weights that is the one rounding a bf16
    tensor-core product needs.  For the weights' gradients, sums over
    every row of an expert, that rounding alone would double the error
    (each operand's rounding adds about as much as the output's), so
    ``h``, ``da`` and ``db`` enter them as their bf16 value plus their
    bf16 residual (:func:`_hi_lo`), in one product of twice the depth;
    gx's terms, sums over F, take the bf16 value alone.  Rows with
    ``expert_id < 0`` get zero gradient.  One read of the experts' row
    counts on the host slices the rows.
    """
    n_exp = wg.shape[0]
    dt = wg.dtype
    key = torch.where(expert_id < 0, n_exp, expert_id).long()
    counts = torch.bincount(key, minlength=n_exp + 1)[:n_exp].tolist()
    rows = [-(-c // _BWD_ROWS) * _BWD_ROWS for c in counts]
    m_used = sum(rows)
    gwg, gwu, gwd = (torch.zeros_like(w) for w in (wg, wu, wd))
    if m_used == 0:
        return torch.zeros_like(x), gwg, gwu, gwd
    src, back, _ = _layout(expert_id, n_exp, _BWD_ROWS)
    src = src[:m_used]                  # the segments; invalid tokens' row lies past them
    xs = token_gather(x.contiguous(), src).to(dt)
    gs = token_gather(g.contiguous(), src).to(dt)
    dxs = torch.empty((m_used, x.shape[1]), dtype=torch.float32, device=x.device)
    lo = 0
    for e, r in enumerate(rows):
        if r == 0:
            continue
        xe, ge = xs[lo:lo + r], gs[lo:lo + r]
        a = _mm_f32(xe, wg[e])
        b = _mm_f32(xe, wu[e])
        sa = torch.sigmoid(a)
        silu = a * sa
        xx, gg = (xe, ge) if dt == torch.float32 else (torch.cat((xe, xe)),
                                                        torch.cat((ge, ge)))
        torch.mm(_hi_lo(silu * b, dt).T, gg, out=gwd[e])
        dh = _mm_f32(ge, wd[e].T)
        da = _hi_lo(dh * b * sa * (1 + a * (1 - sa)), dt)
        db = _hi_lo(dh * silu, dt)
        torch.mm(xx.T, da, out=gwg[e])
        torch.mm(xx.T, db, out=gwu[e])
        dxs[lo:lo + r] = _mm_f32(da[:r], wg[e].T) + _mm_f32(db[:r], wu[e].T)
        lo += r
    return token_gather(dxs.to(x.dtype), back), gwg, gwu, gwd


def grouped_ffn_scan(x, expert_id, wg, wu, wd, *, block_tokens: int = 128):
    """The reference's non-TPU scan (``ops.py:55-83``): ``_arrange``'s blocks in float32.

    Every block of the sorted, padded rows goes through its expert's
    weights (``block_expert``) in three float32 products, batched over the
    blocks; the output is in ``x``'s dtype.  Drops nothing.
    """
    d = x.shape[1]
    src, back, blk_expert = _layout(expert_id, wg.shape[0], block_tokens)
    x_pad = torch.where(src[:, None] >= 0, x[src.clamp(min=0)], 0)
    xb = x_pad.view(-1, block_tokens, d).float()
    h = F_.silu(torch.bmm(xb, wg[blk_expert].float())) * torch.bmm(xb, wu[blk_expert].float())
    y_pad = torch.bmm(h, wd[blk_expert].float()).to(x.dtype).view(-1, d)
    return torch.where(back[:, None] >= 0, y_pad[back.clamp(min=0)], 0)


def grouped_ffn_dense(x, expert_id, wg, wu, wd, *, cap_factor: float = 2.0,
                      block_tokens: int = 64):
    """The reference's static-capacity segment products (``ops.py:86-130``).

    Rows go into an ``[E, cap, D]`` buffer, each expert's rows in their
    order, and each expert's weights are read once.  ``cap`` is the
    reference's, from Python float arithmetic; rows past it are dropped and
    give 0, as rows with ``expert_id < 0`` do.  The buffer is filled by an
    accumulating scatter in which a dropped row adds exact zeros at slot
    ``cap - 1``, so any order of the sums gives the same bits.
    """
    E = wg.shape[0]
    n, d = x.shape
    cap = max(int(-(-n * cap_factor // (E * block_tokens))), 1) * block_tokens
    key = torch.where(expert_id < 0, E, expert_id).long()
    order = torch.argsort(key, stable=True)
    counts = _bincount(key.clamp(0, E), E + 1)
    seg_off = torch.cumsum(counts[:-1], 0) - counts[:-1]
    rank = torch.empty_like(key)
    rank[order] = torch.arange(n, device=x.device) - seg_off[key[order].clamp(0, E - 1)]
    kept = (rank < cap) & (expert_id >= 0)
    e_c = expert_id.long().clamp(0, E - 1)
    r_c = rank.clamp(max=cap - 1)
    buf = torch.zeros((E, cap, d), dtype=x.dtype, device=x.device).index_put(
        (e_c, r_c), torch.where(kept[:, None], x, 0), accumulate=True)
    bf = buf.float()
    h = F_.silu(torch.einsum("ecd,edf->ecf", bf, wg.float()))
    u = torch.einsum("ecd,edf->ecf", bf, wu.float())
    yb = torch.einsum("ecf,efd->ecd", h * u, wd.float())
    return torch.where(kept[:, None], yb[e_c, r_c].to(x.dtype), 0)


class _GroupedFFN(torch.autograd.Function):
    """The reference's ``_grouped_ffn`` custom VJP: kernel forward, plain backward."""

    @staticmethod
    def forward(ctx, x, expert_id, wg, wu, wd, block_tokens):
        ctx.save_for_backward(x, expert_id, wg, wu, wd)
        return _grouped_ffn_forward(x, expert_id, wg, wu, wd, block_tokens)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gx, gwg, gwu, gwd = grouped_ffn_bwd(g, *ctx.saved_tensors)
        return gx, None, gwg, gwu, gwd, None


def grouped_ffn(x, expert_id, wg, wu, wd, *, block_tokens: int = 128,
                cpu_rule_scale: int = 1):
    """out[i] = SwiGLU_{expert_id[i]}(x[i]); rows with expert_id < 0 -> 0.

    On the card the blocked kernel, differentiable in ``x`` and the weights
    (``grouped_ffn_bwd``) and without a graph when no gradient is to be
    taken.  On the CPU the reference's non-TPU rule: above ``4 *
    block_tokens`` rows :func:`grouped_ffn_dense` (at the reference's
    capacity factor, 2.0) or :func:`grouped_ffn_scan`, else the blocked
    kernel's plain version.  The rule reads ``cpu_rule_scale`` times this
    call's rows and experts: a call over a part of the experts takes the
    branch of the call over all of them (the rows per expert are the same).
    """
    if x.device.type == "cpu" and x.shape[0] * cpu_rule_scale > 4 * block_tokens:
        dense_worthwhile = x.shape[0] >= 2 * wg.shape[0] * block_tokens
        if os.environ.get("NIMBLE_FFN_IMPL", "dense") == "scan" or not dense_worthwhile:
            return grouped_ffn_scan(x, expert_id, wg, wu, wd, block_tokens=block_tokens)
        return grouped_ffn_dense(x, expert_id, wg, wu, wd, block_tokens=block_tokens)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wg, wu, wd)):
        return _GroupedFFN.apply(x, expert_id, wg, wu, wd, block_tokens)
    return _grouped_ffn_forward(x, expert_id, wg, wu, wd, block_tokens)
