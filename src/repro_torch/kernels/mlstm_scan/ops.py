"""Chunkwise-parallel mLSTM scan: the hand-written kernel and its plain versions.

Counterpart of ``repro/kernels/mlstm_scan``.  :func:`mlstm_scan` launches
the CUDA kernel (``csrc/mlstm_scan.cu``) on CUDA tensors and uses
:func:`mlstm_scan_chunked_ref`, the plain version, only on CPU tensors.
Both compute the exact stabilized chunk recurrence of the reference's
``models/xlstm.py::_mlstm_chunk_body`` and carry the state (C, n, m) in its
convention, so a call can start from a given state and returns the final
one, as ``mlstm_forward_chunked(state=...)`` does.  :func:`mlstm_scan_ref`
is the per-step cell recurrence (the reference's ``ref.py``), the oracle of
both.

The CUDA route has no backward: with grad mode on and an input that needs
a gradient it raises, so a gradient is never silently lost (the plain
version on the CPU differentiates by autograd).

Layout: q, k, v [B, H, S, dh] and ig, lf [B, H, S], all float32 (q and k
pre-scaled as in ``_mlstm_qkvif``; lf is the log-sigmoid forget gate).  A
state is ``{"C": [B, H, dh, dh], "n": [B, H, dh], "m": [B, H]}``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

State = Dict[str, torch.Tensor]

#: the kernel's limits (``csrc/mlstm_scan.cu``): chunk length and head dim
MAX_CHUNK = 64
MAX_HEAD_DIM = 192
_NEG = -1e30              # the padded steps' input gate, as xlstm.py:187
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def init_state(b: int, h: int, dh: int, device) -> State:
    """The zero state with the stabilizer at -30 (``init_mlstm_state``)."""
    return {"C": torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
            "n": torch.zeros((b, h, dh), dtype=torch.float32, device=device),
            "m": torch.full((b, h), -30.0, dtype=torch.float32, device=device)}


def mlstm_scan_ref(q, k, v, ig, lf, state: Optional[State] = None
                   ) -> Tuple[torch.Tensor, State]:
    """Plain per-step cell recurrence (the reference's ``mlstm_scan_ref``)."""
    b, hh, s, dh = q.shape
    st = state if state is not None else init_state(b, hh, dh, q.device)
    C, n, m = st["C"], st["n"], st["m"]
    hs = []
    for t in range(s):
        qt, kt, vt = q[:, :, t].float(), k[:, :, t].float(), v[:, :, t].float()
        it, ft = ig[:, :, t].float(), lf[:, :, t].float()
        m_new = torch.maximum(ft + m, it)
        a = torch.exp(ft + m - m_new)
        bw = torch.exp(it - m_new)
        C = C * a[..., None, None] + bw[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = n * a[..., None] + bw[..., None] * kt
        num = torch.einsum("bhdp,bhd->bhp", C, qt)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qt).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2), {"C": C, "n": n, "m": m}


def _chunk_body(st: State, q, k, v, ig, lf) -> Tuple[State, torch.Tensor]:
    """One chunk of L steps; q, k, v [B, H, L, dh], ig, lf [B, H, L].

    The torch copy of ``_mlstm_chunk_body`` (xlstm.py:125-169), with the
    head axis before the time axis.
    """
    L = q.shape[2]
    C_in, n_in, m_in = st["C"], st["n"], st["m"]
    Lf = torch.cumsum(lf, dim=2)                           # [B,H,L]
    g = ig - Lf
    u = torch.maximum(m_in[..., None], torch.cummax(g, dim=2).values)
    m = Lf + u                                             # global m_t
    # intra-chunk causal weights W[t, j] = e^{g_j - u_t}  (j <= t)
    seg = g[..., None, :] - u[..., :, None]                # [B,H,Lt,Lj]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    W = torch.exp(torch.where(causal, seg, float("-inf")))
    scores = torch.einsum("bhtd,bhjd->bhtj", q, k) * W
    num = torch.einsum("bhtj,bhjd->bhtd", scores, v)
    den = scores.sum(dim=3)                                # [B,H,L]
    # inter-chunk contribution from the carried state
    w_in = torch.exp(m_in[..., None] - u)                  # [B,H,L]
    num = num + w_in[..., None] * torch.einsum("bhdp,bhtd->bhtp", C_in, q)
    den = den + w_in * torch.einsum("bhd,bhtd->bht", n_in, q)
    h = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    # carry out, stabilized at m_L = Lf_L + u_L (the cell's convention)
    u_L = u[..., -1]                                       # [B,H]
    wj = torch.exp(g - u_L[..., None])                     # [B,H,L]
    decay = torch.exp(m_in - u_L)
    C_out = decay[..., None, None] * C_in + torch.einsum("bhj,bhjd,bhjp->bhdp", wj, k, v)
    n_out = decay[..., None] * n_in + torch.einsum("bhj,bhjd->bhd", wj, k)
    return {"C": C_out, "n": n_out, "m": Lf[..., -1] + u_L}, h


def _pad(q, k, v, ig, lf, chunk: int):
    """Pad S to a multiple of L = min(chunk, S) as xlstm.py:179-188 does."""
    s = q.shape[2]
    L = min(chunk, s)
    pad = -(-s // L) * L - s
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        ig = F.pad(ig, (0, pad), value=_NEG)
        lf = F.pad(lf, (0, pad))
    return q, k, v, ig, lf, L


def mlstm_scan_chunked_ref(q, k, v, ig, lf, *, chunk: int = 64,
                           state: Optional[State] = None
                           ) -> Tuple[torch.Tensor, State]:
    """Plain version: the chunk body looped over chunks -> (h, final state)."""
    b, hh, s, dh = q.shape
    st = state if state is not None else init_state(b, hh, dh, q.device)
    q, k, v, ig, lf, L = _pad(q, k, v, ig, lf, chunk)
    hs = []
    for c0 in range(0, q.shape[2], L):
        sl = slice(c0, c0 + L)
        st, h = _chunk_body(st, q[:, :, sl], k[:, :, sl], v[:, :, sl], ig[:, :, sl],
                            lf[:, :, sl])
        hs.append(h)
    return torch.cat(hs, dim=2)[:, :, :s], st


def mlstm_scan(q, k, v, ig, lf, *, chunk: int = 64, state: Optional[State] = None
               ) -> Tuple[torch.Tensor, State]:
    """-> (h [B, H, S, dh] float32, final state); ``state=None`` starts at zero."""
    if q.device.type == "cpu":
        return mlstm_scan_chunked_ref(q, k, v, ig, lf, chunk=chunk, state=state)
    dev = q.device
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (q, k, v, ig, lf, *(state or {}).values())):
        raise RuntimeError("mlstm_scan: the CUDA kernel has no backward yet; an input "
                           "needs a gradient (run under torch.no_grad(), or on the CPU "
                           "through the plain version)")
    if dev.type != "cuda" or any(a.device != dev for a in (k, v, ig, lf)):
        raise ValueError("mlstm_scan: q, k, v, ig, lf must be on one CUDA device")
    if any(a.dtype != torch.float32 for a in (q, k, v, ig, lf)):
        raise TypeError("mlstm_scan: q, k, v, ig, lf must be float32")
    b, hh, s, dh = q.shape
    if (tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape)
            or tuple(ig.shape) != (b, hh, s) or tuple(lf.shape) != (b, hh, s)):
        raise ValueError(f"mlstm_scan: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, ig {tuple(ig.shape)}, lf {tuple(lf.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or not 1 <= dh <= MAX_HEAD_DIM or s == 0:
        raise ValueError(f"mlstm_scan: chunk {chunk} (1..{MAX_CHUNK}), head dim {dh} "
                         f"(1..{MAX_HEAD_DIM}) and S {s} (>= 1) out of the kernel's range")
    if state is not None:
        want = {"C": (b, hh, dh, dh), "n": (b, hh, dh), "m": (b, hh)}
        for key, shape in want.items():
            a = state[key]
            if tuple(a.shape) != shape or a.dtype != torch.float32 or a.device != dev:
                raise ValueError(f"mlstm_scan: state[{key!r}] {tuple(a.shape)} "
                                 f"{a.dtype} on {a.device}, want {shape} float32")
    q, k, v, ig, lf, L = _pad(q, k, v, ig, lf, chunk)
    q, k, v, ig, lf = (a.contiguous() for a in (q, k, v, ig, lf))
    h = torch.empty_like(q)
    # scratch: each chunk's state update, replaced in place by its C_in and
    # n_in, then (Lf_L, G) and m_in of each chunk
    nc = q.shape[2] // L
    work = torch.empty(b * hh * nc * (dh * dh + dh + 3), dtype=torch.float32, device=dev)
    out = {"C": torch.empty((b, hh, dh, dh), dtype=torch.float32, device=dev),
           "n": torch.empty((b, hh, dh), dtype=torch.float32, device=dev),
           "m": torch.empty((b, hh), dtype=torch.float32, device=dev)}
    st_in = ([state[key].contiguous() for key in ("C", "n", "m")]
             if state is not None else [])
    ptrs = [a.data_ptr() for a in st_in] or [None, None, None]   # NULL: the zero state
    fn = _build.function("mlstm_scan", "mlstm_scan", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(), lf.data_ptr(),
             *ptrs, h.data_ptr(), out["C"].data_ptr(), out["n"].data_ptr(),
             out["m"].data_ptr(), work.data_ptr(), b, hh, q.shape[2], dh, L,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mlstm_scan")
    _build.LAUNCHES["mlstm_scan"] += 1
    return h[:, :, :s], out
