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

Under a gradient the CUDA route is an ``autograd.Function``
(:class:`MLSTMScanFunction`): the kernel runs the forward and leaves each
chunk's input state (C_in, n_in, m_in) in its scratch tensor, which the
Function keeps; :func:`mlstm_scan_bwd` is the backward, the VJP of
:func:`_chunk_body` in float32 over every chunk, with the carried state's
cotangent (dC, dn, dm) flowing from each chunk into the one before it.  It
mirrors what the reference differentiates: XLA's autodiff of the
``lax.scan`` over ``_mlstm_chunk_body`` in ``mlstm_forward_chunked``
(``models/xlstm.py:125-205``); the reference has no Pallas backward.  The
plain version on the CPU differentiates by autograd.

Layout: q, k [B, H, S, dk], v [B, H, S, dv] and ig, lf [B, H, S], all
float32 (q and k pre-scaled as in ``_mlstm_qkvif``; lf is the log-sigmoid
forget gate).  A state is ``{"C": [B, H, dk, dv], "n": [B, H, dk], "m": [B,
H]}``.  dv is the head width dk where a process computes whole heads, and
fewer columns of one head where a model group splits the mLSTM by value
columns (``models/xlstm.py``, ``sharding/tp.py::value_columns``): each
value column's recurrence reads all dk key columns and no other value
column, and n and m do not depend on v at all.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import _build

State = Dict[str, torch.Tensor]

#: the kernel's limits (``csrc/mlstm_scan.cu``): chunk length and head dims (dk, dv)
MAX_CHUNK = 64
MAX_HEAD_DIM = 192
_NEG = -1e30              # the padded steps' input gate, as xlstm.py:187
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def init_state(b: int, h: int, dk: int, device, dv: Optional[int] = None,
               dtype=torch.float32) -> State:
    """The zero state with the stabilizer at -30 (``init_mlstm_state``); ``dv``
    value columns a head (default ``dk``); float32 unless ``dtype`` (a
    float64 run's)."""
    dv = dk if dv is None else dv
    return {"C": torch.zeros((b, h, dk, dv), dtype=dtype, device=device),
            "n": torch.zeros((b, h, dk), dtype=dtype, device=device),
            "m": torch.full((b, h), -30.0, dtype=dtype, device=device)}


def mlstm_scan_ref(q, k, v, ig, lf, state: Optional[State] = None
                   ) -> Tuple[torch.Tensor, State]:
    """Plain per-step cell recurrence (the reference's ``mlstm_scan_ref``)."""
    b, hh, s, dh = q.shape
    st = state if state is not None else init_state(b, hh, dh, q.device, v.shape[-1],
                                                    q.dtype)
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


def _cummax_tree(g: torch.Tensor) -> torch.Tensor:
    """Cumulative max along the last dim of g [..., n]: a transcription of
    ``lax.associative_scan``'s odd/even recursion with ``torch.maximum`` as
    the combine, so autograd through it takes JAX's gradient of
    ``lax.cummax`` (``maximum`` halves a tie's cotangent, as ``lax.max``
    does, down the scan's tree)."""
    n = g.shape[-1]
    if n < 2:
        return g
    odd = _cummax_tree(torch.maximum(g[..., 0:n - 1:2], g[..., 1::2]))
    even = torch.maximum(odd if n % 2 else odd[..., :-1], g[..., 2::2])
    even = torch.cat([g[..., :1], even], dim=-1)           # ceil(n/2) entries
    pairs = torch.stack([even[..., :n // 2], odd], dim=-1).flatten(-2)
    return torch.cat([pairs, even[..., n // 2:]], dim=-1)


def cummax_bwd_ref(g: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`cummax_bwd`: autograd through :func:`_cummax_tree`."""
    with torch.enable_grad():
        x = g.detach().requires_grad_(True)
        (dg,) = torch.autograd.grad(_cummax_tree(x), x, dy)
    return dg


def cummax_bwd(g: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The VJP of the cumulative max along the last dim of g [..., n], float32:
    the cotangent dy of the maxima -> g's, as ``jax.grad`` of ``lax.cummax``
    gives it.  On CUDA tensors one launch of ``mlstm_cummax_bwd``
    (``csrc/mlstm_scan.cu``, n <= 64), equal to the plain version bit for bit;
    on CPU tensors :func:`cummax_bwd_ref`."""
    if g.device.type == "cpu":
        return cummax_bwd_ref(g, dy)
    n = g.shape[-1]
    if g.dtype != torch.float32 or dy.dtype != torch.float32 or dy.device != g.device:
        raise TypeError("cummax_bwd: g and dy must be float32 on one device")
    if tuple(dy.shape) != tuple(g.shape) or not 1 <= n <= MAX_CHUNK:
        raise ValueError(f"cummax_bwd: g {tuple(g.shape)}, dy {tuple(dy.shape)}; "
                         f"n (1..{MAX_CHUNK})")
    g, dy = g.detach().contiguous(), dy.contiguous()
    dg = torch.empty_like(g)
    fn = _build.function("mlstm_scan", "mlstm_cummax_bwd",
                         [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_void_p])
    err = fn(g.data_ptr(), dy.data_ptr(), dg.data_ptr(), g.numel() // n, n,
             torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "mlstm_cummax_bwd")
    _build.LAUNCHES["mlstm_cummax_bwd"] += 1
    _build.report("mlstm_cummax_bwd", lambda: (*cummax_bwd_cost(g.numel()), g.dtype))
    return dg


class _CumMax(torch.autograd.Function):
    """``torch.cummax``'s values, :func:`cummax_bwd` backward."""

    @staticmethod
    def forward(ctx, g):
        ctx.save_for_backward(g)
        return torch.cummax(g, dim=-1).values

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (g,) = ctx.saved_tensors
        return cummax_bwd(g, dy)


def _cummax(g: torch.Tensor) -> torch.Tensor:
    """Cumulative max along the last dim of g [B, H, L], with JAX's gradient.

    JAX differentiates ``lax.cummax`` through ``lax.associative_scan`` with
    ``lax.max``, so a tie's gradient is split in halves down the scan's tree
    (``torch.cummax``'s backward sends it all to the latest maximum, through
    a scatter-add).  The backward is :func:`cummax_bwd`: one launch on the
    card, no atomics, so the card's gradient is the same from run to run.
    """
    return _CumMax.apply(g)


def _chunk_body(st: State, q, k, v, ig, lf) -> Tuple[State, torch.Tensor]:
    """One chunk of L steps; q, k [B, H, L, dk], v [B, H, L, dv], ig, lf [B, H, L].

    The torch copy of ``_mlstm_chunk_body`` (xlstm.py:125-169), with the
    head axis before the time axis.
    """
    L = q.shape[2]
    C_in, n_in, m_in = st["C"], st["n"], st["m"]
    Lf = torch.cumsum(lf, dim=2)                           # [B,H,L]
    g = ig - Lf
    u = torch.maximum(m_in[..., None], _cummax(g))
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


def mlstm_cost(b: int, h: int, s: int, dh: int, chunk: int, dv: Optional[int] = None):
    """(flops, bytes) of one :func:`mlstm_scan` call's launches (``chip_smoke.py``'s
    bound) at key width ``dh`` and value width ``dv`` (default ``dh``): q k^T
    (depth dk) and S v (width dv) over the causal half of each L x L chunk,
    q C and the k^T v state update at L x dk x dv; q, k, v, ig, lf read, h
    and the final (C, n, m) written once, float32."""
    dv = dh if dv is None else dv
    L = min(chunk, s)
    nc = -(-s // L)
    flops = 2.0 * b * h * nc * ((L * (L + 1) // 2) * (dh + dv) + 2 * L * dh * dv)
    return flops, 4 * (b * h * s * (2 * dh + 2 * dv) + 2 * b * h * s
                       + b * h * (dh * dv + dh + 1))


def cummax_bwd_cost(numel: int):
    """(flops, bytes) of one :func:`cummax_bwd` launch (``chip_smoke.py``'s
    bound): each step's compares, products and sums, 8 a value; g and dy
    read, dg written, float32."""
    return 8.0 * numel, 3 * 4 * numel


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


def _chunk_loop(q, k, v, ig, lf, L: int, st: State, keep: bool):
    """The chunk body over padded inputs -> (h, final state, each chunk's
    input state stacked on a chunk axis when ``keep``, else None)."""
    hs, ins = [], []
    for c0 in range(0, q.shape[2], L):
        sl = slice(c0, c0 + L)
        if keep:
            ins.append(st)
        st, h = _chunk_body(st, q[:, :, sl], k[:, :, sl], v[:, :, sl], ig[:, :, sl],
                            lf[:, :, sl])
        hs.append(h)
    chunk_in = (tuple(torch.stack([a[key] for a in ins], dim=2) for key in ("C", "n", "m"))
                if keep else None)
    return torch.cat(hs, dim=2), st, chunk_in


def mlstm_scan_chunked_ref(q, k, v, ig, lf, *, chunk: int = 64,
                           state: Optional[State] = None
                           ) -> Tuple[torch.Tensor, State]:
    """Plain version: the chunk body looped over chunks -> (h, final state)."""
    b, hh, s, dh = q.shape
    st = state if state is not None else init_state(b, hh, dh, q.device, v.shape[-1],
                                                    q.dtype)
    q, k, v, ig, lf, L = _pad(q, k, v, ig, lf, chunk)
    h, st, _ = _chunk_loop(q, k, v, ig, lf, L, st, keep=False)
    return h[:, :, :s], st


def _launch(q, k, v, ig, lf, chunk: int, state: Optional[State]):
    """The kernel on CUDA tensors -> (h, final state, each chunk's input state).

    The chunk states are views into the kernel's scratch tensor:
    C_in [B, H, chunks, dk, dv], n_in [B, H, chunks, dk], m_in [B, H, chunks].
    """
    dev = q.device
    if dev.type != "cuda" or any(a.device != dev for a in (k, v, ig, lf)):
        raise ValueError("mlstm_scan: q, k, v, ig, lf must be on one CUDA device")
    if any(a.dtype != torch.float32 for a in (q, k, v, ig, lf)):
        raise TypeError("mlstm_scan: q, k, v, ig, lf must be float32")
    b, hh, s, dh = q.shape
    dv = v.shape[-1] if v.dim() == 4 else 0
    cost = mlstm_cost(b, hh, s, dh, chunk, dv)
    if (tuple(k.shape) != tuple(q.shape) or tuple(v.shape[:3]) != (b, hh, s) or v.dim() != 4
            or tuple(ig.shape) != (b, hh, s) or tuple(lf.shape) != (b, hh, s)):
        raise ValueError(f"mlstm_scan: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, ig {tuple(ig.shape)}, lf {tuple(lf.shape)}")
    if (not 1 <= chunk <= MAX_CHUNK or not 1 <= dh <= MAX_HEAD_DIM
            or not 1 <= dv <= MAX_HEAD_DIM or s == 0):
        raise ValueError(f"mlstm_scan: chunk {chunk} (1..{MAX_CHUNK}), head dims dk {dh} "
                         f"and dv {dv} (1..{MAX_HEAD_DIM}) and S {s} (>= 1) out of the "
                         f"kernel's range")
    if state is not None:
        want = {"C": (b, hh, dh, dv), "n": (b, hh, dh), "m": (b, hh)}
        for key, shape in want.items():
            a = state[key]
            if tuple(a.shape) != shape or a.dtype != torch.float32 or a.device != dev:
                raise ValueError(f"mlstm_scan: state[{key!r}] {tuple(a.shape)} "
                                 f"{a.dtype} on {a.device}, want {shape} float32")
    q, k, v, ig, lf, L = _pad(q, k, v, ig, lf, chunk)
    q, k, v, ig, lf = (a.detach().contiguous() for a in (q, k, v, ig, lf))
    h = torch.empty_like(v)
    # scratch: each chunk's state update, replaced in place by its C_in and
    # n_in, then (Lf_L, G) and m_in of each chunk
    nc = q.shape[2] // L
    E = dh * dv + dh
    base = b * hh * nc * E
    base += base & 1                      # the chunks' (Lf_L, G) pairs: float2-aligned
    work = torch.empty(base + 3 * b * hh * nc, dtype=torch.float32, device=dev)
    out = {"C": torch.empty((b, hh, dh, dv), dtype=torch.float32, device=dev),
           "n": torch.empty((b, hh, dh), dtype=torch.float32, device=dev),
           "m": torch.empty((b, hh), dtype=torch.float32, device=dev)}
    st_in = ([state[key].detach().contiguous() for key in ("C", "n", "m")]
             if state is not None else [])
    ptrs = [a.data_ptr() for a in st_in] or [None, None, None]   # NULL: the zero state
    fn = _build.function("mlstm_scan", "mlstm_scan", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(), lf.data_ptr(),
             *ptrs, h.data_ptr(), out["C"].data_ptr(), out["n"].data_ptr(),
             out["m"].data_ptr(), work.data_ptr(), b, hh, q.shape[2], dh, dv, L,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mlstm_scan")
    _build.LAUNCHES["mlstm_scan"] += 1
    _build.report("mlstm_scan", lambda: (*cost, torch.float32))
    cn = work[:b * hh * nc * E].view(b, hh, nc, E)
    chunk_in = (cn[..., :dh * dv].view(b, hh, nc, dh, dv), cn[..., dh * dv:],
                work[base + 2 * b * hh * nc:].view(b, hh, nc))
    return h[:, :, :s], out, chunk_in


def _reverse_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y_c = a_c y_{c+1} + u_c along dim 2 (0 after the last), by log-depth
    doubling on the flipped sequence; ``a`` broadcasts against ``u``."""
    a, u = torch.flip(a, [2]), torch.flip(u, [2])
    shift, n = 1, u.shape[2]
    while shift < n:
        u = torch.cat([u[:, :, :shift], u[:, :, shift:] + a[:, :, shift:] * u[:, :, :-shift]],
                      dim=2)
        a = torch.cat([a[:, :, :shift], a[:, :, shift:] * a[:, :, :-shift]], dim=2)
        shift *= 2
    return torch.flip(u, [2])


def mlstm_scan_bwd(q, k, v, ig, lf, chunk_in, final, dh_out, dstate: State, *,
                   chunk: int = 64):
    """The VJP of the chunked scan, given each chunk's input and the final state.

    q, k, v, ig, lf are the forward's (unpadded) inputs, ``chunk_in`` the
    (C_in, n_in, m_in) of every chunk on a chunk axis (the kernel's scratch,
    or the plain loop's), ``final`` the forward's final (C, n), ``dh_out``
    the cotangent of h and ``dstate`` that of the final state.  -> ((dq, dk,
    dv, dig, dlf), the cotangent of the initial state), float32 throughout.
    The value width dv may differ from the key width dk (C [dk, dv]).

    Chunk c's body maps (its inputs x_c, its input state s_c) to (h_c, its
    output state s'_c), and s'_c is s_{c+1}: the cotangent of s_c is the VJP
    of h_c alone plus A_c^T ds'_c, A_c the state map's Jacobian in s_c, and
    ds'_c is the cotangent of s_{c+1}.  Every chunk's body is recomputed
    from its own input state at once (the chunks stacked on the head axis)
    and differentiated by autograd twice, for h and then, once the chain
    has given every ds'_c, for the output states.  The carry (dC, dn, dm)
    runs from each chunk into the one before it through A_c^T, which is
    linear and in closed form, so the whole chain is three reverse linear
    scans over the chunks:

      dC_in = decay dC',  dn_in = decay dn',
      dm_in = decay (<dC', C_in> + <dn', n_in>)
              + sel (dm' - <dC', C'> - <dn', n'>),

    with decay = e^{m_in - u_L}, u_L = max(m_in, G), G the chunk's largest
    i_j - Lf_j, and sel the max's gradient in m_in (1, 1/2 at a tie, 0) as
    torch takes it.
    """
    s = q.shape[2]
    q, k, v, ig, lf, L = _pad(*(a.detach().float() for a in (q, k, v, ig, lf)), chunk)
    b, hh, sp, _ = q.shape
    nc = sp // L
    C_in, n_in, m_in = (a.detach() for a in chunk_in)

    def steps(a):
        """[B, H, S', ...] -> [B, H * nc, L, ...]: each chunk a head of its own"""
        return a.reshape(b, hh * nc, L, *a.shape[3:])

    def states(a):
        """[B, H, nc, ...] -> [B, H * nc, ...]"""
        return a.reshape(b, hh * nc, *a.shape[3:])

    dh_c = steps(F.pad(dh_out.float(), (0, 0, 0, sp - s)))
    with torch.enable_grad():
        xs = [steps(a).requires_grad_(True) for a in (q, k, v, ig, lf)]
        st = {key: states(a).requires_grad_(True)
              for key, a in zip(("C", "n", "m"), (C_in, n_in, m_in))}
        st_out, h = _chunk_body(st, *xs)
        g_h = torch.autograd.grad(h, (*xs, st["C"], st["n"], st["m"]), dh_c,
                                  retain_graph=True)
    hC, hn, hm = (g.view(b, hh, nc, *g.shape[2:]) for g in g_h[5:])
    # the carry, last chunk first: linear recurrences in (dC, dn) and then
    # in dm, each one reverse scan over the chunks
    igc, lfc = ig.view(b, hh, nc, L), lf.view(b, hh, nc, L)
    G = (igc - torch.cumsum(lfc, dim=3)).amax(dim=3)
    u_L = torch.maximum(m_in, G)
    decay = torch.exp(m_in - u_L)
    sel = (m_in > G).float() + 0.5 * (m_in == G).float()
    C_next = torch.cat([C_in[:, :, 1:], final[0].float()[:, :, None]], dim=2)
    n_next = torch.cat([n_in[:, :, 1:], final[1].float()[:, :, None]], dim=2)
    dC_f, dn_f, dm_f = (dstate[key].float() for key in ("C", "n", "m"))

    def carry(a, h_part, last):
        """(the input state's cotangent of every chunk, its output state's):
        d_in_c = a_c d_out_c + h_part_c with d_out_c = d_in_{c+1}, last after
        the last chunk"""
        a = a.view(*a.shape, *([1] * (h_part.dim() - a.dim())))
        u = h_part.clone()
        u[:, :, -1] += a[:, :, -1] * last
        d_in = _reverse_scan(a, u)
        return d_in, torch.cat([d_in[:, :, 1:], last[:, :, None]], dim=2)

    (dC, dC_out), (dn, dn_out) = carry(decay, hC, dC_f), carry(decay, hn, dn_f)
    into = (dC_out * C_in).sum((3, 4)) + (dn_out * n_in).sum(3)
    outof = (dC_out * C_next).sum((3, 4)) + (dn_out * n_next).sum(3)
    dm, dm_out = carry(sel, decay * into - sel * outof + hm, dm_f)
    d_out = (dC_out, dn_out, dm_out)
    with torch.enable_grad():
        g_s = torch.autograd.grad((st_out["C"], st_out["n"], st_out["m"]), xs,
                                  [states(d) for d in d_out], allow_unused=True)
    grads = tuple((a if b_ is None else a + b_).reshape(b, hh, sp, *a.shape[3:])[:, :, :s]
                  for a, b_ in zip(g_h[:5], g_s))              # q reaches no state
    return grads, {"C": dC[:, :, 0], "n": dn[:, :, 0], "m": dm[:, :, 0]}


class MLSTMScanFunction(torch.autograd.Function):
    """``mlstm_scan`` under a gradient: the kernel's forward on CUDA tensors
    (the plain chunk loop on CPU tensors), :func:`mlstm_scan_bwd` backward.

    Inputs (chunk, q, k, v, ig, lf, C0, n0, m0), the state tensors ``None``
    for the zero state; outputs (h, C, n, m).
    """

    @staticmethod
    def forward(ctx, chunk, q, k, v, ig, lf, C0, n0, m0):
        state = None if C0 is None else {"C": C0, "n": n0, "m": m0}
        if q.device.type == "cpu":
            b, hh, s, dh = q.shape
            st = state if state is not None else init_state(b, hh, dh, q.device, v.shape[-1],
                                                            q.dtype)
            qp, kp, vp, igp, lfp, L = _pad(q, k, v, ig, lf, chunk)
            h, out, chunk_in = _chunk_loop(qp, kp, vp, igp, lfp, L, st, keep=True)
            h = h[:, :, :s]
        else:
            h, out, chunk_in = _launch(q, k, v, ig, lf, chunk, state)
        ctx.save_for_backward(q, k, v, ig, lf, *chunk_in, out["C"], out["n"])
        ctx.chunk, ctx.has_state = chunk, state is not None
        return h, out["C"], out["n"], out["m"]

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_out, dC, dn, dm):
        q, k, v, ig, lf, C_in, n_in, m_in, C1, n1 = ctx.saved_tensors
        grads, dst = mlstm_scan_bwd(q, k, v, ig, lf, (C_in, n_in, m_in), (C1, n1), dh_out,
                                    {"C": dC, "n": dn, "m": dm}, chunk=ctx.chunk)
        dst = [dst[key] for key in ("C", "n", "m")] if ctx.has_state else [None] * 3
        return (None, *grads, *dst)


def mlstm_scan_function(q, k, v, ig, lf, *, chunk: int = 64, state: Optional[State] = None
                        ) -> Tuple[torch.Tensor, State]:
    """:class:`MLSTMScanFunction` on either device -> (h, final state)."""
    st = [state[key] for key in ("C", "n", "m")] if state is not None else [None] * 3
    h, C, n, m = MLSTMScanFunction.apply(chunk, q, k, v, ig, lf, *st)
    return h, {"C": C, "n": n, "m": m}


def mlstm_scan(q, k, v, ig, lf, *, chunk: int = 64, state: Optional[State] = None
               ) -> Tuple[torch.Tensor, State]:
    """-> (h [B, H, S, dv] float32, final state); ``state=None`` starts at zero.

    Differentiable on both devices: by :class:`MLSTMScanFunction` on the
    card, by autograd through the plain version on the CPU; without a
    gradient to take it builds no graph.
    """
    if q.device.type == "cpu":
        return mlstm_scan_chunked_ref(q, k, v, ig, lf, chunk=chunk, state=state)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (q, k, v, ig, lf, *(state or {}).values())):
        return mlstm_scan_function(q, k, v, ig, lf, chunk=chunk, state=state)
    h, out, _ = _launch(q, k, v, ig, lf, chunk, state)
    return h, out
