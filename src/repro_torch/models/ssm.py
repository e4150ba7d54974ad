"""Mamba2-style selective SSM blocks (the zamba2 backbone).

Counterpart of ``repro/models/ssm.py``: the SSD (state-space duality)
recurrence with per-head scalar decay,

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t ⊗ x_t         (state [N, P])
    y_t = C_t · h_t + D * x_t

chunked for the full-sequence forward, and the O(1) recurrent update on a
carried state for decode.  The reference's ``_ssd_chunked`` is a
``lax.scan`` over chunks (no TPU kernel); here it is plain torch: the
intra-chunk quadratic part and each chunk's state are batched over the
chunks, and only the carry ``h <- h * exp(total) + state`` loops over the
chunks (16 at S 2048).

Parameters keep the reference's keys; the block's leaves may carry a
leading layer axis (``lead``), as the hybrid's vmapped init stacks them.
``A_log``, ``D`` and ``dt_bias`` stay float32, as in the reference (float64
in a float64 run, whose casts to float32 are casts to at least float32).

Over a model group that holds the rows replicated (``sharding/tp.py``), a
layer runs on this process's SSM heads (:func:`_local`), its ``gate_norm``
summed over the group (:func:`_gate_norm`), its ``out_proj`` output summed
once; the decode's conv and SSM caches hold those heads.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers as L

#: the leaves the reference keeps in float32
F32_PARAMS = ("A_log", "D", "dt_bias")


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_inner // 64)
    P = d_inner // H          # head channel dim
    N = cfg.ssm_state         # state dim
    return d_inner, H, P, N


def mamba_shapes(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict[str, tuple]:
    """The shapes of :func:`init_mamba_block`'s leaves."""
    d_inner, H, P, N = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * N * H + H
    D = cfg.d_model
    return {"norm": (*lead, D), "in_proj": (*lead, D, d_in_proj),
            "conv_w": (*lead, cfg.ssm_conv, d_inner), "conv_b": (*lead, d_inner),
            "A_log": (*lead, H), "D": (*lead, H), "dt_bias": (*lead, H),
            "out_proj": (*lead, d_inner, D), "gate_norm": (*lead, d_inner)}


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                     lead: Tuple[int, ...] = ()):
    """in_proj emits [z (gate), x, B, C, dt] fused, as in Mamba2."""
    d_inner, H, P, N = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * N * H + H
    f32 = dict(dtype=torch.promote_types(dtype, torch.float32), device=device)
    return {
        "norm": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device),
        "in_proj": L.dense_init(gen, cfg.d_model, d_in_proj, dtype, device, lead),
        "conv_w": (torch.randn((*lead, cfg.ssm_conv, d_inner), generator=gen,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, d_inner), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(*lead, H).clone(),
        "D": torch.ones((*lead, H), **f32),
        "dt_bias": torch.zeros((*lead, H), **f32),
        "out_proj": L.dense_init(gen, d_inner, cfg.d_model, dtype, device, lead),
        "gate_norm": torch.ones((*lead, d_inner), dtype=dtype, device=device),
    }


def _local(p, cfg: ModelConfig, tp):
    """(``p`` on this process's SSM heads, and their d_inner, H, P, N).

    ``tp`` (``sharding/tp.py``): process r of m computes heads ``r H/m ...
    (r+1) H/m - 1`` (``H % m == 0``: ``sharding/gather.py`` keeps the
    Mamba leaves' "model" blocks only then).  ``conv_w``, ``conv_b``,
    ``gate_norm`` and ``out_proj`` are those blocks as held: exactly the
    heads' x channels.  ``in_proj`` is read whole (its "model" block of
    contiguous columns cuts across the five groups), and its columns of the
    heads are cut out of each group: z and x (the heads' P channels), B and
    C (their N), dt (the heads); ``A_log``, ``D`` and ``dt_bias``
    (replicated) their heads."""
    d_inner, H, P, N = _dims(cfg)
    if tp is None:
        return p, d_inner, H, P, N
    hq = H // tp.size
    h0 = tp.rank * hq
    starts = (0, d_inner, 2 * d_inner, 2 * d_inner + N * H, 2 * d_inner + 2 * N * H)
    sizes = (P, P, N, N, 1)
    w = p["in_proj"]
    cols = [w[..., s0 + h0 * n:s0 + (h0 + hq) * n] for s0, n in zip(starts, sizes)]
    heads = slice(h0, h0 + hq)
    return (dict(p, in_proj=torch.cat(cols, -1), A_log=p["A_log"][heads], D=p["D"][heads],
                 dt_bias=p["dt_bias"][heads]), hq * P, hq, P, N)


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, H: int, N: int):
    return torch.split(zxbcdt, [d_inner, d_inner, N * H, N * H, H], dim=-1)


def _gate_norm(y: torch.Tensor, w: torch.Tensor, eps: float, d_inner: int, tp):
    """``rms_norm`` of y over the whole ``d_inner``: under ``tp`` y holds the
    process's channels, and their sum of squares ([B, S, 1], at least
    float32) is summed over the group before the scale."""
    if tp is None:
        return L.rms_norm(y, w, eps)
    yf = L.up32(y)
    var = tp.sum(torch.sum(yf * yf, dim=-1, keepdim=True)) / (d_inner * tp.size)
    return (yf * torch.rsqrt(var + eps)).to(y.dtype) * w


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``; ``F.softplus`` turns linear past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv1d.  x: [B, S, C]; w: [K, C].  state: [B, K-1, C]."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return F.silu(out), new_state


def _ssd_chunked(x, dt, B, C, A, D, chunk: int = 128):
    """Chunk-parallel SSD scan.

    x: [Bt, S, H, P]; dt: [Bt, S, H]; B, C: [Bt, S, H, N]; A: [H] (negative).
    Returns y: [Bt, S, H, P].
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x, B, C = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    Sp = nc * chunk
    xc = x.reshape(Bt, nc, chunk, H, P)
    dtc = dt.reshape(Bt, nc, chunk, H)
    Bc = B.reshape(Bt, nc, chunk, H, N)
    Cc = C.reshape(Bt, nc, chunk, H, N)

    dA = dtc * A                                           # [Bt,nc,L,H] (<=0)
    cum = torch.cumsum(dA, dim=2)                          # within-chunk log decay
    total = cum[:, :, -1]                                  # [Bt,nc,H]

    # intra-chunk (quadratic within the chunk, causal)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [Bt,nc,Li,Lj,H]
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: non-causal entries have seg >= 0 (cum is decreasing),
    # exp would overflow and where()'s gradient would turn inf*0 into NaN
    decay = torch.exp(torch.where(causal[:, :, None], seg, float("-inf")))
    G = torch.einsum("bclhn,bcmhn->bclmh", Cc, Bc)          # [Bt,nc,Li,Lj,H]
    M = G * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", M, xc)

    # chunk states: S_c = sum_j exp(total - cum_j) * dt_j * B_j x_j^T
    w = torch.exp(total[:, :, None, :] - cum) * dtc        # [Bt,nc,L,H]
    states = torch.einsum("bclhn,bclhp->bchnp", w[..., None] * Bc, xc)

    # inter-chunk recurrence over the carried state: each chunk's input state
    h = torch.zeros((Bt, H, N, P), dtype=x.dtype, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                    # [Bt,nc,H,N,P]
    y_inter = torch.einsum("bclhn,bchnp->bclhp", Cc * torch.exp(cum)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(Bt, Sp, H, P)[:, :S]
    return y + x.reshape(Bt, Sp, H, P)[:, :S] * D[None, None, :, None]


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] (residual applied by the caller).  ``tp``: on
    this process's SSM heads (:func:`_local`), ``out_proj`` its rows of
    them, the output summed over the model group."""
    p, d_inner, H, P, N = _local(p, cfg, tp)
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z, xi, Bv, Cv, dt = _split_proj(h @ p["in_proj"], d_inner, H, N)
    xi, _ = _causal_conv(xi, p["conv_w"][:, :d_inner], p["conv_b"], None)
    dt = _softplus(L.up32(dt) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    Bt, S = x.shape[:2]
    y = _ssd_chunked(
        L.up32(xi.reshape(Bt, S, H, P)), dt,
        L.up32(Bv.reshape(Bt, S, H, N)), L.up32(Cv.reshape(Bt, S, H, N)),
        A, p["D"],
    ).reshape(Bt, S, d_inner).to(x.dtype)
    y = _gate_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps, d_inner, tp) @ p["out_proj"]
    return y if tp is None else tp.sum(y)


# -- decode ------------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device,
                     lead: Tuple[int, ...] = (), tp=None):
    """The conv window ``[*lead, B, K-1, d_inner]`` and the SSM state ``[*lead,
    B, H, N, P]`` (at least float32); ``tp``: this process's SSM heads of
    them (its ``d_inner`` block of channels, its ``H / m`` heads)."""
    d_inner, H, P, N = _dims(cfg)
    if tp is not None:
        d_inner, H = d_inner // tp.size, H // tp.size
    return {
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((*lead, batch, H, N, P),
                           dtype=torch.promote_types(dtype, torch.float32), device=device),
    }


def mamba_decode(p, x: torch.Tensor, cache, cfg: ModelConfig, tp=None):
    """x: [B, 1, D]; the O(1) recurrent update -> (y [B, 1, D], new cache).
    ``tp``: on this process's SSM heads, as :func:`mamba_forward`, against
    its blocks of the cache (:func:`init_mamba_cache`)."""
    p, d_inner, H, P, N = _local(p, cfg, tp)
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z, xi, Bv, Cv, dt = _split_proj(h @ p["in_proj"], d_inner, H, N)
    xi, conv_state = _causal_conv(xi, p["conv_w"][:, :d_inner], p["conv_b"], cache["conv"])
    dt = _softplus(L.up32(dt) + p["dt_bias"])[:, 0]                    # [B,H]
    A = -torch.exp(p["A_log"])
    xh = L.up32(xi[:, 0].reshape(-1, H, P))
    Bh = L.up32(Bv[:, 0].reshape(-1, H, N))
    Ch = L.up32(Cv[:, 0].reshape(-1, H, N))
    decay = torch.exp(dt * A[None, :])                                  # [B,H]
    hs = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", dt[..., None] * Bh, xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, hs) + xh * p["D"][None, :, None]
    y = y.reshape(-1, 1, d_inner).to(x.dtype)
    y = _gate_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps, d_inner, tp) @ p["out_proj"]
    return (y if tp is None else tp.sum(y)), {"conv": conv_state, "ssm": hs}
