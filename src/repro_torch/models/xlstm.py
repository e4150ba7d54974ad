"""xLSTM blocks [arXiv:2405.04517]: alternating sLSTM and mLSTM layers.

Counterpart of ``repro/models/xlstm.py``.

* **mLSTM**: per-head matrix memory C [dh, dh] with stabilized exponential
  input and forget gates.  The full-sequence forward runs chunkwise-parallel
  through the ``mlstm_scan`` kernel (``cfg.mlstm_chunk`` steps a chunk);
  ``mlstm_chunk=0`` and the decode step run the per-step cell.
* **sLSTM**: scalar memory per channel with the same stabilizer.  Its gates
  depend only on the layer input, so the full-sequence forward factors into
  a max-plus prefix and two linear prefixes (``slstm_assoc``), computed
  here by log-depth doubling where the reference uses ``associative_scan``,
  each with the reference's hand-written adjoint as its backward; the
  decode step runs the per-step cell.

Attention-free: NIMBLE's dispatch has nothing to balance, and the model is
built without it.  Parameters keep the reference's tree: ``blocks`` is a
list of per-layer dicts whose keys differ between sLSTM and mLSTM layers.
Over a mesh each leaf is held as its block and read whole
(``sharding/gather.py``): a layer's leaves as the layer runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..configs.base import ModelConfig
from ..kernels.mlstm_scan.ops import init_state as init_mlstm_scan_state
from ..kernels.mlstm_scan.ops import mlstm_scan
from ..sharding.context import SINGLE, ParallelContext
from ..sharding.gather import placement
from . import layers as L

State = Dict[str, torch.Tensor]

#: parameters the reference keeps in float32 whatever the parameter dtype
F32_PARAMS = ("bi", "bf")


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def is_slstm_layer(cfg: ModelConfig, i: int) -> bool:
    per = max(cfg.slstm_every, 1)
    return (i % per) == (per - 1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #


def _mlstm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    H, _ = _dims(cfg)
    d = cfg.d_model
    return {"norm": (d,), "wq": (d, d), "wk": (d, d), "wv": (d, d),
            "wi": (d, H), "wf": (d, H), "bi": (H,), "bf": (H,),
            "wg": (d, d), "gate_norm": (d,), "wo": (d, d)}


def _slstm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    return {"norm": (d,), "wz": (d, d), "wi": (d, d), "wf": (d, d),
            "wo_gate": (d, d), "bf": (d,), "up": (d, 2 * d), "down": (d, d)}


def param_shapes(cfg: ModelConfig) -> Dict[str, object]:
    """The parameter tree's shapes, keyed as the reference's."""
    blocks = [_slstm_shapes(cfg) if is_slstm_layer(cfg, i) else _mlstm_shapes(cfg)
              for i in range(cfg.n_layers)]
    return {"embed": (cfg.vocab, cfg.d_model), "blocks": blocks,
            "final_norm": (cfg.d_model,), "lm_head": (cfg.d_model, cfg.vocab)}


def init(seed: int, cfg: ModelConfig, ctx: ParallelContext = SINGLE):
    """Random weights from ``seed`` (the reference's scales, not its values)."""
    dt, dev = ctx.param_dtype, ctx.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, _ = _dims(cfg)
    d = cfg.d_model

    def dense(d_in, d_out, scale=None):
        return L.dense_init(gen, d_in, d_out, dt, dev, scale=scale)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=dev)

    def f32(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    blocks = []
    for i in range(cfg.n_layers):
        if is_slstm_layer(cfg, i):
            blocks.append({
                "norm": ones(d), "wz": dense(d, d), "wi": dense(d, d, 0.02),
                "wf": dense(d, d, 0.02), "wo_gate": dense(d, d, 0.02),
                "bf": f32(d, 3.0), "up": dense(d, 2 * d), "down": dense(d, d)})
        else:
            blocks.append({
                "norm": ones(d), "wq": dense(d, d), "wk": dense(d, d),
                "wv": dense(d, d), "wi": dense(d, H, 0.02), "wf": dense(d, H, 0.02),
                "bi": f32(H, 0.0), "bf": f32(H, 3.0), "wg": dense(d, d),
                "gate_norm": ones(d), "wo": dense(d, d)})
    return {
        "embed": (torch.randn((cfg.vocab, d), generator=gen, device=dev) * 0.02).to(dt),
        "blocks": blocks,
        "final_norm": ones(d),
        "lm_head": dense(d, cfg.vocab),
    }


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> State:
    H, dh = _dims(cfg)
    return init_mlstm_scan_state(batch, H, dh, device)


def _mlstm_cell(state: State, q, k, v, ig, fg) -> Tuple[State, torch.Tensor]:
    """One step; q, k, v [B, H, dh], ig, fg [B, H]."""
    C, n, m = state["C"], state["n"], state["m"]
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + m, ig)
    a = torch.exp(lf + m - m_new)
    b = torch.exp(ig - m_new)
    C = C * a[..., None, None] + b[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = n * a[..., None] + b[..., None] * k
    num = torch.einsum("bhdp,bhd->bhp", C, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(), torch.exp(-m_new))
    return {"C": C, "n": n, "m": m_new}, num / den[..., None]


def _mlstm_qkvif(p, h: torch.Tensor, cfg: ModelConfig):
    """h [B, S, D] -> q, k, v [B, S, H, dh] and ig, fg [B, S, H], float32."""
    H, dh = _dims(cfg)
    b, s, _ = h.shape
    q = (h @ p["wq"]).reshape(b, s, H, dh).float() / (dh ** 0.5)
    k = (h @ p["wk"]).reshape(b, s, H, dh).float() / (dh ** 0.25)
    v = (h @ p["wv"]).reshape(b, s, H, dh).float()
    ig = (h @ p["wi"]).float() + p["bi"]
    fg = (h @ p["wf"]).float() + p["bf"]
    return q, k, v, ig, fg


def _mlstm_out(p, h, y, x, cfg: ModelConfig) -> torch.Tensor:
    """Output gate, gate norm and projection: y [B, S, D] float32 -> [B, S, D]."""
    og = torch.sigmoid(h @ p["wg"])
    y = L.rms_norm(y.to(x.dtype) * og, p["gate_norm"], cfg.norm_eps)
    return y @ p["wo"]


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[State] = None
                  ) -> Tuple[torch.Tensor, State]:
    """Per-step mLSTM over x [B, S, D] -> (y [B, S, D], final state)."""
    b, s, d = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v, ig, fg = _mlstm_qkvif(p, h, cfg)
    st = state if state is not None else init_mlstm_state(cfg, b, x.device)
    ys = []
    for t in range(s):
        st, y = _mlstm_cell(st, q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, d)
    return _mlstm_out(p, h, y, x, cfg), st


def mlstm_forward_chunked(p, x: torch.Tensor, cfg: ModelConfig,
                          state: Optional[State] = None, chunk: int = 64
                          ) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM through the ``mlstm_scan`` kernel; the same
    result as :func:`mlstm_forward`."""
    b, s, d = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v, ig, fg = _mlstm_qkvif(p, h, cfg)
    hs, st = mlstm_scan(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        ig.transpose(1, 2), F.logsigmoid(fg).transpose(1, 2),
                        chunk=chunk, state=state)
    y = hs.transpose(1, 2).reshape(b, s, d)
    return _mlstm_out(p, h, y, x, cfg), st


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> State:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "m": z - 30.0, "h": z.clone()}


def _slstm_cell(state: State, z, ig, fg, og) -> Tuple[State, torch.Tensor]:
    """One step; all inputs [B, D]."""
    c, n, m = state["c"], state["n"], state["m"]
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + m, ig)
    a = torch.exp(lf + m - m_new)
    b = torch.exp(ig - m_new)
    c = c * a + b * torch.tanh(z)
    n = n * a + b
    h = torch.sigmoid(og) * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}, h


def _linear_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y_t = a_t y_{t-1} + u_t along dim 1, by log-depth doubling.

    Elements combine as (a1, u1) . (a2, u2) = (a1 a2, u1 a2 + u2), as in the
    reference's ``associative_scan``; the sums group in another order.
    """
    shift, n = 1, a.shape[1]
    while shift < n:
        u = torch.cat([u[:, :shift], u[:, shift:] + a[:, shift:] * u[:, :-shift]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return u


def _maxplus_scan(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m_t = max(m_{t-1} + s_t, v_t) along dim 1, by log-depth doubling.

    Elements combine as (s1, v1) . (s2, v2) = (s1 + s2, max(v1 + s2, v2)).
    """
    shift, n = 1, s.shape[1]
    while shift < n:
        v = torch.cat([v[:, :shift], torch.maximum(v[:, :-shift] + s[:, shift:],
                                                   v[:, shift:])], dim=1)
        s = torch.cat([s[:, :shift], s[:, :-shift] + s[:, shift:]], dim=1)
        shift *= 2
    return v


def _reverse_linear_scan(a_next: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """c_t = g_t + a_next_t c_{t+1}: the forward scan on flipped inputs."""
    return torch.flip(_linear_scan(torch.flip(a_next, [1]), torch.flip(g, [1])), [1])


def _next(x: torch.Tensor) -> torch.Tensor:
    """x_{t+1} along dim 1, 0 after the last step."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


class _LinearPrefix(torch.autograd.Function):
    """The reference's ``linear_prefix`` custom VJP (xlstm.py:254-283): the
    adjoint is a reverse linear recurrence c̄_t = ȳ_t + a_{t+1} c̄_{t+1},
    with ā_t = c̄_t y_{t-1} and ū_t = c̄_t."""

    @staticmethod
    def forward(ctx, a, u):
        y = _linear_scan(a, u)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, y = ctx.saved_tensors
        cbar = _reverse_linear_scan(_next(a), g)
        y_prev = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], dim=1)
        return cbar * y_prev, cbar


class _MaxplusPrefix(torch.autograd.Function):
    """The reference's ``maxplus_prefix`` custom VJP (xlstm.py:286-330): the
    cotangent follows the carry selections sel_t = (m_{t-1} + s_t >= v_t),
    c̄_t = m̄_t + sel_{t+1} c̄_{t+1}, s̄ = sel c̄ and v̄ = (1 - sel) c̄."""

    @staticmethod
    def forward(ctx, s, v):
        m = _maxplus_scan(s, v)
        ctx.save_for_backward(s, v, m)
        return m

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        s, v, m = ctx.saved_tensors
        m_prev = torch.cat([torch.full_like(m[:, :1], float("-inf")), m[:, :-1]], dim=1)
        sel = (m_prev + s >= v).to(g.dtype)            # 1: the carry is selected
        cbar = _reverse_linear_scan(_next(sel), g)
        return sel * cbar, (1.0 - sel) * cbar


def linear_prefix(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y_t = a_t y_{t-1} + u_t along dim 1; differentiable by the reference's
    adjoint (:class:`_LinearPrefix`) when an input needs a gradient."""
    if torch.is_grad_enabled() and (a.requires_grad or u.requires_grad):
        return _LinearPrefix.apply(a, u)
    return _linear_scan(a, u)


def maxplus_prefix(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m_t = max(m_{t-1} + s_t, v_t) along dim 1; differentiable by the
    reference's adjoint (:class:`_MaxplusPrefix`) when an input needs a
    gradient."""
    if torch.is_grad_enabled() and (s.requires_grad or v.requires_grad):
        return _MaxplusPrefix.apply(s, v)
    return _maxplus_scan(s, v)


def _slstm_gates(p, x: torch.Tensor, cfg: ModelConfig):
    hpre = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z = (hpre @ p["wz"]).float()
    ig = (hpre @ p["wi"]).float()
    fg = (hpre @ p["wf"]).float() + p["bf"]
    og = (hpre @ p["wo_gate"]).float()
    return z, ig, fg, og


def _slstm_out(p, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """GEGLU-style up/down projection of h [B, S, D] float32."""
    d = x.shape[-1]
    y = h.to(x.dtype)
    y = _gelu(y @ p["up"][:, :d]) * (y @ p["up"][:, d:])
    return y @ p["down"]


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[State] = None
                  ) -> Tuple[torch.Tensor, State]:
    """Per-step sLSTM over x [B, S, D] -> (y [B, S, D], final state)."""
    z, ig, fg, og = _slstm_gates(p, x, cfg)
    st = state if state is not None else init_slstm_state(cfg, x.shape[0], x.device)
    hs = []
    for t in range(x.shape[1]):
        st, h = _slstm_cell(st, z[:, t], ig[:, t], fg[:, t], og[:, t])
        hs.append(h)
    return _slstm_out(p, torch.stack(hs, dim=1), x), st


def slstm_forward_assoc(p, x: torch.Tensor, cfg: ModelConfig,
                        state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """sLSTM through one max-plus and two linear prefixes (xlstm.py:333-375)."""
    b, s, d = x.shape
    z, ig, fg, og = _slstm_gates(p, x, cfg)
    st = state if state is not None else init_slstm_state(cfg, b, x.device)
    lf = F.logsigmoid(fg)                                 # [B,S,D]
    # 1. stabilizer prefix, with the carried m as a virtual step 0
    zero = torch.zeros((b, 1, d), dtype=torch.float32, device=x.device)
    m_all = maxplus_prefix(torch.cat([zero, lf], dim=1),
                           torch.cat([st["m"][:, None], ig], dim=1))
    m_prev, m = m_all[:, :-1], m_all[:, 1:]
    a = torch.exp(lf + m_prev - m)                        # decay (<= 1)
    bw = torch.exp(ig - m)                                # input weight
    # 2. linear prefixes for c and n, with the carried state as step 0 (a = 1)
    a_el = torch.cat([zero + 1.0, a], dim=1)
    c = linear_prefix(a_el, torch.cat([st["c"][:, None], bw * torch.tanh(z)], dim=1))[:, 1:]
    n = linear_prefix(a_el, torch.cat([st["n"][:, None], bw], dim=1))[:, 1:]
    h = torch.sigmoid(og) * c / torch.clamp_min(n, 1e-6)
    new_state = {"c": c[:, -1], "n": n[:, -1], "m": m[:, -1], "h": h[:, -1]}
    return _slstm_out(p, h, x), new_state


# --------------------------------------------------------------------------- #
# full model
# --------------------------------------------------------------------------- #


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ParallelContext = SINGLE, *, last_only: bool = False,
            place=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V], or [B, 1, V] with ``last_only``.
    ``place``: the parameters' placement (``sharding/gather.py::placement``;
    under TP use from ``Model.loss`` only the logits are by vocab: the
    gates' leaves are read whole)."""
    place = placement(param_shapes, cfg, ctx) if place is None else place
    x = place.at("embed").whole(params["embed"])[tokens].to(ctx.compute_dtype)
    for i, p in enumerate(params["blocks"]):
        p = place.at("blocks", i).whole(p)
        if is_slstm_layer(cfg, i):
            fwd = slstm_forward_assoc if cfg.slstm_assoc else slstm_forward
            y, _ = fwd(p, x, cfg)
        elif cfg.mlstm_chunk > 0:
            y, _ = mlstm_forward_chunked(p, x, cfg, chunk=cfg.mlstm_chunk)
        else:
            y, _ = mlstm_forward(p, x, cfg)
        x = x + y
    if last_only:
        x = x[:, -1:]                    # slice before lm_head
    return L.lm_head(params, x, cfg.norm_eps, place)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               ctx: ParallelContext = SINGLE) -> List[State]:
    """Each layer's recurrent state; O(1) in the sequence, so no ``cache_len``."""
    return [init_slstm_state(cfg, batch, ctx.device) if is_slstm_layer(cfg, i)
            else init_mlstm_state(cfg, batch, ctx.device) for i in range(cfg.n_layers)]


def decode_step(params, cache: List[State], token: torch.Tensor, pos: int,
                cfg: ModelConfig, ctx: ParallelContext = SINGLE):
    """token [B] -> (logits [B, V], the new per-layer states)."""
    place = placement(param_shapes, cfg, ctx)
    x = place.at("embed").whole(params["embed"])[token][:, None, :].to(ctx.compute_dtype)
    new_cache = []
    for i, (p, st) in enumerate(zip(params["blocks"], cache)):
        fwd = slstm_forward if is_slstm_layer(cfg, i) else mlstm_forward
        y, st = fwd(place.at("blocks", i).whole(p), x, cfg, state=st)
        x = x + y
        new_cache.append(st)
    return L.lm_head(params, x, cfg.norm_eps, place)[:, 0], new_cache
