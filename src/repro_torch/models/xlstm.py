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

Over a model group that holds the rows replicated (TP use,
``sharding/tp.py``; the train step's loss and serving), each layer takes
its ``TensorParallel`` from ``place.tp_at("blocks", i)``:

* an mLSTM layer splits by the "model" block of ``wv``: process r of m
  computes the value columns ``[r d/m, (r+1) d/m)`` (``tp.value_columns``:
  whole heads where m divides the heads, ``d/m`` columns of one head where
  the heads divide m), with q and k of its heads whole (all dk columns,
  cut from ``wq``/``wk`` read whole where m does not divide the heads),
  so ``mlstm_scan`` runs at dv < dk there.  ``n`` and the denominator
  ``n^T q`` are its heads' own: no sum.  ``wv``, ``wg``, ``gate_norm`` and
  ``wo`` keep their blocks; ``gate_norm``'s sum of squares and ``wo``'s
  output are summed over the group (:func:`_mlstm_out`);
* an sLSTM layer splits by channels ``[r d/m, (r+1) d/m)``: its gates and
  prefix scans run on them with no collective, then ``h`` is gathered over
  the group (``TensorParallel.gather_last``, backward a reduce-scatter),
  the GEGLU runs on the process's columns of each half of ``up`` (read
  whole) and ``down``'s output is summed (:func:`_slstm_out`);
* a layer whose split does not exist (m does not divide d, or the value
  block is neither whole heads nor a divisor of one) runs whole.

The serving states follow: an mLSTM layer's ``C [B, H_loc, dk, dv_loc]``,
``n [B, H_loc, dk]``, ``m [B, H_loc]``, an sLSTM layer's ``c``, ``n``,
``m``, ``h`` ``[B, d/m]`` (:func:`init_cache` with the serving placement).
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
from ..sharding.tp import value_columns
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


def _mlstm_dims(cfg: ModelConfig, tp) -> Tuple[int, int, int, int]:
    """(first head, heads, first value column of a head, value columns a head)
    of this process: every head whole without ``tp``, else
    ``tp.value_columns`` (module docstring)."""
    H, dh = _dims(cfg)
    if tp is None:
        return 0, H, 0, dh
    return value_columns(H, dh, tp.size, tp.rank)


def init_mlstm_state(cfg: ModelConfig, batch: int, device, tp=None,
                     dtype=torch.float32) -> State:
    _, hq, _, dv = _mlstm_dims(cfg, tp)
    return init_mlstm_scan_state(batch, hq, _dims(cfg)[1], device, dv, dtype)


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


def _mlstm_qkvif(p, h: torch.Tensor, cfg: ModelConfig, tp=None):
    """h [B, S, D] -> q, k [B, S, H, dh], v [B, S, H, dv] and ig, fg [B, S, H],
    at least float32: every head whole without ``tp``, else this process's heads
    (all dh key columns) and value columns (``_mlstm_dims``).  ``wv`` is its
    block of value columns as held; ``wq``, ``wk``, ``wi`` and ``wf`` are
    their blocks of the heads where m divides the heads, else read whole and
    the heads' columns cut here; ``bi``/``bf`` (replicated) their heads."""
    _, dh = _dims(cfg)
    h0, hq, _, dv = _mlstm_dims(cfg, tp)
    if tp is not None:
        heads, cols = slice(h0, h0 + hq), slice(h0 * dh, (h0 + hq) * dh)
        p = dict(p, bi=p["bi"][heads], bf=p["bf"][heads])
        if p["wq"].shape[-1] != hq * dh:
            p.update(wq=p["wq"][:, cols], wk=p["wk"][:, cols])
        if p["wi"].shape[-1] != hq:
            p.update(wi=p["wi"][:, heads], wf=p["wf"][:, heads])
    b, s, _ = h.shape
    q = L.up32((h @ p["wq"]).reshape(b, s, hq, dh)) / (dh ** 0.5)
    k = L.up32((h @ p["wk"]).reshape(b, s, hq, dh)) / (dh ** 0.25)
    v = L.up32((h @ p["wv"]).reshape(b, s, hq, dv))
    ig = L.up32(h @ p["wi"]) + p["bi"]
    fg = L.up32(h @ p["wf"]) + p["bf"]
    return q, k, v, ig, fg


def _mlstm_out(p, h, y, x, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Output gate, gate norm and projection: y [B, S, D] float32 -> [B, S, D].
    Under ``tp`` y holds this process's value columns, as ``wg`` and
    ``gate_norm`` do: the norm's sum of squares over d is summed over the
    group (``models/ssm.py::_gate_norm``) and ``wo``'s rows give a partial
    product, summed once."""
    og = torch.sigmoid(h @ p["wg"])
    z = y.to(x.dtype) * og
    if tp is None:
        return L.rms_norm(z, p["gate_norm"], cfg.norm_eps) @ p["wo"]
    zf = L.up32(z)
    var = tp.sum(torch.sum(zf * zf, dim=-1, keepdim=True)) / cfg.d_model
    z = (zf * torch.rsqrt(var + cfg.norm_eps)).to(z.dtype) * p["gate_norm"]
    return tp.sum(z @ p["wo"])


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[State] = None,
                  tp=None) -> Tuple[torch.Tensor, State]:
    """Per-step mLSTM over x [B, S, D] -> (y [B, S, D], final state); ``tp``:
    on this process's value columns (module docstring)."""
    b, s, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v, ig, fg = _mlstm_qkvif(p, h, cfg, tp)
    st = state if state is not None else init_mlstm_state(cfg, b, x.device, tp, q.dtype)
    ys = []
    for t in range(s):
        st, y = _mlstm_cell(st, q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1).flatten(2)
    return _mlstm_out(p, h, y, x, cfg, tp), st


def mlstm_forward_chunked(p, x: torch.Tensor, cfg: ModelConfig,
                          state: Optional[State] = None, chunk: int = 64, tp=None
                          ) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM through the ``mlstm_scan`` kernel; the same
    result as :func:`mlstm_forward` (under ``tp`` at the process's value
    width, dv < dk where it holds part of a head)."""
    b, s, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v, ig, fg = _mlstm_qkvif(p, h, cfg, tp)
    hs, st = mlstm_scan(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        ig.transpose(1, 2), F.logsigmoid(fg).transpose(1, 2),
                        chunk=chunk, state=state)
    y = hs.transpose(1, 2).flatten(2)
    return _mlstm_out(p, h, y, x, cfg, tp), st


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #


def init_slstm_state(cfg: ModelConfig, batch: int, device, tp=None,
                     dtype=torch.float32) -> State:
    width = cfg.d_model if tp is None else cfg.d_model // tp.size
    z = torch.zeros((batch, width), dtype=dtype, device=device)
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


def _slstm_gates(p, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """The gates [B, S, D], at least float32; under ``tp`` this process's channels:
    ``wz``/``wi``/``wf``/``wo_gate`` are their blocks as held, ``bf``
    (replicated) is sliced, ``norm`` applies whole to the replicated input."""
    bf = p["bf"]
    if tp is not None:
        c = cfg.d_model // tp.size
        bf = bf[tp.rank * c:(tp.rank + 1) * c]
    hpre = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z = L.up32(hpre @ p["wz"])
    ig = L.up32(hpre @ p["wi"])
    fg = L.up32(hpre @ p["wf"]) + bf
    og = L.up32(hpre @ p["wo_gate"])
    return z, ig, fg, og


def _slstm_out(p, h: torch.Tensor, x: torch.Tensor, tp=None) -> torch.Tensor:
    """GEGLU-style up/down projection of h [B, S, D] float32.  Under ``tp`` h
    holds this process's channels: it is gathered whole over the group,
    the GEGLU runs on the process's columns of each half of ``up`` (read
    whole), and ``down``'s block of rows gives a partial product, summed."""
    d = x.shape[-1]
    y = h.to(x.dtype)
    if tp is None:
        return (_gelu(y @ p["up"][:, :d]) * (y @ p["up"][:, d:])) @ p["down"]
    c = d // tp.size
    cols = slice(tp.rank * c, (tp.rank + 1) * c)
    up = p["up"]
    y = tp.gather_last(y)
    y = _gelu(y @ up[:, cols]) * (y @ up[:, d + cols.start:d + cols.stop])
    return tp.sum(y @ p["down"])


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[State] = None,
                  tp=None) -> Tuple[torch.Tensor, State]:
    """Per-step sLSTM over x [B, S, D] -> (y [B, S, D], final state); ``tp``:
    on this process's channels (module docstring)."""
    z, ig, fg, og = _slstm_gates(p, x, cfg, tp)
    st = state if state is not None else init_slstm_state(cfg, x.shape[0], x.device, tp,
                                                          z.dtype)
    hs = []
    for t in range(x.shape[1]):
        st, h = _slstm_cell(st, z[:, t], ig[:, t], fg[:, t], og[:, t])
        hs.append(h)
    return _slstm_out(p, torch.stack(hs, dim=1), x, tp), st


def slstm_forward_assoc(p, x: torch.Tensor, cfg: ModelConfig,
                        state: Optional[State] = None, tp=None
                        ) -> Tuple[torch.Tensor, State]:
    """sLSTM through one max-plus and two linear prefixes (xlstm.py:333-375)."""
    b, s, _ = x.shape
    z, ig, fg, og = _slstm_gates(p, x, cfg, tp)
    d = z.shape[-1]                                       # this process's channels
    st = state if state is not None else init_slstm_state(cfg, b, x.device, tp, z.dtype)
    lf = F.logsigmoid(fg)                                 # [B,S,D]
    # 1. stabilizer prefix, with the carried m as a virtual step 0
    zero = torch.zeros((b, 1, d), dtype=z.dtype, device=x.device)
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
    return _slstm_out(p, h, x, tp), new_state


# --------------------------------------------------------------------------- #
# full model
# --------------------------------------------------------------------------- #


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ParallelContext = SINGLE, *, last_only: bool = False,
            place=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V], or [B, 1, V] with ``last_only``.
    ``place``: the parameters' placement (``sharding/gather.py::placement``;
    under TP use each layer on its ``TensorParallel``, the logits by
    vocab)."""
    place = placement(param_shapes, cfg, ctx) if place is None else place
    x = place.at("embed").whole(params["embed"])[tokens].to(ctx.compute_dtype)
    for i, p in enumerate(params["blocks"]):
        tp = place.tp_at("blocks", i)
        p = place.at("blocks", i).whole(p)
        if is_slstm_layer(cfg, i):
            fwd = slstm_forward_assoc if cfg.slstm_assoc else slstm_forward
            y, _ = fwd(p, x, cfg, tp=tp)
        elif cfg.mlstm_chunk > 0:
            y, _ = mlstm_forward_chunked(p, x, cfg, chunk=cfg.mlstm_chunk, tp=tp)
        else:
            y, _ = mlstm_forward(p, x, cfg, tp=tp)
        x = x + y
    if last_only:
        x = x[:, -1:]                    # slice before lm_head
    return L.lm_head(params, x, cfg.norm_eps, place)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               ctx: ParallelContext = SINGLE, place=None) -> List[State]:
    """Each layer's recurrent state; O(1) in the sequence, so no ``cache_len``.
    ``place``: the serving placement, under TP use each layer's states on
    this process's heads and value columns or channels (module docstring)."""
    tps = [None if place is None else place.tp_at("blocks", i) for i in range(cfg.n_layers)]
    dt = torch.promote_types(ctx.compute_dtype, torch.float32)
    return [init_slstm_state(cfg, batch, ctx.device, tp, dt) if is_slstm_layer(cfg, i)
            else init_mlstm_state(cfg, batch, ctx.device, tp, dt) for i, tp in enumerate(tps)]


def decode_step(params, cache: List[State], token: torch.Tensor, pos: int,
                cfg: ModelConfig, ctx: ParallelContext = SINGLE, place=None):
    """token [B] -> (logits [B, V], ``cache`` with each layer's state replaced
    in place); ``place`` as :func:`init_cache` took it."""
    place = placement(param_shapes, cfg, ctx) if place is None else place
    x = place.at("embed").whole(params["embed"])[token][:, None, :].to(ctx.compute_dtype)
    for i, p in enumerate(params["blocks"]):
        fwd = slstm_forward if is_slstm_layer(cfg, i) else mlstm_forward
        y, cache[i] = fwd(place.at("blocks", i).whole(p), x, cfg, state=cache[i],
                          tp=place.tp_at("blocks", i))
        x = x + y
    return L.lm_head(params, x, cfg.norm_eps, place)[:, 0], cache
