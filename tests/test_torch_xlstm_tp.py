"""xLSTM under tensor-parallel use, on the CPU: the pieces below the gloo worlds.

* ``mlstm_scan`` at a value width dv below the key width dk (a process's
  value columns of one head): the plain chunk loop's output and final
  state, and ``MLSTMScanFunction``'s gradients, against the JAX package's
  ``_mlstm_chunk_body`` (general in dv) looped over the chunks, within
  1e-5 of each one's largest value; and the columns of the port's own
  dv = dk result.
* ``sharding/tp.py::value_columns``: the processes' value columns cover d
  once, in order, whole heads or columns of one head.
* An mLSTM layer on m ranks (threads of this process as the model group),
  each on its value columns (``wv``/``wg``/``gate_norm``/``wo`` blocks,
  its heads cut from ``wq``/``wk``/``wi``/``wf`` read whole where m does
  not divide them): every rank's output is the whole layer's within 1e-5,
  chunked and per step; without ``gate_norm``'s group sum it is not.  An
  sLSTM layer on its channels (its ``h`` gathered, ``up``'s halves cut):
  the same.  The decode's states on each rank are the blocks of the
  whole layer's states.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jx
from repro_torch.configs.base import get_config
from repro_torch.kernels.mlstm_scan.ops import (init_state, mlstm_scan_chunked_ref,
                                               mlstm_scan_function)
from repro_torch.models import xlstm as tx
from repro_torch.sharding.context import ParallelContext
from repro_torch.sharding.tp import TensorParallel, value_columns

pytestmark = pytest.mark.torch_port

# f32 on both sides: the plain scan against the reference's chunk body, and
# the ranks' layers against the whole layer, within 1e-5 of the largest
TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


def _j_chunked(q, k, v, ig, lf, C, n, m, *, chunk):
    """The reference's chunk body (``repro/models/xlstm.py::_mlstm_chunk_body``)
    looped over the chunks on the port's layout: q, k [B, H, S, dk], v [B,
    H, S, dv] -> (h [B, H, S, dv], C, n, m)."""
    q, k, v = (a.transpose(0, 2, 1, 3) for a in (q, k, v))
    ig, lf = ig.transpose(0, 2, 1), lf.transpose(0, 2, 1)
    S = q.shape[1]
    L = min(chunk, S)
    pad = -(-S // L) * L - S
    if pad:
        q, k, v = (jnp.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0))) for a in (q, k, v))
        ig = jnp.pad(ig, ((0, 0), (0, pad), (0, 0)), constant_values=-1e30)
        lf = jnp.pad(lf, ((0, 0), (0, pad), (0, 0)))
    carry, hs = {"C": C, "n": n, "m": m}, []
    for c0 in range(0, S + pad, L):
        sl = slice(c0, c0 + L)
        carry, h = jx._mlstm_chunk_body(carry, (q[:, sl], k[:, sl], v[:, sl], ig[:, sl],
                                                lf[:, sl]), L)
        hs.append(h)
    h = jnp.concatenate(hs, axis=1)[:, :S].transpose(0, 2, 1, 3)
    return h, carry["C"], carry["n"], carry["m"]


def _inputs(seed, b, h, s, dk, dv, with_state):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, h, s, dk)).astype(np.float32) * 0.3 for _ in range(2))
    v = rng.normal(size=(b, h, s, dv)).astype(np.float32) * 0.3
    ig = (rng.normal(size=(b, h, s)) * 0.5).astype(np.float32)
    lf = np.log(1.0 / (1.0 + np.exp(-(rng.normal(size=(b, h, s)) + 2.0)))).astype(np.float32)
    if with_state:
        st = [(rng.normal(size=(b, h, dk, dv)) * 0.2).astype(np.float32),
              (rng.normal(size=(b, h, dk)) * 0.2).astype(np.float32),
              rng.normal(size=(b, h)).astype(np.float32)]
    else:
        st = [a.numpy() for a in init_state(b, h, dk, "cpu", dv).values()]
    cots = [rng.normal(size=(b, h, s, dv)).astype(np.float32),
            rng.normal(size=(b, h, dk, dv)).astype(np.float32),
            rng.normal(size=(b, h, dk)).astype(np.float32),
            rng.normal(size=(b, h)).astype(np.float32)]
    return [q, k, v, ig, lf], st, cots


@pytest.mark.parametrize("dk,dv", [(16, 4), (16, 8), (12, 3), (8, 8)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(40, 16), (21, 8)])
def test_plain_mlstm_scan_at_dv_matches_the_reference_chunk_body(dk, dv, with_state, s, chunk):
    """Forward (h and the final C, n, m) of ``mlstm_scan_chunked_ref`` and of
    ``MLSTMScanFunction``, and the Function's gradients (inputs and the
    carried state), against ``jax.vjp`` of the reference's chunk body."""
    ins, st, cots = _inputs(dk * 100 + dv + s + with_state, 2, 2, s, dk, dv, with_state)
    outs, vjp = jax.vjp(jax.jit(functools.partial(_j_chunked, chunk=chunk)),
                        *(jnp.asarray(a) for a in ins + st))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    state = dict(zip(("C", "n", "m"), (torch.tensor(a) for a in st)))
    h, fin = mlstm_scan_chunked_ref(*(torch.tensor(a) for a in ins), chunk=chunk, state=state)
    for a, w in zip((h, fin["C"], fin["n"], fin["m"]), outs):
        _close(a, w)
    live = [torch.tensor(a, requires_grad=True) for a in ins + st]
    h, fin = mlstm_scan_function(*live[:5], chunk=chunk,
                                 state=dict(zip(("C", "n", "m"), live[5:])))
    got_out = (h, fin["C"], fin["n"], fin["m"])
    for a, w in zip(got_out, outs):
        _close(a, w)
    wrt = live if with_state else live[:5]       # the zero state's m: no gradient
    got = torch.autograd.grad(got_out, wrt, [torch.tensor(c) for c in cots])
    for a, w in zip(got, want):
        assert float(a.abs().max()) > 0
        _close(a, w)


@pytest.mark.parametrize("dk,parts", [(16, 4), (12, 3), (8, 2)])
def test_mlstm_scan_value_columns_are_the_whole_scans_columns(dk, parts):
    """Each block of dk / parts value columns through the plain scan gives
    those columns of the dv = dk scan's h and C, and its n and m."""
    ins, st, _ = _inputs(dk + parts, 2, 3, 33, dk, dk, True)
    t = [torch.tensor(a) for a in ins]
    st = dict(zip(("C", "n", "m"), (torch.tensor(a) for a in st)))
    h, fin = mlstm_scan_chunked_ref(*t, chunk=16, state=st)
    c = dk // parts
    for r in range(parts):
        cols = slice(r * c, (r + 1) * c)
        part = dict(st, C=st["C"][..., cols])
        hp, fp = mlstm_scan_chunked_ref(t[0], t[1], t[2][..., cols], t[3], t[4], chunk=16,
                                        state=part)
        _close(hp, h[..., cols])
        _close(fp["C"], fin["C"][..., cols])
        assert torch.equal(fp["n"], fin["n"]) and torch.equal(fp["m"], fin["m"])


@pytest.mark.parametrize("heads,dh,m", [(4, 192, 16), (4, 192, 8), (4, 192, 4), (4, 64, 2),
                                         (1, 128, 4), (2, 64, 8), (4, 192, 3), (6, 64, 4)])
def test_value_columns_cover_d_once(heads, dh, m):
    """The ranks' value columns, as (head, column) pairs in rank order, are
    every column of every head once; whole heads where m divides the
    heads, one head's d/m columns where the heads divide m, none else."""
    got = [value_columns(heads, dh, m, r) for r in range(m)]
    if heads % m and m % heads:
        assert got == [None] * m
        return
    cols = [(h, p) for h0, hq, p0, pc in got for h in range(h0, h0 + hq)
            for p in range(p0, p0 + pc)]
    assert cols == [(h, p) for h in range(heads) for p in range(dh)]
    assert all(hq == 1 for _, hq, _, _ in got) or all(pc == dh for *_, pc in got)


class _Threads:
    """m threads of this process as a model group: each collective hands its
    tensor in and every thread reads all m of them, in rank order."""

    def __init__(self, m):
        self.barrier, self.slots = threading.Barrier(m), [None] * m

    def exchange(self, rank, t):
        self.slots[rank] = t
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _Thread(TensorParallel):
    """Rank ``rank`` of ``size`` threads sharing ``group`` (a :class:`_Threads`)."""

    def sum(self, y):
        return torch.stack(self.group.exchange(self.rank, y)).sum(0)

    def gather_last(self, t):
        return torch.cat(self.group.exchange(self.rank, t), dim=-1)


class _NoNormSum(_Thread):
    """:class:`_Thread` that leaves ``gate_norm``'s sum of squares ([B, S, 1])
    unsummed: the norm then scales by each rank's own columns."""

    def sum(self, y):
        return y if y.shape[-1] == 1 else super().sum(y)


def _on_threads(m, fn):
    outs = [None] * m
    threads = [threading.Thread(target=lambda r=r: outs.__setitem__(r, fn(r)))
               for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def _cfg(heads, d):
    import dataclasses

    return dataclasses.replace(get_config("xlstm-125m").reduced(), n_heads=heads,
                               n_kv_heads=heads, d_model=d, mlstm_chunk=16)


def _params(cfg, seed):
    """Layer 0 (mLSTM) and layer 1 (sLSTM) of seed ``seed``'s weights, the
    gates' scales raised so that every leaf moves the output."""
    p = tx.init(seed, cfg, ParallelContext(device="cpu"))["blocks"]
    g = torch.Generator().manual_seed(seed + 1)
    for blk in p:
        for k, w in blk.items():
            if k not in ("norm", "bf", "bi"):
                blk[k] = w + 0.1 * torch.randn(w.shape, generator=g)
    return p


def _mlstm_block(p, cfg, r, m):
    """Rank r's mLSTM leaves as a model group of m holds them under TP use:
    the blocks of ``wv``/``wg``/``gate_norm``/``wo``, and of
    ``wq``/``wk``/``wi``/``wf`` where m divides the heads (else whole); the
    biases whole (replicated)."""
    d, H = cfg.d_model, cfg.n_heads
    c = d // m
    cols = slice(r * c, (r + 1) * c)
    out = dict(p, wv=p["wv"][:, cols], wg=p["wg"][:, cols], gate_norm=p["gate_norm"][cols],
               wo=p["wo"][cols])
    if H % m == 0:
        hq = H // m
        out.update(wq=p["wq"][:, cols], wk=p["wk"][:, cols],
                   wi=p["wi"][:, r * hq:(r + 1) * hq], wf=p["wf"][:, r * hq:(r + 1) * hq])
    return out


def _slstm_block(p, d, r, m):
    c = d // m
    cols = slice(r * c, (r + 1) * c)
    return dict(p, **{k: p[k][:, cols] for k in ("wz", "wi", "wf", "wo_gate")},
                down=p["down"][cols])


@pytest.mark.parametrize("heads,d,m", [(4, 128, 2), (4, 128, 4), (4, 128, 8), (1, 64, 2),
                                       (1, 64, 4), (2, 64, 8)])
@pytest.mark.parametrize("chunked", [True, False])
def test_mlstm_on_the_ranks_value_columns_equals_the_whole(heads, d, m, chunked):
    """Every rank's output is the whole layer's within 1e-5 (dv = d / m: whole
    heads, or dv < dk where the heads divide m); without the norm's group
    sum it is not."""
    cfg = _cfg(heads, d)
    p = _params(cfg, heads + d + m)[0]
    x = torch.randn(2, 37, d, generator=torch.Generator().manual_seed(m))
    fwd = (functools.partial(tx.mlstm_forward_chunked, chunk=16) if chunked
           else tx.mlstm_forward)
    want, _ = fwd(p, x, cfg)
    for kind, close in ((_Thread, True), (_NoNormSum, False)):
        group = _Threads(m)
        outs = _on_threads(m, lambda r: fwd(_mlstm_block(p, cfg, r, m), x, cfg,
                                            tp=kind(group, m, r))[0])
        for y in outs:
            err = float((y - want).abs().max() / want.abs().max())
            assert (err <= TOL) == close, (kind.__name__, err)


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("assoc", [True, False])
def test_slstm_on_the_ranks_channels_equals_the_whole(m, assoc):
    """The gates and scans on each rank's channels, ``h`` gathered, the GEGLU
    on its columns of each half of ``up``, ``down``'s output summed: every
    rank's output within 1e-5 of the whole layer's, and its final state the
    whole state's channels."""
    cfg = _cfg(4, 128)
    p = _params(cfg, m)[1]
    x = torch.randn(2, 37, 128, generator=torch.Generator().manual_seed(m))
    fwd = tx.slstm_forward_assoc if assoc else tx.slstm_forward
    want, wst = fwd(p, x, cfg)
    group = _Threads(m)
    outs = _on_threads(m, lambda r: fwd(_slstm_block(p, 128, r, m), x, cfg,
                                        tp=_Thread(group, m, r)))
    c = 128 // m
    for r, (y, st) in enumerate(outs):
        _close(y, want)
        for key in ("c", "n", "m", "h"):
            _close(st[key], wst[key][:, r * c:(r + 1) * c])


@pytest.mark.parametrize("heads,d,m", [(4, 128, 2), (1, 64, 4)])
def test_decode_on_the_ranks_states_equals_the_whole(heads, d, m):
    """Six decode steps of an mLSTM and an sLSTM layer, each rank from its
    own zero states (``init_mlstm_state``/``init_slstm_state`` with its
    ``tp``): each step's output within 1e-5 of the whole layer's, and the
    states the whole states' blocks (C by heads and value columns, n and m
    by heads, the sLSTM's by channels)."""
    cfg = _cfg(heads, d)
    pm, ps = _params(cfg, 11)
    xs = torch.randn(6, 2, 1, d, generator=torch.Generator().manual_seed(5))
    wm, ws = tx.init_mlstm_state(cfg, 2, "cpu"), tx.init_slstm_state(cfg, 2, "cpu")
    want = []
    for x in xs:
        ym, wm = tx.mlstm_forward(pm, x, cfg, state=wm)
        ys, ws = tx.slstm_forward(ps, x, cfg, state=ws)
        want.append((ym, ys))
    group = _Threads(m)

    def rank(r):
        tp = _Thread(group, m, r)
        sm, ss, out = tx.init_mlstm_state(cfg, 2, "cpu", tp), tx.init_slstm_state(
            cfg, 2, "cpu", tp), []
        for x in xs:
            ym, sm = tx.mlstm_forward(_mlstm_block(pm, cfg, r, m), x, cfg, state=sm, tp=tp)
            ys, ss = tx.slstm_forward(_slstm_block(ps, d, r, m), x, cfg, state=ss, tp=tp)
            out.append((ym, ys))
        return out, sm, ss

    dh = d // heads
    for r, (out, sm, ss) in enumerate(_on_threads(m, rank)):
        for (ym, ys), (wym, wys) in zip(out, want):
            _close(ym, wym)
            _close(ys, wys)
        h0, hq, p0, pc = value_columns(heads, dh, m, r)
        hs = slice(h0, h0 + hq)
        _close(sm["C"], wm["C"][:, hs, :, p0:p0 + pc])
        _close(sm["n"], wm["n"][:, hs])
        _close(sm["m"], wm["m"][:, hs])
        c = d // m
        for key in ("c", "n", "m", "h"):
            _close(ss[key], ws[key][:, r * c:(r + 1) * c])
