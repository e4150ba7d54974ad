"""xlstm-125m training in the port against the JAX package, on the CPU, in float32.

* The sLSTM prefix scans' autograd Functions against ``jax.vjp`` of the
  reference's custom-VJP ``linear_prefix`` and ``maxplus_prefix``
  (``models/xlstm.py:254-330``), with a ``maxplus`` case full of exact ties
  that pins the carry selection's ``>=``.
* The chunk body's cumulative max against ``jax.grad`` of ``lax.cummax``:
  a tie's gradient split in halves down the associative scan's tree, exact
  on a seeded sweep of tie-heavy inputs, and through the chunked scan's VJP.
* ``MLSTMScanFunction`` (the backward the card runs after the kernel's
  forward, here over the plain chunk loop's states) against ``jax.vjp`` of
  the reference's chunked mLSTM scan: the ``lax.scan`` over
  ``_mlstm_chunk_body`` of ``mlstm_forward_chunked``, with a carried state
  and without, at an S that is not a multiple of the chunk.
* One train step of reduced xlstm-125m (an mLSTM and an sLSTM layer, chunk
  16, S 40): loss, ``grad_norm``, ``lr`` and every gradient leaf against the
  reference's single-device step, with the mLSTM scan through the CPU's
  plain version and through the Function.
* The training launcher on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import xlstm as jx
from repro.models.registry import build_model as j_build_model
from repro.optim import adamw as j_adamw
from repro.sharding.context import SINGLE as J_SINGLE
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.kernels.mlstm_scan import ops as ms_ops
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan_function
from repro_torch.models import xlstm as tx
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

CPU = ParallelContext(device="cpu")
# f32 on both sides; the scans group their sums in other orders (doubling vs
# associative_scan; the chunk body's einsums): the prefixes' gradients to
# 1e-5 of each one's largest value, the mLSTM scan's to 1e-4, the train
# step's loss to 1e-5 and its gradient leaves to 1e-4
PREFIX_TOL, SCAN_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 1e-4, 1e-4, 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


def _vjp_pair(j_fn, t_fn, args, g):
    """(port's gradients, reference's) of fn(*args) for the cotangent g."""
    out, vjp = jax.vjp(jax.jit(j_fn), *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    live = [torch.tensor(a, requires_grad=True) for a in args]
    y = t_fn(*live)
    _close(y, out, PREFIX_TOL)
    return torch.autograd.grad(y, live, torch.tensor(g)), want


# --------------------------------------------------------------------------- #
# the sLSTM prefix scans' adjoints
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(2, 37, 5), (1, 64, 3), (3, 1, 4)])
def test_linear_prefix_vjp_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0.2, 1.0, size=shape).astype(np.float32)     # decays
    u = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    got, want = _vjp_pair(jx.linear_prefix, tx.linear_prefix, (a, u), g)
    for gt, wt in zip(got, want):
        _close(gt, wt, PREFIX_TOL)


@pytest.mark.parametrize("shape", [(2, 37, 5), (1, 64, 3)])
def test_maxplus_prefix_vjp_matches_reference(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    s = -rng.uniform(0.0, 0.5, size=shape).astype(np.float32)    # log forget gates
    v = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    got, want = _vjp_pair(jx.maxplus_prefix, tx.maxplus_prefix, (s, v), g)
    for gt, wt in zip(got, want):
        _close(gt, wt, PREFIX_TOL)


def test_maxplus_prefix_vjp_ties_select_the_carry():
    # halves: every sum is exact, so both scans give the same m and the same
    # cotangent sums, and many steps tie (m_{t-1} + s_t == v_t), where >=
    # selects the carry: autograd through torch.maximum would split the
    # cotangent there instead
    rng = np.random.default_rng(5)
    s, v, g = ((rng.integers(lo, hi, size=(2, 48, 4)) / 2).astype(np.float32)
               for lo, hi in ((-2, 1), (-2, 3), (-4, 5)))
    m = np.asarray(jx.maxplus_prefix(jnp.asarray(s), jnp.asarray(v)))
    m_prev = np.concatenate([np.full_like(m[:, :1], -np.inf), m[:, :-1]], axis=1)
    assert (m_prev + s == v).sum() >= 10
    got, want = _vjp_pair(jx.maxplus_prefix, tx.maxplus_prefix, (s, v), g)
    for gt, wt in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def _cummax_grads(g, ct):
    """(port's, reference's) gradient of sum(cummax(g) * ct) along the last axis."""
    want = jax.grad(lambda x: jnp.sum(jax.lax.cummax(x, axis=x.ndim - 1) * ct))(
        jnp.asarray(g))
    x = torch.tensor(g, requires_grad=True)
    y = ms_ops._cummax(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  torch.cummax(x.detach(), dim=-1).values.numpy())
    (got,) = torch.autograd.grad(y, x, torch.tensor(ct))
    return got.numpy(), np.asarray(want)


def test_chunk_cummax_splits_a_tie_as_jax_does():
    # three tied maxima: JAX halves the gradient down its scan's tree; the
    # latest-argmax rule would give [1, 5, 0, 9, 0, 6]
    g = np.array([[[1, 3, 2, 3, 0.5, 3]]], np.float32)
    ct = np.arange(1, 7, dtype=np.float32)[None, None]
    got, want = _cummax_grads(g, ct)
    np.testing.assert_array_equal(want[0, 0], [1, 11, 0, 6, 0, 3])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 12, 16, 17, 31, 33, 48, 64, 69])
def test_chunk_cummax_gradient_equals_jax_on_ties(n):
    # 64 rows of values from {0, 1, 2, 3}: ties everywhere, at lengths that
    # take each branch of the recursion (odd and even at every level); the
    # gradients are sums of halves of the cotangents and must be equal exactly
    rng = np.random.default_rng(100 + n)
    g = rng.integers(0, 4, size=(4, 16, n)).astype(np.float32)
    ct = rng.normal(size=(4, 16, n)).astype(np.float32)
    got, want = _cummax_grads(g, ct)
    np.testing.assert_array_equal(got, want)


def test_chunk_body_vjp_on_tied_gates_matches_reference():
    # lf = 0 and integer input gates: g = ig ties within each chunk.  h does
    # not depend on the stabilizer u where |n.q| wins its max, but the final
    # m = Lf_L + u_L does: its cotangent reaches the tied gates
    b, h, s, dh, chunk = 2, 2, 32, 8, 16
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(b, h, s, dh)).astype(np.float32) * 0.3 for _ in range(3))
    ig = rng.integers(-1, 2, size=(b, h, s)).astype(np.float32)
    lf = np.zeros((b, h, s), np.float32)
    st = [np.zeros((b, h, dh, dh), np.float32), np.zeros((b, h, dh), np.float32),
          np.full((b, h), -30.0, np.float32)]
    cots = [rng.normal(size=(b, h, s, dh)).astype(np.float32),
            rng.normal(size=(b, h, dh, dh)).astype(np.float32),
            rng.normal(size=(b, h, dh)).astype(np.float32),
            rng.normal(size=(b, h)).astype(np.float32)]
    ins = [q, k, v, ig, lf]

    def j_scan(*a):
        return _j_chunked_scan(*a, *(jnp.asarray(x) for x in st), chunk=chunk)

    _, vjp = jax.vjp(jax.jit(j_scan), *(jnp.asarray(a) for a in ins))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    live = [torch.tensor(a, requires_grad=True) for a in ins]
    hh, fin = mlstm_scan_function(*live, chunk=chunk)
    got = torch.autograd.grad((hh, fin["C"], fin["n"], fin["m"]), live,
                              [torch.tensor(c) for c in cots])
    for a, w in zip(got, want):
        _close(a, w, SCAN_TOL)


# --------------------------------------------------------------------------- #
# the mLSTM scan's backward
# --------------------------------------------------------------------------- #


def _j_chunked_scan(q, k, v, ig, lf, C, n, m, *, chunk):
    """The reference's chunked mLSTM scan (``mlstm_forward_chunked``, xlstm.py
    :178-201) on the port's layout, q [B, H, S, dh] -> (h, C, n, m)."""
    q, k, v = (a.transpose(0, 2, 1, 3) for a in (q, k, v))      # [B, S, H, dh]
    ig, lf = ig.transpose(0, 2, 1), lf.transpose(0, 2, 1)
    B_, S, H, dh = q.shape
    Lc = min(chunk, S)
    nc = -(-S // Lc)
    pad = nc * Lc - S
    if pad:
        q, k, v = (jnp.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0))) for a in (q, k, v))
        ig = jnp.pad(ig, ((0, 0), (0, pad), (0, 0)), constant_values=-1e30)
        lf = jnp.pad(lf, ((0, 0), (0, pad), (0, 0)))
    rc = lambda a: a.reshape((B_, nc, Lc) + a.shape[2:]).transpose(  # noqa: E731
        (1, 0, 2) + tuple(range(3, a.ndim + 1)))
    st, ys = jax.lax.scan(functools.partial(jx._mlstm_chunk_body, L=Lc),
                          {"C": C, "n": n, "m": m}, (rc(q), rc(k), rc(v), rc(ig), rc(lf)))
    y = ys.transpose(1, 0, 2, 3, 4).reshape(B_, nc * Lc, H, dh)[:, :S]
    return y.transpose(0, 2, 1, 3), st["C"], st["n"], st["m"]


def _scan_inputs(rng, b, h, s, dh):
    q, k, v = (rng.normal(size=(b, h, s, dh)).astype(np.float32) * 0.3 for _ in range(3))
    ig = (rng.normal(size=(b, h, s)) * 0.5).astype(np.float32)
    lf = np.log(1.0 / (1.0 + np.exp(-(rng.normal(size=(b, h, s)) + 2.0)))).astype(np.float32)
    return [q, k, v, ig, lf]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(40, 16), (21, 8)])
def test_mlstm_scan_function_vjp_matches_reference(with_state, s, chunk):
    b, h, dh = 2, 2, 8
    rng = np.random.default_rng(s + chunk + with_state)
    ins = _scan_inputs(rng, b, h, s, dh)
    if with_state:
        st = [(rng.normal(size=(b, h, dh, dh)) * 0.2).astype(np.float32),
              (rng.normal(size=(b, h, dh)) * 0.2).astype(np.float32),
              rng.normal(size=(b, h)).astype(np.float32)]
    else:
        st = [np.zeros((b, h, dh, dh), np.float32), np.zeros((b, h, dh), np.float32),
              np.full((b, h), -30.0, np.float32)]
    cots = [rng.normal(size=(b, h, s, dh)).astype(np.float32),
            rng.normal(size=(b, h, dh, dh)).astype(np.float32),
            rng.normal(size=(b, h, dh)).astype(np.float32),
            rng.normal(size=(b, h)).astype(np.float32)]
    outs, vjp = jax.vjp(jax.jit(functools.partial(_j_chunked_scan, chunk=chunk)),
                        *(jnp.asarray(a) for a in ins + st))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    live = [torch.tensor(a, requires_grad=True) for a in ins + st]
    state = dict(zip(("C", "n", "m"), live[5:])) if with_state else None
    hh, fin = mlstm_scan_function(*live[:5], chunk=chunk, state=state)
    got_out = (hh, fin["C"], fin["n"], fin["m"])
    for a, w in zip(got_out, outs):
        _close(a, w, SCAN_TOL)
    wrt = live if with_state else live[:5]
    got = torch.autograd.grad(got_out, wrt, [torch.tensor(c) for c in cots])
    for a, w in zip(got, want):
        assert float(a.abs().max()) > 0
        _close(a, w, SCAN_TOL)


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def ref():
    """Reduced xlstm-125m (mLSTM then sLSTM, chunk 16), one S = 40 batch and
    the reference's single-device step."""
    kw = dict(mlstm_chunk=16)
    jcfg = dataclasses.replace(j_get_config("xlstm-125m").reduced(n_layers=2), **kw)
    tcfg = dataclasses.replace(get_config("xlstm-125m").reduced(n_layers=2), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert [jx.is_slstm_layer(jcfg, i) for i in range(2)] == [False, True]
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq_len=40, global_batch=2,
                                     seed=3)).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, jbatch)))(jparams)
    _, _, metrics = jax.jit(j_make_train_step(jmodel, j_adamw.AdamWConfig(**OPT)))(
        jparams, j_adamw.init(jparams), jbatch)
    return dict(tcfg=tcfg, tree=jax.tree.map(np.asarray, jparams), batch=batch,
                loss=float(loss), grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("scan", ["plain", "function"])
def test_xlstm_train_step_matches_jax_single(ref, scan, monkeypatch):
    if scan == "function":
        monkeypatch.setattr(tx, "mlstm_scan", mlstm_scan_function)
    cfg = ref["tcfg"]
    model = build_model(cfg, CPU)
    params = params_from_jax(ref["tree"], cfg, CPU)
    seen = {}
    orig = adamw.update

    def record(cfg_, params_, grads, state):
        seen["grads"] = [g.clone() for g in leaves(grads)]        # before clipping
        return orig(cfg_, params_, grads, state)

    monkeypatch.setattr(adamw, "update", record)
    _, state, metrics = make_train_step(model, adamw.AdamWConfig(**OPT))(
        params, adamw.init(params), to_device(ref["batch"], "cpu"))
    assert state.step == 1
    for key in ("loss", "grad_norm", "lr"):
        want = ref["metrics"][key]
        assert abs(float(metrics[key]) - want) <= LOSS_TOL * abs(want), key
    assert len(seen["grads"]) == len(ref["grads"])
    for got, want in zip(seen["grads"], ref["grads"]):
        assert got.dtype == torch.float32
        _close(got, want, GRAD_TOL)


def test_train_launcher_trains_xlstm_on_cpu(capsys):
    from repro_torch.launch import train

    losses = train.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
                         "--dtype", "f32", "--steps", "12", "--batch", "2", "--seq", "48",
                         "--log-every", "4", "--lr", "1e-3", "--warmup", "2"])
    out = capsys.readouterr().out
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert "[train] xlstm-125m-smoke: 2L d=256 vocab=512 arch=ssm" in out
    assert "[train] ep=1 groups of 1" in out and "(improved)" in out
