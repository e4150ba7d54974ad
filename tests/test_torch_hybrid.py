"""The port's zamba2 family (Mamba2 blocks + a shared attention block) against
the JAX package, on the CPU, in float32.

Same seeded numpy inputs, or the reference's weights carried over by
``params_from_jax``, through ``repro.models.ssm``/``hybrid`` and the port's
``models/ssm.py``/``hybrid.py``:

* ``_causal_conv`` with and without a carried state, ``_ssd_chunked`` at
  S 12, 128 and 200 (both padded cases and an exact one), and one Mamba2
  block's ``mamba_forward`` and ``mamba_decode``: 1e-5 of max(1, the
  largest value);
* the reduced hybrid's forward logits and ``last_only`` (1e-5 at S 12, 1e-4
  at S 200), its decode steps and ``Model.loss`` (1e-5), every gradient leaf of the loss (1e-4 of each
  leaf's largest value), and decode against the forward (the reference's
  own 1e-3, ``tests/test_models.py``);
* the layer schedule, activation recomputation, a checkpoint round trip
  and the launchers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm
from repro.models.registry import build_model as j_build_model
from repro.sharding.context import SINGLE as J_SINGLE
from repro_torch.configs.base import InputShape, get_config
from repro_torch.data.pipeline import to_device
from repro_torch.models import hybrid, ssm
from repro_torch.models.registry import build_model
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

CPU = ParallelContext(device="cpu")
# f32 on both sides, sums in other orders: the pieces and the forward to
# 1e-5 of max(1, their largest value) (an SSD output of magnitude 20 sums
# terms of magnitude 100 over a chunk: both packages are 3e-5 to 1.2e-4 off
# a float64 evaluation there, elementwise); gradient leaves to 1e-4 of each
# one's largest value; decode against the forward to the reference's 1e-3.
# The logits at S 200 (two chunks of the SSD, then rms_norm and out_proj) to
# the dense family's 1e-4 of the largest logit: there one block's output is
# 1.8e-4 off the reference's at magnitude 4.4, from the SSD's rounding alone
TOL, GRAD_TOL, DECODE_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-3, 1e-4


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    if not want.size:
        return
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


def _rel_close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


def _cfgs(**kw):
    j = dataclasses.replace(j_get_config("zamba2-1.2b").reduced(), **kw)
    t = dataclasses.replace(get_config("zamba2-1.2b").reduced(), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


# --------------------------------------------------------------------------- #
# the Mamba2 pieces
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("k", [4, 1])
def test_causal_conv_matches_reference(with_state, k):
    rng = np.random.default_rng(k + 10 * with_state)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(k, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    st = rng.normal(size=(2, k - 1, 6)).astype(np.float32) if with_state else None
    jy, jst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    ty, tst = ssm._causal_conv(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                               None if st is None else torch.as_tensor(st))
    _close(ty, jy)
    _close(tst, jst)


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    B = rng.normal(size=(b, s, h, n)).astype(np.float32)
    C = rng.normal(size=(b, s, h, n)).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    D = rng.normal(size=(h,)).astype(np.float32)
    return [x, dt, B, C, A, D]


@pytest.mark.parametrize("s,chunk", [(12, 128), (128, 128), (200, 128), (70, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(s + chunk)
    ins = _ssd_inputs(rng, 2, s, 3, 8, 4)
    want = jax.jit(jssm._ssd_chunked, static_argnames="chunk")(
        *(jnp.asarray(a) for a in ins), chunk=chunk)
    got = ssm._ssd_chunked(*(torch.as_tensor(a) for a in ins), chunk=chunk)
    _close(got, want)


def test_ssd_chunked_gradients_are_finite_and_match_reference():
    # the mask before exp: the non-causal entries' gradient is 0, not NaN
    rng = np.random.default_rng(3)
    ins = _ssd_inputs(rng, 1, 40, 2, 4, 4)
    g = rng.normal(size=(1, 40, 2, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jssm._ssd_chunked(*a, chunk=16), *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(g))
    live = [torch.tensor(a, requires_grad=True) for a in ins]
    got = torch.autograd.grad(ssm._ssd_chunked(*live, chunk=16), live, torch.as_tensor(g))
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        _rel_close(a, w, GRAD_TOL)


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, jssm.init_mamba_block(jax.random.PRNGKey(4), jcfg,
                                                       jnp.float32))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == ssm.mamba_shapes(tcfg)
    return jcfg, tcfg, p, tp


@pytest.mark.parametrize("s", [12, 200])
def test_mamba_forward_matches_reference(block, s):
    jcfg, tcfg, p, tp = block
    x = np.random.default_rng(s).normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jssm.mamba_forward(p, x, jcfg))(p, jnp.asarray(x))
    _close(ssm.mamba_forward(tp, torch.as_tensor(x), tcfg), want)


def test_mamba_decode_matches_reference(block):
    jcfg, tcfg, p, tp = block
    rng = np.random.default_rng(6)
    jc = jssm.init_mamba_cache(jcfg, 2, jnp.float32)
    tc = ssm.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    step = jax.jit(lambda p, x, c: jssm.mamba_decode(p, x, c, jcfg))
    for _ in range(4):
        x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        jy, jc = step(p, jnp.asarray(x), jc)
        ty, tc = ssm.mamba_decode(tp, torch.as_tensor(x), tc, tcfg)
        _close(ty, jy)
        for k in ("conv", "ssm"):
            _close(tc[k], jc[k])


# --------------------------------------------------------------------------- #
# the hybrid model
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=[dict(), dict(attn_every=2, n_layers=4)],
                ids=["reduced", "attn_every2"])
def model(request):
    jcfg, tcfg = _cfgs(**request.param)
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jparams)
    tmodel = build_model(tcfg, CPU)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tree=tree,
                tmodel=tmodel, params=params_from_jax(tree, tcfg, CPU))


def test_layer_schedule_matches_reference(model):
    for n, every in ((38, 6), (4, 2), (2, 2), (7, 3), (5, 1)):
        jc = dataclasses.replace(model["jcfg"], n_layers=n, attn_every=every)
        tc = dataclasses.replace(model["tcfg"], n_layers=n, attn_every=every)
        assert hybrid.layer_schedule(tc) == jhybrid.layer_schedule(jc)
        assert hybrid.n_mamba_layers(tc) == jhybrid.n_mamba_layers(jc)
    full = get_config("zamba2-1.2b")
    assert hybrid.n_mamba_layers(full) == 32 and hybrid.n_attn_calls(full) == 6


def test_f32_leaves_stay_f32(model):
    ctx = dataclasses.replace(CPU, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    p = params_from_jax(model["tree"], model["tcfg"], ctx)
    assert {k for k, v in p["mamba"].items() if v.dtype == torch.float32} == {
        "A_log", "D", "dt_bias"}
    p = build_model(model["tcfg"], ctx).init(0)
    assert p["mamba"]["A_log"].dtype == torch.float32
    assert p["mamba"]["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("s,tol", [(12, TOL), (200, LOGIT_TOL)])
def test_forward_matches_reference(model, s, tol):
    tok = np.random.default_rng(s).integers(0, model["jcfg"].vocab, (2, s)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: model["jmodel"].forward(p, {"tokens": t}))(
        model["jparams"], jnp.asarray(tok))
    got, aux = model["tmodel"].forward(model["params"], {"tokens": torch.as_tensor(tok)})
    _close(got, want, tol)
    assert float(aux) == 0.0
    last, _ = model["tmodel"].forward(model["params"], {"tokens": torch.as_tensor(tok)},
                                      last_only=True)
    _close(last, np.asarray(want)[:, -1:], tol)


def test_decode_steps_match_reference_and_forward(model):
    S = 12
    tok = np.random.default_rng(7).integers(0, model["jcfg"].vocab, (2, S)).astype(np.int32)
    shape = InputShape("decode_32k", 32768, 128, "decode")
    jcache = model["jmodel"].init_cache(2, shape)
    tcache = model["tmodel"].init_cache(2, shape)
    step = jax.jit(model["jmodel"].decode_step)
    outs = []
    for i in range(S):
        jl, jcache = step(model["jparams"], jcache, jnp.asarray(tok[:, i]), jnp.int32(i))
        tl, tcache = model["tmodel"].decode_step(model["params"], tcache,
                                                 torch.as_tensor(tok[:, i]), i)
        _close(tl, jl)
        outs.append(tl)
    for k in ("conv", "ssm"):
        _close(tcache["mamba"][k], jcache["mamba"][k])
    full, _ = model["tmodel"].forward(model["params"], {"tokens": torch.as_tensor(tok)})
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=DECODE_TOL, rtol=DECODE_TOL)


def test_loss_and_gradients_match_reference(model):
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, model["jcfg"].vocab, (2, 40)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: model["jmodel"].loss(p, jb)))(model["jparams"])
    loss, grads = loss_and_grads(model["tmodel"], model["params"], to_device(batch, "cpu"))
    _close(loss, jloss)
    for g, w in zip(leaves(grads), jax.tree.leaves(jgrads)):
        _rel_close(g, w, GRAD_TOL)


def test_remat_gives_the_same_gradients(model):
    rng = np.random.default_rng(9)
    batch = to_device({k: rng.integers(0, model["tcfg"].vocab, (2, 24)).astype(np.int32)
                       for k in ("tokens", "labels")}, "cpu")
    _, g0 = loss_and_grads(model["tmodel"], model["params"], batch)
    remat = build_model(model["tcfg"], dataclasses.replace(CPU, remat=True))
    _, g1 = loss_and_grads(remat, model["params"], batch)
    for a, b in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_checkpoint_round_trip(model, tmp_path):
    from repro_torch.checkpoint import ckpt

    ckpt.save(str(tmp_path), 3, model["params"])
    got, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 3
    for a, b in zip(leaves(model["params"]), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_launcher_trains_zamba2_on_cpu(capsys):
    from repro_torch.launch import train

    losses = train.main(["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu",
                         "--dtype", "f32", "--steps", "8", "--batch", "2", "--seq", "32",
                         "--log-every", "4", "--remat"])
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert "arch=hybrid" in capsys.readouterr().out


def test_serve_launcher_serves_zamba2_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "zamba2-1.2b", "--reduced", "--dtype", "f32",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "3",
                      "--new-tokens", "2"])
    assert out.shape == (2, 2)
    assert "zamba2-1.2b-smoke ep=1 on cpu" in capsys.readouterr().out
