"""The port's dense family against the JAX package, on the CPU, in float32.

For each of smollm-135m, tinyllama-1.1b, llama3-8b and qwen2.5-14b, reduced
(2 layers, d 256, 4 heads of 64), with the reference's weights carried over
by ``params_from_jax`` (qwen2.5's QKV biases set to random values, so the
bias is applied): the forward logits (S 130, past the flash dispatch's 128),
``last_only``, the decode steps against the reference's and against the
forward, and one train step's loss, ``grad_norm``, ``lr`` and every gradient
leaf against the reference's single-device step.  Also the sliding window
(the reference's ``test_sliding_window_matches_windowed_forward``),
activation recomputation (``ParallelContext.remat``) and the launcher.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import dense as jdense
from repro.models.registry import build_model as j_build_model
from repro.optim import adamw as j_adamw
from repro.sharding.context import SINGLE as J_SINGLE
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.models import dense
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import loss_and_grads, make_train_step
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

CPU = ParallelContext(device="cpu")
ARCHS = ["smollm-135m", "tinyllama-1.1b", "llama3-8b", "qwen2.5-14b"]
# f32 on both sides, sums in other orders: logits to 1e-4 of their largest
# value; the train step's loss to 1e-5 and its gradient leaves to 1e-4; the
# decode steps against the forward to the reference's own 1e-3
LOGIT_TOL, LOSS_TOL, GRAD_TOL, DECODE_TOL = 1e-4, 1e-5, 1e-4, 1e-3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    jcfg = j_get_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if jcfg.qkv_bias:                     # the reference inits them to zeros
        rng = np.random.default_rng(1)
        attn = dict(jparams["blocks"]["attn"])
        for key in ("bq", "bk", "bv"):
            attn[key] = jnp.asarray(rng.normal(size=attn[key].shape).astype(np.float32))
        jparams["blocks"] = dict(jparams["blocks"], attn=attn)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, (2, 130)).astype(np.int32)
    jlogits, _ = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    batch = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq_len=130, global_batch=2,
                                     seed=3)).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, jbatch)))(jparams)
    _, _, metrics = jax.jit(j_make_train_step(jmodel, j_adamw.AdamWConfig(**OPT)))(
        jparams, j_adamw.init(jparams), jbatch)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams,
                tree=jax.tree.map(np.asarray, jparams), tokens=tokens,
                jlogits=np.asarray(jlogits), batch=batch, loss=float(loss),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                metrics={k: float(v) for k, v in metrics.items()})


def _port(ref, ctx=CPU):
    return build_model(ref["tcfg"], ctx), params_from_jax(ref["tree"], ref["tcfg"], ctx)


def test_params_carry_the_reference_tree(ref):
    model, params = _port(ref)
    got = [tuple(t.shape) for t in leaves(params)]
    assert got == [tuple(np.shape(t)) for t in jax.tree.leaves(ref["tree"])]
    assert ("bq" in params["blocks"]["attn"]) == ref["tcfg"].qkv_bias
    fresh = model.init(0)
    assert [tuple(t.shape) for t in leaves(fresh)] == got
    for a, b in zip(leaves(params), leaves(ref["tree"])):
        np.testing.assert_array_equal(a.numpy(), b)


def test_forward_matches_jax(ref):
    model, params = _port(ref)
    tokens = torch.as_tensor(ref["tokens"]).long()
    with torch.no_grad():
        logits, aux = model.forward(params, {"tokens": tokens})
        last, _ = model.forward(params, {"tokens": tokens}, last_only=True)
    assert float(aux) == 0.0
    _close(logits, ref["jlogits"], LOGIT_TOL)
    assert tuple(last.shape) == (2, 1, ref["tcfg"].vocab)
    _close(last, ref["jlogits"][:, -1:], LOGIT_TOL)


def test_decode_matches_reference_and_forward(ref):
    model, params = _port(ref)
    jcfg, cfg, S = ref["jcfg"], ref["tcfg"], 12
    toks = ref["tokens"][:, :S]
    cache = dense.init_cache(cfg, 2, S, CPU)
    jcache = jdense.init_cache(jcfg, 2, S)
    jstep = jax.jit(lambda p, c, t, i: jdense.decode_step(p, c, t, i, jcfg))
    got, want = [], []
    with torch.no_grad():
        for i in range(S):
            lg, cache = model.decode_step(params, cache, torch.as_tensor(toks[:, i]).long(), i)
            jlg, jcache = jstep(ref["jparams"], jcache, jnp.asarray(toks[:, i]), jnp.int32(i))
            got.append(lg)
            want.append(np.asarray(jlg))
        full, _ = model.forward(params, {"tokens": torch.as_tensor(toks).long()})
    _close(torch.stack(got, 1), np.stack(want, 1), LOGIT_TOL)
    _close(torch.stack(got, 1), full.numpy(), DECODE_TOL)


def test_train_step_matches_jax_single(ref, monkeypatch):
    model, params = _port(ref)
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
    assert abs(float(metrics["loss"]) - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    assert len(seen["grads"]) == len(ref["grads"])
    for got, want in zip(seen["grads"], ref["grads"]):
        _close(got, want, GRAD_TOL)


def test_sliding_window_matches_windowed_forward():
    # the reference's test_sliding_window_matches_windowed_forward, and the
    # port's windowed forward against the reference's
    jcfg, cfg = j_get_config("smollm-135m").reduced(), get_config("smollm-135m").reduced()
    jparams = j_build_model(jcfg, J_SINGLE).init(jax.random.PRNGKey(2))
    model = build_model(cfg, CPU)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    S, W = 16, 4
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, S)).astype(np.int32)
    jfull, _ = j_build_model(jcfg, J_SINGLE).forward(jparams, {"tokens": jnp.asarray(toks)},
                                                     window=W)
    cache = dense.init_cache(cfg, 1, W, CPU)
    outs = []
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": torch.as_tensor(toks).long()}, window=W)
        for i in range(S):
            lg, cache = dense.decode_step(params, cache, torch.as_tensor(toks[:, i]).long(),
                                          i, cfg, CPU)
            outs.append(lg)
    _close(full, np.asarray(jfull), LOGIT_TOL)
    _close(torch.stack(outs, 1), full.numpy(), DECODE_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "paper-moe-8e"])
def test_remat_recomputes_to_the_same_gradients(arch):
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=8, moe_capacity_factor=8.0)
    batch = to_device(JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                                               seed=5)).batch(0), "cpu")
    ctx = dataclasses.replace(CPU, ep_size=8 if cfg.n_experts else 1)
    params = build_model(cfg, ctx).init(0)
    out = [loss_and_grads(build_model(cfg, dataclasses.replace(ctx, remat=remat)), params,
                          batch) for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(leaves(out[0][1]), leaves(out[1][1])):
        assert torch.equal(a, b)


def test_train_launcher_trains_smollm_on_cpu(capsys):
    from repro_torch.launch import train

    losses = train.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                         "--dtype", "f32", "--steps", "12", "--batch", "2", "--seq", "48",
                         "--log-every", "4", "--lr", "1e-3", "--warmup", "2"])
    out = capsys.readouterr().out
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert "[train] smollm-135m-smoke: 2L d=256 vocab=512 arch=dense" in out
    assert "(improved)" in out
    with pytest.raises(SystemExit):                  # no experts to place
        train.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--ep", "2"])
