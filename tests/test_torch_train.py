"""The port's training path against the JAX package's, on the CPU, in float32.

One train step of the reduced paper-moe config (8 experts, top-2), with the
reference's weights carried over by ``params_from_jax`` and a batch from
``SyntheticLM``: the loss, ``grad_norm`` and every gradient leaf against
``repro.train.step.make_train_step`` on ``SINGLE`` (the reference's own
sharded EP step fails on this JAX, so its single-device step is the
oracle), for the port's EP=1 and its stacked EP=8 at a capacity that drops
nothing.  Both sides pin ``NIMBLE_FFN_IMPL=scan`` (both packages read it):
on the CPU the default ``dense`` FFN branch drops rows by capacity.  AdamW is held
against the reference's fed the reference's own gradients, since AdamW's
first step is sign-like and would amplify the gradients' float32 noise.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.registry import build_model as j_build_model
from repro.optim import adamw as j_adamw
from repro.sharding.context import SINGLE as J_SINGLE
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import make_eval_step, make_train_step
from repro_torch.tree import leaves, unflatten
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CPU = ParallelContext(device="cpu")
# f32 on both sides; products, softmax and the scatter-adds sum in other
# orders: 1e-4 of each gradient leaf's largest value, the loss to 1e-5
GRAD_TOL, LOSS_TOL = 1e-4, 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)


def _close(got, want, tol):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced paper-moe model, weights, one batch and its step."""
    jcfg = dataclasses.replace(j_get_config("paper-moe-8e").reduced(), n_experts=8, top_k=2)
    tcfg = dataclasses.replace(get_config("paper-moe-8e").reduced(), n_experts=8, top_k=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq_len=128, global_batch=2,
                                     seed=3)).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    old = os.environ.get("NIMBLE_FFN_IMPL")
    os.environ["NIMBLE_FFN_IMPL"] = "scan"
    try:
        loss, grads = jax.value_and_grad(lambda p: jmodel.loss(p, jbatch))(jparams)
        jstep = j_make_train_step(jmodel, j_adamw.AdamWConfig(**OPT))
        _, _, metrics = jstep(jparams, j_adamw.init(jparams), jbatch)
    finally:
        if old is None:
            os.environ.pop("NIMBLE_FFN_IMPL")
        else:
            os.environ["NIMBLE_FFN_IMPL"] = old
    return dict(tcfg=tcfg, jparams=jparams, tree=jax.tree.map(np.asarray, jparams),
                batch=batch, loss=float(loss), grads=[np.asarray(g) for g in
                                                       jax.tree.leaves(grads)],
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("ep", [1, 8])
def test_train_step_matches_jax_single(ref, ep, monkeypatch):
    monkeypatch.setenv("NIMBLE_FFN_IMPL", "scan")       # the pin ``ref`` puts on JAX
    cfg = ref["tcfg"]
    if ep > 1:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)    # drops nothing
    ctx = dataclasses.replace(CPU, ep_size=ep, group_size=min(4, ep))
    model = build_model(cfg, ctx)
    params = params_from_jax(ref["tree"], cfg, ctx)
    seen = {}
    orig = adamw.update

    def record(cfg_, params_, grads, state):
        seen["grads"] = [g.clone() for g in leaves(grads)]        # before clipping
        return orig(cfg_, params_, grads, state)

    monkeypatch.setattr(adamw, "update", record)
    step = make_train_step(model, adamw.AdamWConfig(**OPT))
    stats = {}
    _, state, metrics = step(params, adamw.init(params), to_device(ref["batch"], "cpu"),
                             stats=stats)
    assert int(stats["dropped"]) == 0 and state.step == 1
    assert abs(float(metrics["loss"]) - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    for key in ("loss", "grad_norm", "lr"):
        want = ref["metrics"][key]
        assert abs(float(metrics[key]) - want) <= LOSS_TOL * abs(want), key
    assert len(seen["grads"]) == len(ref["grads"])
    for got, want in zip(seen["grads"], ref["grads"]):
        _close(got.numpy(), want, GRAD_TOL)


def test_eval_step_is_the_loss(ref, monkeypatch):
    monkeypatch.setenv("NIMBLE_FFN_IMPL", "scan")       # the pin ``ref`` puts on JAX
    model = build_model(ref["tcfg"], CPU)
    params = params_from_jax(ref["tree"], ref["tcfg"], CPU)
    loss = make_eval_step(model)(params, to_device(ref["batch"], "cpu"))
    assert loss.grad_fn is None
    assert abs(float(loss) - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])


def test_adamw_update_matches_reference_on_its_gradients(ref):
    # three steps over warm-up and the cosine; f32 element-wise updates:
    # 1e-6 of each leaf's largest value (moments 1e-5)
    cfg = adamw.AdamWConfig(**OPT)
    jcfg = j_adamw.AdamWConfig(**OPT)
    jp, jstate = ref["jparams"], j_adamw.init(ref["jparams"])
    params = params_from_jax(ref["tree"], ref["tcfg"], CPU)
    state = adamw.init(params)
    jgrads = jax.tree.unflatten(jax.tree.structure(jp), [jnp.asarray(g) for g in ref["grads"]])
    for i, scale in enumerate((1.0, 0.5, 3.0)):
        g = jax.tree.map(lambda t: t * scale, jgrads)
        jp, jstate, jm = j_adamw.update(jcfg, jp, g, jstate)
        tg = unflatten(params, [torch.tensor(np.asarray(t)) for t in jax.tree.leaves(g)])
        params, state, m = adamw.update(cfg, params, tg, state)
        assert state.step == i + 1
        assert abs(m["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(
            jm["grad_norm"])
        for got, want in zip(leaves(params), jax.tree.leaves(jp)):
            _close(got.numpy(), np.asarray(want), 1e-6)
        for tree, jtree in ((state.m, jstate.m), (state.v, jstate.v)):
            for got, want in zip(leaves(tree), jax.tree.leaves(jtree)):
                assert got.dtype == torch.float32
                _close(got.numpy(), np.asarray(want), 1e-5)


def test_adamw_keeps_f32_moments_for_bf16_params():
    params = {"b": torch.ones(3, dtype=torch.bfloat16), "a": torch.zeros(2, 2)}
    state = adamw.init(params)
    assert [t.dtype for t in leaves(state.m)] == [torch.float32, torch.float32]
    grads = {"b": torch.full((3,), 0.5, dtype=torch.bfloat16), "a": torch.ones(2, 2)}
    params, state, _ = adamw.update(adamw.AdamWConfig(lr=0.1, warmup_steps=0), params, grads,
                                   state)
    assert params["b"].dtype == torch.bfloat16 and (params["b"] < 1).all()
    assert state.m["b"].dtype == torch.float32


@pytest.mark.parametrize("shapes", [[(4096, 4096)], [(8, 256, 1024), (4096,), (3,)]])
def test_global_norm_matches_reference_on_large_leaves(shapes):
    # leaves of millions of elements, f32 and bf16: the port's norm within
    # 1e-6 of a float64 sum's, and within 1e-5 of the reference's float32 sum
    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tree = {f"l{i}": torch.tensor(a) for i, a in enumerate(arrs)}
    tree["bf16"] = torch.tensor(arrs[0]).to(torch.bfloat16)
    exact = np.sqrt(sum(float(np.sum(np.square(t.float().numpy(), dtype=np.float64)))
                        for t in tree.values()))
    want = float(j_adamw.global_norm({k: jnp.asarray(t.float().numpy()) for k, t in tree.items()}))
    got = float(adamw.global_norm(tree))
    assert abs(got - exact) <= 1e-6 * exact
    assert abs(got - want) <= 1e-5 * want


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (20, 200), (100, 10_000)])
def test_schedule_matches_reference(warmup, total):
    cfg = adamw.AdamWConfig(warmup_steps=warmup, total_steps=total)
    jcfg = j_adamw.AdamWConfig(warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 2, warmup, warmup + 1, total // 2, total, total + 7):
        want = float(j_adamw.schedule(jcfg, jnp.int32(step)))
        assert abs(adamw.schedule(cfg, step) - want) <= 1e-6 * max(want, 1e-12), step


def test_tree_leaves_follow_jax_order(ref):
    params = params_from_jax(ref["tree"], ref["tcfg"], CPU)
    got = [tuple(t.shape) for t in leaves(params)]
    assert got == [tuple(np.shape(t)) for t in jax.tree.leaves(ref["tree"])]
    assert leaves(unflatten(params, leaves(params)))[3] is leaves(params)[3]


@pytest.mark.parametrize("seed,step,shard,n_shards", [(0, 0, 0, 1), (0, 5, 0, 1),
                                                      (7, 2, 1, 2), (3, 11, 3, 4)])
def test_synthetic_lm_batches_equal_reference_bit_for_bit(seed, step, shard, n_shards):
    kw = dict(vocab=4096, seq_len=64, global_batch=8, seed=seed, n_shards=n_shards,
              shard=shard)
    got = SyntheticLM(DataConfig(**kw)).batch(step)
    want = JSyntheticLM(JDataConfig(**kw)).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_train_launcher_on_cpu(capsys):
    from repro_torch.launch import train

    losses = train.main(["--arch", "paper-moe-8e", "--reduced", "--device", "cpu",
                         "--dtype", "f32", "--steps", "6", "--batch", "2", "--seq", "32",
                         "--log-every", "2", "--lr", "1e-3", "--warmup", "2"])
    out = capsys.readouterr().out
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert "[train] paper-moe-8e-smoke: 2L d=256 vocab=512 arch=moe" in out
    assert "[train] step     4 loss" in out and "[train] loss " in out
    with pytest.raises(SystemExit):                  # no experts to place
        train.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu", "--ep", "2"])


def test_example_trains_moe_with_nimble_on_cpu():
    # the port's counterpart of the reference's test_train_moe_nimble_short
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.examples.train_moe_nimble",
                        "--steps", "25", "--device", "cpu", "--seq", "32"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "(improved)" in r.stdout
