"""Port's paper-moe-8e (reduced) against the JAX package's single-device path.

The JAX model is initialized from a PRNG key; its parameter tree is carried
into the port with ``params_from_jax``.  Both run in float32 on the CPU.
The reference's shard_map EP path is not used as the oracle: the port's
stacked EP=8 forward is held against JAX's single-device forward, which it
must equal up to float32 summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as j_get_config
from repro.models.registry import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.context import SINGLE as J_SINGLE
from repro_torch.configs.base import InputShape, get_config
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding.context import ParallelContext
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

# f32 on both sides; matmuls and softmax sum in other orders: logits agree
# to 1e-4 absolute (they are O(1))
TOL = 1e-4
CPU = ParallelContext(device="cpu")


def _cfgs():
    # as repro/launch/selftest.py:104-107: the reduced config with 8 experts
    j = dataclasses.replace(j_get_config("paper-moe-8e").reduced(), n_experts=8,
                            top_k=2)
    t = dataclasses.replace(get_config("paper-moe-8e").reduced(), n_experts=8,
                            top_k=2)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, size=(2, 16)).astype(np.int32)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tree=tree,
                tokens=tokens, jlogits=np.asarray(jlogits))


def _port(setup, ctx):
    model = build_model(setup["tcfg"], ctx)
    return model, params_from_jax(setup["tree"], setup["tcfg"], ctx)


def test_single_forward_matches_jax(setup):
    model, params = _port(setup, CPU)
    logits, aux = model.forward(params, {"tokens": torch.as_tensor(setup["tokens"])})
    assert logits.shape == setup["jlogits"].shape
    np.testing.assert_allclose(logits.numpy(), setup["jlogits"], atol=TOL, rtol=0)
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("mode", ["nimble", "direct", "stripe"])
def test_ep8_forward_matches_jax_single(setup, mode):
    ctx = dataclasses.replace(CPU, ep_size=8, group_size=4, moe_mode=mode)
    model, params = _port(setup, ctx)
    stats = {}
    logits, _ = model.forward(params, {"tokens": torch.as_tensor(setup["tokens"])},
                              stats=stats)
    assert int(stats["dropped"]) == 0
    np.testing.assert_allclose(logits.numpy(), setup["jlogits"], atol=TOL, rtol=0)


def test_last_only(setup):
    ctx = dataclasses.replace(CPU, ep_size=8, group_size=4)
    model, params = _port(setup, ctx)
    tok = torch.as_tensor(setup["tokens"])
    full, _ = model.forward(params, {"tokens": tok})
    last, _ = model.forward(params, {"tokens": tok}, last_only=True)
    assert last.shape == (2, 1, setup["tcfg"].vocab)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(), atol=1e-6, rtol=0)
    jlast, _ = setup["jmodel"].forward(
        setup["jparams"], {"tokens": jnp.asarray(setup["tokens"])}, last_only=True)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=TOL, rtol=0)


@pytest.mark.parametrize("ep", [1, 8])
def test_generate_greedy_matches_jax(setup, ep):
    # 2 requests: the EP decode step takes the replicated-token branch
    P, n_new = 6, 5
    prompts = setup["tokens"][:, :P]
    jeng = JServeEngine(setup["jmodel"], setup["jparams"], max_len=P + n_new)
    want = jeng.generate(prompts, n_new=n_new)
    ctx = dataclasses.replace(CPU, ep_size=ep, group_size=min(ep, 4))
    model, params = _port(setup, ctx)
    eng = ServeEngine(model, params, max_len=P + n_new)
    stats = {}
    got = eng.generate(prompts, n_new=n_new, stats=stats)
    np.testing.assert_array_equal(got, want)
    assert int(stats["dropped"]) == 0
    # last prefill logits, against the reference's prefill scan
    jcache = setup["jmodel"].init_cache(2, JInputShape("s", P + n_new, 2, "decode"))
    jl, _ = jeng._prefill(setup["jparams"], jcache, jnp.asarray(prompts))
    tl, _ = eng.prefill(model.init_cache(2, InputShape("s", P + n_new, 2, "decode")),
                        torch.as_tensor(prompts, dtype=torch.int64))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)


def test_params_from_jax_checks_the_tree(setup):
    bad = dict(setup["tree"])
    bad.pop("lm_head")
    with pytest.raises(ValueError):
        params_from_jax(bad, setup["tcfg"], CPU)


def test_temperature_sampling_is_seeded(setup):
    model, params = _port(setup, CPU)
    eng = ServeEngine(model, params, max_len=8)
    prompts = setup["tokens"][:, :3]
    a = eng.generate(prompts, n_new=4, temperature=0.8, seed=5)
    b = eng.generate(prompts, n_new=4, temperature=0.8, seed=5)
    assert a.shape == (2, 4) and ((a >= 0) & (a < setup["tcfg"].vocab)).all()
    np.testing.assert_array_equal(a, b)


def test_serve_launcher_generates_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "paper-moe-8e", "--reduced", "--ep", "8",
                      "--dtype", "f32", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "3", "--new-tokens", "2"])
    assert out.shape == (2, 2)
    assert "paper-moe-8e-smoke ep=8 on cpu" in capsys.readouterr().out
