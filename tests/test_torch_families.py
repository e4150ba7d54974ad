"""The port's configs, registry and remaining families against the JAX package.

On the CPU, in float32, with the reference's weights carried over by
``params_from_jax``:

* every one of the reference's 11 architectures: its config, the parameter
  tree's shapes at full width (the reference's by ``jax.eval_shape``, no
  allocation), ``INPUT_SHAPES``, ``Model.supports`` and ``Model.input_specs``
  for every shape;
* ``add_modality_stubs``: the reference's frames and patches bit for bit;
* internvl2-2b (vlm), reduced: the forward with its patch prefix, ``last_only``,
  ``Model.loss`` scoring the text positions and decode steps (1e-5 of
  max(1, the largest value)); every gradient leaf (1e-4 of its largest);
* qwen3-moe-235b-a22b, reduced with the published shape's features put back
  (head dim 128 over d_model 256, so q is wider than d_model; GQA 4:1;
  16 experts, top-8): the forward on one rank and on 8 stacked EP ranks
  against the reference's single-device path (1e-4), and the loss and
  gradients (1e-4);
* ``examples/serve_multiarch`` on the CPU: its last line, and its adaptive
  and arbiter figures equal to the reference example's.
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

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import add_modality_stubs as j_stubs
from repro.models.registry import build_model as j_build_model
from repro.sharding.context import SINGLE as J_SINGLE
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, InputShape, get_config
from repro_torch.data.pipeline import add_modality_stubs, to_device
from repro_torch.models.registry import build_model, family
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CPU = ParallelContext(device="cpu")
# f32 on both sides, sums in other orders: activations and logits to 1e-5 of
# max(1, their largest value) (the moe family's to the 1e-4 of its earlier
# parity tests: the routed FFN sums 8 experts' outputs in another order);
# gradient leaves to 1e-4 of each one's largest value
TOL, MOE_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4


def _close(got, want, tol=TOL, floor=1.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


def _shapes(tree):
    """Leaf shapes in the reference's leaf order (sorted keys)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shapes(tree[k])]
    if isinstance(tree, list):
        return [s for t in tree for s in _shapes(t)]
    return [tuple(tree)]


# --------------------------------------------------------------------------- #
# configs, shapes and specs of every architecture
# --------------------------------------------------------------------------- #


def test_arch_ids_and_input_shapes_equal_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_and_param_shapes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = build_model(cfg, CPU)
    jtree = jax.eval_shape(j_build_model(jcfg, J_SINGLE).init, jax.random.PRNGKey(0))
    assert _shapes(family(cfg).param_shapes(cfg)) == [
        tuple(a.shape) for a in jax.tree.leaves(jtree)]
    assert model.mod is family(cfg)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        model = build_model(get_config(arch), dataclasses.replace(CPU, compute_dtype=dt))
        jmodel = j_build_model(j_get_config(arch), dataclasses.replace(
            J_SINGLE, compute_dtype=jdt))
        for name, shape in INPUT_SHAPES.items():
            jshape = J_INPUT_SHAPES[name]
            assert model.supports(shape) == jmodel.supports(jshape)
            if not model.supports(shape):
                continue
            assert model.cache_len(shape) == jmodel.cache_len(jshape)
            got, want = model.input_specs(shape), jmodel.input_specs(jshape)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == v.shape
                assert str(got[k].dtype)[6:] == str(v.dtype)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-2b", "smollm-135m"])
def test_modality_stubs_equal_the_reference_bit_for_bit(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    rng = np.random.default_rng(1)
    b = {k: rng.integers(0, cfg.vocab, (2, 600)).astype(np.int32)
         for k in ("tokens", "labels")}
    for seed in (0, 7):
        got, want = add_modality_stubs(b, cfg, rng_seed=seed), j_stubs(b, jcfg, rng_seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        t = to_device(got, "cpu")
        for k in want:
            assert t[k].dtype == (torch.float32 if want[k].dtype.kind == "f" else torch.int64)


# --------------------------------------------------------------------------- #
# the vlm family: internvl2-2b
# --------------------------------------------------------------------------- #


def _pair(arch, **kw):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams,
                tmodel=build_model(tcfg, CPU), params=params_from_jax(tree, tcfg, CPU))


@pytest.fixture(scope="module", params=[16, 120], ids=["S16", "S120"])
def vlm(request):
    m = _pair("internvl2-2b")
    rng = np.random.default_rng(request.param)
    batch = {k: rng.integers(0, m["jcfg"].vocab, (2, request.param)).astype(np.int32)
             for k in ("tokens", "labels")}
    m["batch"] = j_stubs(batch, m["jcfg"], rng_seed=2)
    return m


def test_vlm_forward_and_loss_match_reference(vlm):
    jb = {k: jnp.asarray(v) for k, v in vlm["batch"].items()}
    tb = to_device(vlm["batch"], "cpu")
    n_text = vlm["batch"]["tokens"].shape[1]
    for last_only in (False, True):
        want, _ = jax.jit(lambda p: vlm["jmodel"].forward(p, jb, last_only=last_only))(
            vlm["jparams"])
        got, _ = vlm["tmodel"].forward(vlm["params"], tb, last_only=last_only)
        _close(got, want)
    assert got.shape[1] == 1 and want.shape[1] == 1
    full, _ = vlm["tmodel"].forward(vlm["params"], tb)
    assert full.shape[1] == vlm["tcfg"].n_patches + n_text
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: vlm["jmodel"].loss(p, jb)))(
        vlm["jparams"])
    loss, grads = loss_and_grads(vlm["tmodel"], vlm["params"], tb)
    _close(loss, jloss)
    for g, w in zip(leaves(grads), jax.tree.leaves(jgrads)):
        _close(g, w, GRAD_TOL, floor=1e-30)


def test_vlm_decode_steps_match_reference(vlm):
    # pos counts the patch prefix: decode the text after P positions
    P = vlm["tcfg"].n_patches
    tok = vlm["batch"]["tokens"]
    shape = InputShape("s", P + 8, 2, "decode")
    jcache = vlm["jmodel"].init_cache(2, JInputShape("s", P + 8, 2, "decode"))
    tcache = vlm["tmodel"].init_cache(2, shape)
    step = jax.jit(vlm["jmodel"].decode_step)
    for i in range(4):
        jl, jcache = step(vlm["jparams"], jcache, jnp.asarray(tok[:, i]), jnp.int32(P + i))
        tl, tcache = vlm["tmodel"].decode_step(vlm["params"], tcache,
                                               torch.as_tensor(tok[:, i]), P + i)
        _close(tl, jl)


# --------------------------------------------------------------------------- #
# the moe family's last config: qwen3-moe-235b-a22b
# --------------------------------------------------------------------------- #


#: reduced() drops the head-dim override and caps the experts at 4 and top-k
#: at 2; put back a q projection wider than d_model, GQA and top-8 of 16
QWEN3_KW = dict(head_dim_override=128, n_kv_heads=1, n_experts=16, top_k=8,
                moe_capacity_factor=8.0)


@pytest.fixture(scope="module")
def qwen3(monkeypatch_module):
    # the reference's CPU path packs rows by capacity above 2 E x 64 rows
    # (grouped_ffn_dense); its block scan drops nothing, as the port's FFN
    monkeypatch_module.setenv("NIMBLE_FFN_IMPL", "scan")
    m = _pair("qwen3-moe-235b-a22b", **QWEN3_KW)
    assert m["tcfg"].n_heads * m["tcfg"].head_dim > m["tcfg"].d_model
    rng = np.random.default_rng(4)
    m["batch"] = {k: rng.integers(0, m["jcfg"].vocab, (2, 136)).astype(np.int32)
                  for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in m["batch"].items()}
    m["jlogits"] = np.asarray(jax.jit(lambda p: m["jmodel"].forward(p, jb)[0])(m["jparams"]))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: m["jmodel"].loss(p, jb)))(
        m["jparams"])
    m["jloss"], m["jgrads"] = float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]
    return m


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("ep", [1, 8])
def test_qwen3_forward_matches_reference(qwen3, ep):
    ctx = dataclasses.replace(CPU, ep_size=ep, group_size=min(ep, 4))
    model = build_model(qwen3["tcfg"], ctx)
    stats = {}
    got, aux = model.forward(qwen3["params"], to_device(qwen3["batch"], "cpu"), stats=stats)
    assert int(stats["dropped"]) == 0
    assert np.isfinite(float(aux))
    _close(got, qwen3["jlogits"], MOE_TOL)


@pytest.mark.parametrize("ep", [1, 8])
def test_qwen3_loss_and_gradients_match_reference(qwen3, ep):
    ctx = dataclasses.replace(CPU, ep_size=ep, group_size=min(ep, 4))
    model = build_model(qwen3["tcfg"], ctx)
    loss, grads = loss_and_grads(model, qwen3["params"], to_device(qwen3["batch"], "cpu"))
    _close(loss, qwen3["jloss"], TOL)
    for g, w in zip(leaves(grads), qwen3["jgrads"]):
        _close(g, w, GRAD_TOL, floor=1e-30)


def test_qwen3_generate_greedy_matches_reference(qwen3):
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.serve.engine import ServeEngine

    prompts = qwen3["batch"]["tokens"][:, :5]
    want = JServeEngine(qwen3["jmodel"], qwen3["jparams"], max_len=9).generate(
        prompts, n_new=4)
    model = build_model(qwen3["tcfg"], dataclasses.replace(CPU, ep_size=8))
    got = ServeEngine(model, qwen3["params"], max_len=9).generate(prompts, n_new=4)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# examples/serve_multiarch
# --------------------------------------------------------------------------- #


def test_serve_multiarch_on_cpu_matches_the_reference_example():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

    def run(*cmd):
        r = subprocess.run([sys.executable, *cmd, "--adaptive"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        return r.stdout.strip().splitlines()

    got = run("-m", "repro_torch.examples.serve_multiarch", "--device", "cpu")
    want = run("examples/serve_multiarch.py")
    assert "all families served" in got[-1]
    assert [ln.split()[1] for ln in got[:4]] == ["dense", "moe", "hybrid", "ssm"]
    # the runtime and arbiter figures: the reference's, line for line
    figures = ("[serve] adaptive runtime", "[serve] multi-tenant arbiter")
    assert [ln for ln in got if ln.startswith(figures)] == [
        ln for ln in want if ln.startswith(figures)]


def test_new_entry_points_default_to_the_card():
    # this file imports JAX, so it runs where there is no card: the example
    # and the launcher refuse to run rather than fall back to the CPU
    from repro_torch.examples import serve_multiarch
    from repro_torch.launch import serve

    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit):
        serve_multiarch.main([])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "zamba2-1.2b", "--reduced"])
