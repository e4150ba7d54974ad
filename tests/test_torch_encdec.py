"""The port's whisper family (encoder-decoder) against the JAX package, on the
CPU, in float32.

The reference's weights are carried over by ``params_from_jax`` and the same
seeded inputs (stub frames from ``add_modality_stubs``) go through
``repro.models.encdec`` and the port's ``models/encdec.py``:

* ``encode``, ``decode`` and ``decode_step`` (against cached encoder states):
  1e-5 of max(1, the largest value), at the reduced config's 64 frames and
  at 150 frames with 130 tokens, past the attention dispatch's 128 (the
  flash route: non-causal self-attention, and cross-attention with Sq != Sk);
* ``Model.loss`` (1e-5) and every gradient leaf (1e-4 of its largest value);
* the serving cache, a checkpoint round trip, ``to_device`` keeping the
  frames float, and the launchers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import add_modality_stubs as j_stubs
from repro.models import encdec as jencdec
from repro.models.registry import build_model as j_build_model
from repro.sharding.context import SINGLE as J_SINGLE
from repro_torch.configs.base import InputShape, get_config
from repro_torch.data.pipeline import add_modality_stubs, to_device
from repro_torch.kernels import flash_attention
from repro_torch.models import encdec
from repro_torch.models.registry import build_model
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

CPU = ParallelContext(device="cpu")
# f32 on both sides, sums in other orders: activations and logits to 1e-5 of
# max(1, their largest value); gradient leaves to 1e-4 of each one's largest
TOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, want, tol=TOL, floor=1.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


@pytest.fixture(scope="module", params=[(64, 16), (150, 130)], ids=["F64-S16", "F150-S130"])
def setup(request):
    frames, seq = request.param
    jcfg = dataclasses.replace(j_get_config("whisper-small").reduced(), n_audio_frames=frames)
    tcfg = dataclasses.replace(get_config("whisper-small").reduced(), n_audio_frames=frames)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(frames)
    batch = {k: rng.integers(0, jcfg.vocab, (2, seq)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch = j_stubs(batch, jcfg, rng_seed=3)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tree=tree,
                batch=batch, tmodel=build_model(tcfg, CPU),
                params=params_from_jax(tree, tcfg, CPU))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_param_shapes_match_reference(setup):
    got = [tuple(t.shape) for t in leaves(setup["params"])]
    assert got == [a.shape for a in jax.tree.leaves(setup["tree"])]
    fresh = setup["tmodel"].init(0)
    assert [tuple(t.shape) for t in leaves(fresh)] == got


def test_encode_matches_reference(setup):
    frames = setup["batch"]["frames"]
    want = jax.jit(lambda p, f: jencdec.encode(p, f, setup["jcfg"]))(
        setup["jparams"], jnp.asarray(frames))
    _close(encdec.encode(setup["params"], torch.as_tensor(frames), setup["tcfg"], CPU), want)


def test_decode_matches_reference(setup):
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(2, setup["tcfg"].n_audio_frames, setup["tcfg"].d_model)
                     ).astype(np.float32)
    tok = setup["batch"]["tokens"]
    for last_only in (False, True):
        want = jax.jit(lambda p, t, e: jencdec.decode(p, t, e, setup["jcfg"],
                                                      last_only=last_only))(
            setup["jparams"], jnp.asarray(tok), jnp.asarray(enc))
        got = encdec.decode(setup["params"], torch.as_tensor(tok), torch.as_tensor(enc),
                            setup["tcfg"], CPU, last_only=last_only)
        _close(got, want)


def test_forward_and_loss_match_reference(setup):
    jb = _jb(setup["batch"])
    want, _ = jax.jit(lambda p: setup["jmodel"].forward(p, jb))(setup["jparams"])
    tb = to_device(setup["batch"], "cpu")
    assert tb["frames"].dtype == torch.float32 and tb["tokens"].dtype == torch.int64
    got, aux = setup["tmodel"].forward(setup["params"], tb)
    _close(got, want)
    assert float(aux) == 0.0
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: setup["jmodel"].loss(p, jb)))(setup["jparams"])
    loss, grads = loss_and_grads(setup["tmodel"], setup["params"], tb)
    _close(loss, jloss)
    for g, w in zip(leaves(grads), jax.tree.leaves(jgrads)):
        _close(g, w, GRAD_TOL, floor=1e-30)


def test_long_inputs_take_the_flash_route(setup, monkeypatch):
    # the attention dispatch sends Sq >= 128 to flash_attention on the card
    # (the encoder's 150 frames, the decoder's 130 tokens against them);
    # below, and on the CPU at Sk <= 4096, the plain one (the reference's
    # non-TPU rule), so every call here reaches mha_ref
    calls = []
    orig = flash_attention.ops.mha_ref

    def rec(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(flash_attention.ops, "mha_ref", rec)
    setup["tmodel"].forward(setup["params"], to_device(setup["batch"], "cpu"))
    calls = [c for c in calls if flash_attention.ops.route("cuda", c[0][2], c[1][2])
             == "flash_attention"]
    cfg = setup["tcfg"]
    F, S = cfg.n_audio_frames, setup["batch"]["tokens"].shape[1]
    want = []
    if F >= 128:
        want += [((2, cfg.n_heads, F, cfg.head_dim), (2, cfg.n_heads, F, cfg.head_dim),
                  False)] * cfg.n_enc_layers
    if S >= 128:
        want += [((2, cfg.n_heads, S, cfg.head_dim), (2, cfg.n_heads, S, cfg.head_dim), True),
                 ((2, cfg.n_heads, S, cfg.head_dim), (2, cfg.n_heads, F, cfg.head_dim),
                  False)] * cfg.n_layers
    assert calls == want


def test_decode_steps_match_reference(setup):
    cfg = setup["tcfg"]
    frames = setup["batch"]["frames"]
    jenc = jencdec.encode(setup["jparams"], jnp.asarray(frames), setup["jcfg"])
    tenc = encdec.encode(setup["params"], torch.as_tensor(frames), cfg, CPU)
    jcache = jencdec.init_cache(setup["jcfg"], 2, 8, enc_out=jenc)
    tcache = encdec.init_cache(cfg, 2, 8, CPU, enc_out=tenc)
    step = jax.jit(lambda p, c, t, i: jencdec.decode_step(p, c, t, i, setup["jcfg"]))
    tok = setup["batch"]["tokens"]
    for i in range(6):
        jl, jcache = step(setup["jparams"], jcache, jnp.asarray(tok[:, i]), jnp.int32(i))
        tl, tcache = encdec.decode_step(setup["params"], tcache, torch.as_tensor(tok[:, i]),
                                        i, cfg, CPU)
        _close(tl, jl)
    for k in ("k", "v", "slot_pos"):
        _close(tcache["self"][k], jcache["self"][k])


def test_serving_cache_matches_reference(setup):
    # the engine's cache: self-attention rings of min(S, 448) and zero
    # encoder states, as the reference's
    for S in (48, 1000):
        shape, jshape = InputShape("s", S, 2, "decode"), JInputShape("s", S, 2, "decode")
        assert setup["tmodel"].cache_len(shape) == setup["jmodel"].cache_len(jshape)
        jc = setup["jmodel"].init_cache(2, jshape)
        tc = setup["tmodel"].init_cache(2, shape)
        assert tuple(tc["self"]["k"].shape) == jc["self"]["k"].shape
        assert tuple(tc["enc_out"].shape) == jc["enc_out"].shape
        assert not tc["enc_out"].any()


def test_generate_greedy_matches_reference(setup):
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.serve.engine import ServeEngine

    prompts = setup["batch"]["tokens"][:, :4]
    want = JServeEngine(setup["jmodel"], setup["jparams"], max_len=10).generate(
        prompts, n_new=6)
    got = ServeEngine(setup["tmodel"], setup["params"], max_len=10).generate(prompts, n_new=6)
    np.testing.assert_array_equal(got, want)


def test_checkpoint_round_trip(setup, tmp_path):
    from repro_torch.checkpoint import ckpt

    ckpt.save(str(tmp_path), 2, setup["params"])
    got, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 2
    for a, b in zip(leaves(setup["params"]), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_stub_batch_feeds_the_model(setup):
    # the port's stubs give the reference's batch: tokens cut to 448, frames
    b = {k: np.zeros((2, 500), np.int32) for k in ("tokens", "labels")}
    got = add_modality_stubs(b, setup["tcfg"], rng_seed=3)
    want = j_stubs(b, setup["jcfg"], rng_seed=3)
    assert got["tokens"].shape == (2, 448) and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_train_launcher_trains_whisper_on_cpu(capsys):
    from repro_torch.launch import train

    losses = train.main(["--arch", "whisper-small", "--reduced", "--device", "cpu",
                         "--dtype", "f32", "--steps", "6", "--batch", "2", "--seq", "32",
                         "--log-every", "3"])
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert "arch=audio" in capsys.readouterr().out


def test_serve_launcher_serves_whisper_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "whisper-small", "--reduced", "--dtype", "f32",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "3",
                      "--new-tokens", "2"])
    assert out.shape == (2, 2)
    assert "whisper-small-smoke ep=1 on cpu" in capsys.readouterr().out
