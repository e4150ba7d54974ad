"""Port's xlstm-125m (reduced) against the JAX package, on the CPU.

The JAX model is initialized from a PRNG key and its parameter tree carried
into the port with ``params_from_jax``; both run in float32.  On the CPU
the port's ``mlstm_scan`` wrapper runs its plain version, which is held here
against the reference's Pallas kernel (interpret mode) and its per-step
oracle; the CUDA kernel is held against the same plain version on the card
by ``test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as j_get_config
from repro.kernels.mlstm_scan import mlstm_scan as j_mlstm_scan
from repro.kernels.mlstm_scan import mlstm_scan_ref as j_mlstm_scan_ref
from repro.models import xlstm as jx
from repro.models.registry import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.context import SINGLE as J_SINGLE
from repro_torch.configs.base import InputShape, get_config
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan, mlstm_scan_ref
from repro_torch.models import xlstm as tx
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding.context import ParallelContext
from repro_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port

CPU = ParallelContext(device="cpu")
# f32 on both sides, sums in other orders: logits (O(1..10)) to 1e-4 absolute
TOL = 1e-4
# chunked against per-step and kernel against oracle: the reference's own
# tolerances (tests/test_xlstm_chunked.py, tests/test_mlstm_scan_kernel.py)
RTOL, ATOL = 2e-4, 2e-5


def _cfgs(**kw):
    # reduced xlstm-125m: 4 layers (2 mLSTM, 2 sLSTM), d 256, 4 heads, dh 64
    j = dataclasses.replace(j_get_config("xlstm-125m").reduced(n_layers=4), **kw)
    t = dataclasses.replace(get_config("xlstm-125m").reduced(n_layers=4), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg, J_SINGLE)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, size=(2, 80)).astype(np.int32)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tree=tree,
                tokens=tokens, jlogits=np.asarray(jlogits))


def _port(setup, cfg=None):
    cfg = cfg or setup["tcfg"]
    return build_model(cfg, CPU), params_from_jax(setup["tree"], cfg, CPU)


# --------------------------------------------------------------------------- #
# the mlstm_scan kernel's plain version
# --------------------------------------------------------------------------- #


def _scan_inputs(b, h, s, dh, seed=0):
    # the reference's kernel-test inputs (tests/test_mlstm_scan_kernel.py)
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.normal(size=(b, h, s, dh)) * 0.3).astype(np.float32) for _ in range(3))
    ig = (rng.normal(size=(b, h, s)) * 0.5).astype(np.float32)
    fg = (rng.normal(size=(b, h, s)) + 2.0).astype(np.float32)
    lf = np.log(1.0 / (1.0 + np.exp(-fg))).astype(np.float32)
    return q, k, v, ig, lf


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("s", [64, 96, 256])
def test_mlstm_scan_plain_matches_jax_kernel(s, chunk):
    q, k, v, ig, lf = _scan_inputs(1, 2, s, 64, seed=s + chunk)
    got, _ = mlstm_scan(*map(torch.as_tensor, (q, k, v, ig, lf)), chunk=chunk)
    assert got.shape == q.shape
    _close(got, j_mlstm_scan_ref(*map(jnp.asarray, (q, k, v, ig, lf))))
    L = min(chunk, s)
    pad = -(-s // L) * L - s
    if pad:
        # the Pallas kernel takes whole chunks: pad as xlstm.py:182-188 does
        pad4 = ((0, 0), (0, 0), (0, pad), (0, 0))
        q, k, v = (np.pad(a, pad4) for a in (q, k, v))
        ig = np.pad(ig, pad4[:3], constant_values=-1e30)
        lf = np.pad(lf, pad4[:3])
    want = j_mlstm_scan(*map(jnp.asarray, (q, k, v, ig, lf)), chunk=chunk, interpret=True)
    _close(got, np.asarray(want)[:, :, :s])


def test_mlstm_scan_ref_matches_jax_ref():
    q, k, v, ig, lf = _scan_inputs(2, 2, 40, 16, seed=3)
    got, _ = mlstm_scan_ref(*map(torch.as_tensor, (q, k, v, ig, lf)))
    _close(got, j_mlstm_scan_ref(*map(jnp.asarray, (q, k, v, ig, lf))))


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("S,chunk", [(64, 16), (60, 16), (16, 64), (128, 32)])
def test_mlstm_chunked_matches_step_and_jax(S, chunk):
    jcfg, tcfg = _cfgs()
    p = jx.init_mlstm(jax.random.PRNGKey(0), jcfg, jnp.float32)
    pt = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(S).normal(size=(2, S, tcfg.d_model)).astype(np.float32)
    y_step, st_step = tx.mlstm_forward(pt, _t(x), tcfg)
    y_chk, st_chk = tx.mlstm_forward_chunked(pt, _t(x), tcfg, chunk=chunk)
    _close(y_chk, y_step)
    for key in ("C", "n", "m"):              # the cell's state convention
        _close(st_chk[key], st_step[key])
    jy, jst = jx.mlstm_forward_chunked(p, jnp.asarray(x), jcfg, chunk=chunk)
    _close(y_chk, jy)
    for key in ("C", "n", "m"):
        _close(st_chk[key], jst[key])


def test_mlstm_chunked_from_a_state_matches_jax():
    # a carried state in, as mlstm_forward_chunked(state=...) takes it
    jcfg, tcfg = _cfgs()
    p = jx.init_mlstm(jax.random.PRNGKey(1), jcfg, jnp.float32)
    pt = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(5)
    x0, x1 = (rng.normal(size=(2, s, tcfg.d_model)).astype(np.float32) for s in (40, 72))
    _, jst0 = jx.mlstm_forward(p, jnp.asarray(x0), jcfg)
    jy, jst = jx.mlstm_forward_chunked(p, jnp.asarray(x1), jcfg, state=jst0, chunk=32)
    st0 = {k: _t(v) for k, v in jst0.items()}
    y, st = tx.mlstm_forward_chunked(pt, _t(x1), tcfg, state=st0, chunk=32)
    y_step, st_step = tx.mlstm_forward(pt, _t(x1), tcfg, state=st0)
    _close(y, jy)
    _close(y, y_step)
    for key in ("C", "n", "m"):
        _close(st[key], jst[key])
        _close(st[key], st_step[key])


@pytest.mark.parametrize("S", [17, 64, 128])
def test_slstm_assoc_matches_jax_and_step(S):
    jcfg, tcfg = _cfgs()
    p = jx.init_slstm(jax.random.PRNGKey(3), jcfg, jnp.float32)
    pt = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(S).normal(size=(2, S, tcfg.d_model)).astype(np.float32)
    y_a, st_a = tx.slstm_forward_assoc(pt, _t(x), tcfg)
    y_s, st_s = tx.slstm_forward(pt, _t(x), tcfg)
    jy, jst = jx.slstm_forward_assoc(p, jnp.asarray(x), jcfg)
    _close(y_a, jy)
    _close(y_a, y_s)
    for key in ("c", "n", "m", "h"):
        _close(st_a[key], jst[key])
        _close(st_a[key], st_s[key])


@pytest.mark.parametrize("n", [1, 2, 33])
def test_prefix_scans_match_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    u, s, v = (rng.normal(size=(2, n, 5)).astype(np.float32) for _ in range(3))
    _close(tx.linear_prefix(_t(a), _t(u)), jx._lin_scan_raw(jnp.asarray(a), jnp.asarray(u)),
           rtol=1e-5, atol=1e-6)
    # max and + of the same floats in another grouping: to 1 ulp
    _close(tx.maxplus_prefix(_t(s), _t(v)),
           jx._maxplus_scan_raw(jnp.asarray(s), jnp.asarray(v)), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


def test_forward_matches_jax(setup):
    model, params = _port(setup)
    tok = torch.as_tensor(setup["tokens"], dtype=torch.int64)
    logits, aux = model.forward(params, {"tokens": tok})
    assert logits.shape == setup["jlogits"].shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), setup["jlogits"], atol=TOL, rtol=0)
    last, _ = model.forward(params, {"tokens": tok}, last_only=True)
    jlast, _ = setup["jmodel"].forward(setup["jparams"],
                                       {"tokens": jnp.asarray(setup["tokens"])},
                                       last_only=True)
    assert last.shape == (2, 1, setup["tcfg"].vocab)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=TOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), logits[:, -1:].numpy(), atol=1e-6, rtol=0)


def test_step_forward_matches_jax_and_chunked(setup):
    # mlstm_chunk=0 and slstm_assoc=False: the per-step scans everywhere
    jcfg, tcfg = _cfgs(mlstm_chunk=0, slstm_assoc=False)
    model, params = _port(setup, tcfg)
    tok = torch.as_tensor(setup["tokens"], dtype=torch.int64)
    logits, _ = model.forward(params, {"tokens": tok})
    jl, _ = j_build_model(jcfg, J_SINGLE).forward(setup["jparams"],
                                                   {"tokens": jnp.asarray(setup["tokens"])})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), setup["jlogits"], atol=TOL, rtol=0)


def _states_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            _close(g[key], w[key], rtol=1e-4, atol=1e-5)


def test_generate_greedy_and_cache_match_jax(setup):
    P, n_new = 12, 6
    prompts = setup["tokens"][:, :P]
    jeng = JServeEngine(setup["jmodel"], setup["jparams"], max_len=P + n_new)
    want = jeng.generate(prompts, n_new=n_new)
    model, params = _port(setup)
    eng = ServeEngine(model, params, max_len=P + n_new)
    got = eng.generate(prompts, n_new=n_new)
    np.testing.assert_array_equal(got, want)
    # the recurrent cache after the prompt, and after stepping the generated ids
    jcache = setup["jmodel"].init_cache(2, JInputShape("s", P + n_new, 2, "decode"))
    jl, jcache = jeng._prefill(setup["jparams"], jcache, jnp.asarray(prompts))
    cache = model.init_cache(2, InputShape("s", P + n_new, 2, "decode"))
    tl, cache = eng.prefill(cache, torch.as_tensor(prompts, dtype=torch.int64))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    _states_close(cache, jcache)
    for j in range(n_new):
        jl, jcache = jeng._step(setup["jparams"], jcache, jnp.asarray(want[:, j]),
                                jnp.int32(P + j))
        tl, cache = model.decode_step(params, cache, torch.as_tensor(got[:, j]), P + j)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    _states_close(cache, jcache)
    # the engine's step-by-step prefill ends where the kernel-path forward does
    last, _ = model.forward(params, {"tokens": torch.as_tensor(prompts, dtype=torch.int64)},
                            last_only=True)
    np.testing.assert_allclose(eng.prefill(model.init_cache(2, InputShape("s", P, 2, "d")),
                                           torch.as_tensor(prompts))[0].numpy(),
                               last[:, 0].numpy(), atol=TOL, rtol=0)


def test_params_from_jax_checks_the_list_and_keeps_f32_gates(setup):
    bad = dict(setup["tree"], blocks=setup["tree"]["blocks"][:-1])
    with pytest.raises(ValueError):
        params_from_jax(bad, setup["tcfg"], CPU)
    swapped = dict(setup["tree"], blocks=setup["tree"]["blocks"][::-1])
    with pytest.raises(ValueError):                 # sLSTM keys where mLSTM's go
        params_from_jax(swapped, setup["tcfg"], CPU)
    ctx = dataclasses.replace(CPU, param_dtype=torch.bfloat16)
    params = params_from_jax(setup["tree"], setup["tcfg"], ctx)
    m0, s1 = params["blocks"][0], params["blocks"][1]
    assert m0["wq"].dtype == torch.bfloat16 and s1["up"].dtype == torch.bfloat16
    assert m0["bi"].dtype == m0["bf"].dtype == s1["bf"].dtype == torch.float32


def test_ssm_family_takes_no_experts_or_stats(setup):
    with pytest.raises(ValueError):
        build_model(setup["tcfg"], dataclasses.replace(CPU, ep_size=2))
    model, params = _port(setup)
    tok = torch.as_tensor(setup["tokens"][:, :4], dtype=torch.int64)
    with pytest.raises(ValueError):
        model.forward(params, {"tokens": tok}, stats={})
    assert model.cache_len(InputShape("s", 4096, 2, "decode")) == 0


def test_init_matches_the_reference_tree(setup):
    model, _ = _port(setup)
    params = model.init(0)
    want = jax.tree.map(lambda a: tuple(a.shape), setup["tree"])
    got = jax.tree.map(lambda a: tuple(a.shape), params)
    assert got == want
    assert params["blocks"][0]["bf"].dtype == torch.float32


def test_serve_launcher_runs_xlstm_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "xlstm-125m", "--reduced", "--dtype", "f32",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "3",
                      "--new-tokens", "2"])
    assert out.shape == (2, 2)
    assert "xlstm-125m-smoke ep=1 on cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "xlstm-125m", "--ep", "2", "--device", "cpu"])
