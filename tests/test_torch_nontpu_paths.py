"""The reference's non-TPU kernel paths, ported, against the JAX package's.

``chunked_attention`` (the online softmax over key chunks, and through its
VJP the flash kernel's backward), ``grouped_ffn_scan`` and
``grouped_ffn_dense`` (the capacity-dropping one), and the two dispatch
rules, ``attention`` and ``grouped_ffn``, on the CPU.  Inputs are made from
a numpy seed and go through both packages; f32 results and gradients must
agree within 1e-5 of each one's largest value, and ``dense`` must drop the
same rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.grouped_ffn import ops as j_ffn
from repro.kernels.grouped_ffn.ref import grouped_ffn_ref as j_grouped_ffn_ref
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.grouped_ffn import ops as t_ffn

pytestmark = pytest.mark.torch_port

TOL = 1e-5


def _close(got, want, tol=TOL):
    """max|got - want| <= tol x max|want|."""
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


def _vjp_both(t_fn, j_fn, args, g):
    """(port out, port grads), (JAX out, JAX grads) of the float args for cotangent g."""
    live = [torch.as_tensor(a).requires_grad_(True) for a in args]
    out = t_fn(*live)
    grads = torch.autograd.grad(out, live, torch.as_tensor(g))
    jout, vjp = jax.vjp(j_fn, *map(jnp.asarray, args))
    return (out.detach(), grads), (jout, vjp(jnp.asarray(g)))


# --------------------------------------------------------------------------- #
# chunked_attention
# --------------------------------------------------------------------------- #


def _attn_inputs(b, h, hkv, sq, sk, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh)))
    return q, k, v, rng.normal(size=(b, h, sq, dh)).astype(np.float32)


#: (b, h, hkv, sq, sk, dh, causal, window, q_offset, chunk)
ATTN_CASES = {
    "chunk 64, Sk ragged, causal, offset": (2, 4, 4, 40, 150, 16, True, None, 110, 64),
    "chunk 64, not causal": (1, 2, 2, 33, 70, 8, False, None, 0, 64),
    "chunk 64, window, GQA 2:1": (1, 4, 2, 20, 300, 8, True, 37, 280, 64),
    "chunk 64, GQA 4:1, Sk a whole number of chunks": (1, 8, 2, 64, 128, 16, True, None, 64, 64),
    "chunk 64, not causal, window": (1, 2, 1, 24, 200, 8, False, 50, 100, 64),
    "chunk 2048, one chunk, Sq = Sk": (1, 4, 2, 130, 130, 16, True, None, 0, 2048),
    "chunk 2048, Sq < 128 over Sk > 4096": (1, 4, 1, 16, 4200, 8, True, None, 4184, 2048),
    "chunk 2048, window over Sk > 4096": (1, 2, 2, 8, 4500, 8, True, 3000, 4492, 2048),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_and_vjp_match_reference(case):
    b, h, hkv, sq, sk, dh, causal, window, q_offset, chunk = ATTN_CASES[case]
    q, k, v, g = _attn_inputs(b, h, hkv, sq, sk, dh, seed=sq + sk)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk)
    (out, grads), (jout, jgrads) = _vjp_both(
        lambda *a: t_fa.chunked_attention(*a, **kw),
        lambda *a: j_fa.chunked_attention(*a, **kw), (q, k, v), g)
    _close(out, jout)
    for got, want in zip(grads, jgrads):
        _close(got, want)


@pytest.mark.parametrize("case", ["causal", "window", "offset, GQA 3:1", "not causal"])
@pytest.mark.parametrize("sk", [160, 2100])
def test_flash_backward_is_the_references_bwd(case, sk):
    # the kernel's backward is the reference's _bwd: chunked_attention's VJP,
    # one chunk at Sk 160 (of 160 keys here, of 2048 with 1888 masked in the
    # reference) and two of 2048 at Sk 2100
    hkv = 1 if "GQA" in case else 3
    q, k, v, g = _attn_inputs(1, 3, hkv, 130, sk, 16, seed=sk)
    kw = dict(causal=case != "not causal", window=64 if case == "window" else None,
              q_offset=sk - 130 if "offset" in case else 0)
    got = t_fa.flash_attention_bwd(*map(torch.as_tensor, (q, k, v, g)), **kw)
    want = j_fa._bwd(kw["causal"], kw["window"], kw["q_offset"],
                     tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a, b)


@pytest.mark.parametrize("sk,chunk", [(160, 160), (2048, 2048), (2100, 2048)])
def test_flash_backward_chunks_at_2048_keys_or_all_of_them(sk, chunk, monkeypatch):
    seen = []

    def spy(*args, **kw):
        seen.append(kw["chunk"])
        return chunked(*args, **kw)

    chunked = t_fa.chunked_attention
    monkeypatch.setattr(t_fa, "chunked_attention", spy)
    q, k, v, g = map(torch.as_tensor, _attn_inputs(1, 2, 1, 130, sk, 8, seed=5))
    t_fa.flash_attention_bwd(q, k, v, g, q_offset=sk - 130)
    assert seen == [chunk]


def test_flash_backward_returns_the_inputs_dtypes():
    q, k, v, g = (torch.as_tensor(a, dtype=torch.bfloat16)
                  for a in _attn_inputs(1, 2, 1, 130, 140, 16, seed=3))
    got = t_fa.flash_attention_bwd(q, k, v, g)
    want = t_fa.flash_attention_bwd(*(t.float() for t in (q, k, v, g)))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))


#: (sq, sk) -> the function the CPU's dispatch must take
DISPATCH = {(16, 200): "mha_ref", (130, 200): "mha_ref", (130, 4096): "mha_ref",
            (16, 4097): "chunked_attention", (130, 4200): "chunked_attention"}


@pytest.mark.parametrize("sq,sk", list(DISPATCH))
def test_attention_dispatch_on_the_cpu_is_the_references(sq, sk, monkeypatch):
    # the reference's non-TPU rule: chunked_attention above 2 x 2048 keys,
    # else mha_ref, whatever Sq; never the flash kernel's Function
    taken = []
    for name in ("mha_ref", "chunked_attention", "flash_attention"):
        fn = getattr(t_fa, name)
        monkeypatch.setattr(t_fa, name, lambda *a, _n=name, _f=fn, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    q, k, v, g = _attn_inputs(1, 2, 1, sq, sk, 8, seed=sk)
    kw = dict(causal=True, window=None, q_offset=sk - sq)
    (out, grads), (jout, jgrads) = _vjp_both(
        lambda *a: t_fa.attention(*a, **kw), lambda *a: j_fa.attention(*a, **kw), (q, k, v), g)
    assert taken == [DISPATCH[sq, sk]]
    _close(out, jout)
    for got, want in zip(grads, jgrads):
        _close(got, want)


# --------------------------------------------------------------------------- #
# grouped_ffn_scan, grouped_ffn_dense and the dispatch
# --------------------------------------------------------------------------- #


def _ffn_inputs(n, d, f, e, seed, eid=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = [(rng.normal(size=s) * 0.05).astype(np.float32)
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    if eid is None:
        eid = rng.integers(0, e, size=(n,)).astype(np.int32)
        eid[: n // 8] = -1                                   # some invalid rows
    return x, eid, w, rng.normal(size=(n, d)).astype(np.float32)


#: (function, n, e, d, f, keyword arguments, routing)
FFN_CASES = {
    "scan 700 rows, 4 experts (test_kernels.py)": (
        "grouped_ffn_scan", 700, 4, 32, 64, dict(block_tokens=64), "balanced"),
    "scan, blocks of 32, 8 experts": (
        "grouped_ffn_scan", 300, 8, 16, 32, dict(block_tokens=32), "balanced"),
    "scan, one expert takes most rows": (
        "grouped_ffn_scan", 257, 4, 8, 16, dict(block_tokens=16), "skewed"),
    "dense balanced 256 x 8 (test_grouped_ffn_dense.py)": (
        "grouped_ffn_dense", 256, 8, 16, 32, dict(cap_factor=4.0), "balanced"),
    "dense balanced 130 x 4": (
        "grouped_ffn_dense", 130, 4, 8, 8, dict(cap_factor=4.0), "balanced"),
    "dense drops at cap_factor 1.0, all rows to expert 0": (
        "grouped_ffn_dense", 128, 4, 8, 8, dict(cap_factor=1.0, block_tokens=16), "expert 0"),
    "dense drops at cap_factor 1.0, skewed": (
        "grouped_ffn_dense", 300, 4, 16, 32, dict(cap_factor=1.0, block_tokens=16), "skewed"),
    "dense at its defaults, 96 rows": (
        "grouped_ffn_dense", 96, 4, 8, 8, dict(), "balanced"),
}


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_grouped_ffn_non_tpu_paths_and_vjps_match_reference(case):
    name, n, e, d, f, kw, routing = FFN_CASES[case]
    rng = np.random.default_rng(n + e)
    eid = {"balanced": None,
           "expert 0": np.zeros(n, np.int32),
           "skewed": rng.choice(e, size=n, p=[0.7] + [0.3 / (e - 1)] * (e - 1)
                                ).astype(np.int32)}[routing]
    x, eid, w, g = _ffn_inputs(n, d, f, e, seed=n * e, eid=eid)
    t_fn, j_fn = getattr(t_ffn, name), getattr(j_ffn, name)
    (out, grads), (jout, jgrads) = _vjp_both(
        lambda x_, *w_: t_fn(x_, torch.as_tensor(eid), *w_, **kw),
        lambda x_, *w_: j_fn(x_, jnp.asarray(eid), *w_, **kw), (x, *w), g)
    zero = (np.asarray(jout) == 0).all(1)
    assert np.array_equal((out.numpy() == 0).all(1), zero)    # the same rows dropped
    if routing == "expert 0":
        cap = 32                             # ceil(128 x 1.0 / (4 x 16)) x 16
        assert zero[cap:].all() and not zero[:cap].any()
    elif name == "grouped_ffn_scan":
        assert np.array_equal(zero, eid < 0)                  # the scan drops nothing
    _close(out, jout)
    for got, want in zip(grads, jgrads):
        _close(got, want)
    assert (grads[0].numpy()[zero] == 0).all()


def test_grouped_ffn_dense_fills_dropped_rows_with_exact_zeros():
    # a dropped row adds zeros at slot cap - 1: the kept row there keeps its bits
    x, eid, (wg, wu, wd), _ = _ffn_inputs(128, 8, 8, 4, seed=5, eid=np.zeros(128, np.int32))
    args = (torch.as_tensor(x), torch.as_tensor(eid), *map(torch.as_tensor, (wg, wu, wd)))
    y = t_ffn.grouped_ffn_dense(*args, cap_factor=1.0, block_tokens=16)
    alone = t_ffn.grouped_ffn_dense(args[0][:32], args[1][:32], *args[2:],
                                    cap_factor=4.0, block_tokens=16)
    assert torch.equal(y[:32], alone) and not y[32:].any()


@pytest.mark.parametrize("impl", [None, "scan"])
@pytest.mark.parametrize("n,e,bt", [(1100, 4, 128), (700, 4, 128), (600, 8, 64),
                                    (2100, 8, 64), (300, 4, 64), (200, 4, 64)])
def test_grouped_ffn_on_the_cpu_takes_the_references_branch(n, e, bt, impl, monkeypatch):
    # above 4 x block_tokens rows: dense where N >= 2 E block_tokens and
    # NIMBLE_FFN_IMPL is not "scan", else the scan; below, the blocked
    # kernel's plain version (the reference's custom VJP)
    if impl is None:
        monkeypatch.delenv("NIMBLE_FFN_IMPL", raising=False)
    else:
        monkeypatch.setenv("NIMBLE_FFN_IMPL", impl)
    want_branch = ("blocked" if n <= 4 * bt else
                   "grouped_ffn_dense" if impl is None and n >= 2 * e * bt else
                   "grouped_ffn_scan")
    taken = []
    for name in ("grouped_ffn_dense", "grouped_ffn_scan"):
        fn = getattr(t_ffn, name)
        monkeypatch.setattr(t_ffn, name, lambda *a, _n=name, _f=fn, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    rng = np.random.default_rng(n)
    eid = rng.choice(e, size=n, p=[0.5] + [0.5 / (e - 1)] * (e - 1)).astype(np.int32)
    x, eid, w, g = _ffn_inputs(n, 16, 32, e, seed=n + e, eid=eid)
    (out, grads), (jout, jgrads) = _vjp_both(
        lambda x_, *w_: t_ffn.grouped_ffn(x_, torch.as_tensor(eid), *w_, block_tokens=bt),
        lambda x_, *w_: j_ffn.grouped_ffn(x_, jnp.asarray(eid), *w_, block_tokens=bt,
                                          block_ffn=32), (x, *w), g)
    assert taken == ([] if want_branch == "blocked" else [want_branch])
    assert np.array_equal((out.numpy() == 0).all(1), (np.asarray(jout) == 0).all(1))
    _close(out, jout)
    for got, want in zip(grads, jgrads):
        _close(got, want)


def test_grouped_ffn_scan_equals_the_blocked_plain_version():
    # the scan and the blocked kernel's plain version (the CPU's branch at
    # up to 4 x block_tokens rows) compute the same rows in float32
    x, eid, (wg, wu, wd), _ = _ffn_inputs(300, 16, 32, 4, seed=9)
    args = (torch.as_tensor(x), torch.as_tensor(eid), *map(torch.as_tensor, (wg, wu, wd)))
    _close(t_ffn.grouped_ffn_scan(*args, block_tokens=32),
           t_ffn._grouped_ffn_forward(*args, 32))
    _close(t_ffn.grouped_ffn_scan(*args, block_tokens=32),
           j_grouped_ffn_ref(*map(jnp.asarray, (x, eid, wg, wu, wd))))
