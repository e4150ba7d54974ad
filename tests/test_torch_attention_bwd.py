"""What the port's step keeps for its backward, against the reference, on the CPU.

* ``attention_bwd`` (FlashAttention-2's backward from the saved rows'
  log-sum-exp, by key chunks and query blocks, masked pairs skipped)
  against ``jax.vjp`` of the reference's ``chunked_attention`` at the same
  chunk (float32, 1e-5 of each gradient's largest value), over several
  chunks and blocks: GQA, window, ``q_offset``, not causal, and rows that
  see no key; in float64 against autograd through the port's plain
  ``mha_ref`` in float64 (1e-10: the reference computes in float32
  whatever its inputs), its own log-sum-exp pass included;
* the attention Function: forward outputs bit for bit the route's own
  function's, and no saved tensor of Sq x Sk elements
  (``saved_tensors_hooks``);
* ``rms_norm``'s Function: the forward bit for bit the plain formula,
  gradients against autograd through it and ``jax.grad`` of the
  reference's, in bfloat16, float32 and float64; ``norm_linear``, the NLL
  and the vocab block's parts against autograd through their plain forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import chunked_attention as j_chunked
from repro.models.layers import rms_norm as j_rms_norm
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import layers as L
from repro_torch.sharding import tp as T

pytestmark = pytest.mark.torch_port

#: (b, h, hkv, sq, sk, dh, causal, window, q_offset, chunk, block)
CASES = {
    "causal, GQA 2:1": (2, 4, 2, 80, 80, 16, True, None, 0, 32, 16),
    "window": (1, 2, 2, 96, 96, 8, True, 20, 0, 32, 16),
    "q_offset, GQA 4:1, Sk ragged": (1, 8, 2, 40, 150, 16, True, None, 110, 64, 16),
    "not causal": (2, 2, 1, 50, 70, 8, False, None, 0, 32, 16),
    "not causal, window": (1, 2, 1, 48, 100, 8, False, 30, 40, 32, 16),
    # rows 0..14 see keys; rows from qpos 71 on (window 8 past the last key 63) none
    "rows that see no key": (1, 4, 2, 40, 64, 8, True, 8, 56, 16, 16),
}


def _inputs(b, h, hkv, sq, sk, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype)
            for s in ((b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh), (b, h, sq, dh))]


def _close(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


@pytest.mark.parametrize("case", list(CASES))
def test_attention_bwd_is_the_references_chunked_vjp(case):
    b, h, hkv, sq, sk, dh, causal, window, q_offset, chunk, block = CASES[case]
    q, k, v, g = _inputs(b, h, hkv, sq, sk, dh, seed=sq + sk)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv, tg = map(torch.as_tensor, (q, k, v, g))
    o, lse = fa.chunked_attention(tq, tk, tv, chunk=chunk, with_lse=True, **mask)
    assert torch.equal(o, fa.chunked_attention(tq, tk, tv, chunk=chunk, **mask))
    got = fa.attention_bwd(tq, tk, tv, o, tg, lse, chunk=chunk, block=block, **mask)
    _, vjp = jax.vjp(lambda *a: j_chunked(*a, chunk=chunk, **mask), *map(jnp.asarray, (q, k, v)))
    for a, w in zip(got, vjp(jnp.asarray(g))):
        assert a.dtype == torch.float32
        _close(a.numpy(), np.asarray(w), 1e-5)
    # without lse: its own pass over the chunks (the card's route)
    again = fa.attention_bwd(tq, tk, tv, o, tg, None, chunk=chunk, block=block, **mask)
    for a, w in zip(again, got):
        _close(a.numpy(), w.numpy(), 1e-6)


def test_rows_that_see_no_key_get_the_chunked_vjp_s_mean():
    # such a row weighs each key of the padded chunks 1 in chunked_attention:
    # its dV share is g / (chunks x chunk) on every real key, dQ nothing
    b, h, hkv, sq, sk, dh, causal, window, q_offset, chunk, block = CASES[
        "rows that see no key"]
    q, k, v, g = _inputs(b, h, hkv, sq, sk, dh, seed=5)
    empty = np.arange(sq) + q_offset >= sk + window - 1
    assert 0 < empty.sum() < sq
    g[:, :, ~empty] = 0.0
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv, tg = map(torch.as_tensor, (q, k, v, g))
    o, lse = fa.chunked_attention(tq, tk, tv, chunk=chunk, with_lse=True, **mask)
    dq, dk, dv = fa.attention_bwd(tq, tk, tv, o, tg, lse, chunk=chunk, block=block, **mask)
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    per_kv = g.reshape(b, hkv, h // hkv, sq, dh).sum((2, 3)) / (-(-sk // chunk) * chunk)
    _close(dv.numpy(), np.broadcast_to(per_kv[:, :, None], dv.shape), 1e-6)


@pytest.mark.parametrize("case", [c for c in CASES if c != "rows that see no key"])
@pytest.mark.parametrize("with_lse", [True, False])
def test_attention_bwd_float64_is_mha_ref_s_vjp(case, with_lse):
    b, h, hkv, sq, sk, dh, causal, window, q_offset, chunk, block = CASES[case]
    q, k, v, g = (torch.as_tensor(a) for a in _inputs(b, h, hkv, sq, sk, dh, seed=sq,
                                                        dtype=np.float64))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.mha_ref(q, k, v, with_lse=True, **mask)
    assert o.dtype == lse.dtype == torch.float64
    got = fa.attention_bwd(q, k, v, o, g, lse if with_lse else None, chunk=chunk, block=block,
                           **mask)
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.mha_ref(*live, **mask), live, g)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        _close(a.numpy(), w.numpy(), 1e-10)


def test_attention_bwd_returns_each_input_s_dtype():
    q, k, v, g = (torch.as_tensor(a, dtype=torch.bfloat16)
                  for a in _inputs(1, 2, 1, 40, 40, 8, seed=3))
    o, lse = fa.mha_ref(q, k, v, with_lse=True)
    assert lse.dtype == torch.float32
    got = fa.attention_bwd(q, k, v, o, g, lse, chunk=16, block=16)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3


@pytest.mark.parametrize("rect", [(0, 15, 0, 15), (0, 15, 16, 31), (40, 55, 0, 15),
                                  (10, 20, 5, 30), (100, 120, 0, 50)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, 24),
                                           (False, None), (True, 1)])
def test_visible_blocks_are_the_masks(rect, causal, window):
    q0, q1, k0, k1 = rect
    qpos, kpos = np.arange(q0, q1 + 1)[:, None], np.arange(k0, k1 + 1)[None, :]
    m = np.ones((q1 - q0 + 1, k1 - k0 + 1), bool)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    assert fa._visible(q0, q1, k0, k1, causal, window) == (bool(m.any()), bool(m.all()))


# -- the attention Function ---------------------------------------------------------

ROUTES = {"mha_ref": (96, 96), "chunked_attention": (24, 4200)}


@pytest.mark.parametrize("name", list(ROUTES))
def test_attention_function_keeps_its_route_s_forward_and_no_scores(name):
    sq, sk = ROUTES[name]
    assert fa.route("cpu", sq, sk) == name
    q, k, v, g = (torch.as_tensor(a) for a in _inputs(1, 4, 2, sq, sk, 8, seed=sk))
    kw = dict(causal=True, window=None, q_offset=sk - sq)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = fa.attention(*live, **kw)
    assert type(o.grad_fn).__name__ == "_AttentionBackward"
    assert torch.equal(o.detach(), getattr(fa, name)(q, k, v, **kw))
    # q, k, v, o and the rows' log-sum-exp: nothing of Sq x Sk
    assert sorted(saved) == sorted([q.shape, k.shape, v.shape, q.shape, q.shape[:3]]), saved
    assert all(np.prod(s) < sq * sk for s in saved)
    got = torch.autograd.grad(o, live, g)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(getattr(fa, name)(*plain, **kw), plain, g)
    for a, w in zip(got, want):
        _close(a.numpy(), w.numpy(), 1e-5)


def test_attention_function_takes_query_blocks_on_the_mha_ref_route(monkeypatch):
    # more than one query block of mha_ref: each block's rows over all keys,
    # the output the whole call's bit for bit
    monkeypatch.setattr(fa, "_BLOCK", 32)
    q, k, v, g = (torch.as_tensor(a) for a in _inputs(2, 4, 2, 100, 100, 8, seed=7))
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.attention(*live, causal=True, window=40)
    assert torch.equal(o.detach(), fa.mha_ref(q, k, v, causal=True, window=40))
    got = torch.autograd.grad(o, live, g)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.mha_ref(*plain, causal=True, window=40), plain, g)
    for a, w in zip(got, want):
        _close(a.numpy(), w.numpy(), 1e-5)


# -- RMSNorm, norm_linear and the loss ------------------------------------------------------


def _plain_rms_norm(x, w, eps=1e-5):
    xf = L.up32(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


#: dtype -> (limit against autograd through the plain formula, against jax.grad)
RMS = {torch.bfloat16: (0.0, 1e-2), torch.float32: (1e-6, 1e-5), torch.float64: (1e-12, 1e-5)}


@pytest.mark.parametrize("dtype", list(RMS), ids=["bf16", "f32", "f64"])
def test_rms_norm_function_against_autograd_and_the_reference(dtype, monkeypatch):
    monkeypatch.setattr(L, "NORM_CHUNK_BYTES", 4 * 64 * 7)      # chunks of 7 rows
    rng = np.random.default_rng(11)
    x0 = (3 * rng.normal(size=(3, 10, 64))).astype(np.float32)
    w0 = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    g0 = rng.normal(size=(3, 10, 64)).astype(np.float32)
    x, w, g = (torch.as_tensor(a).to(dtype) for a in (x0, w0, g0))
    live = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    y = L.rms_norm(*live)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    assert torch.equal(y.detach(), _plain_rms_norm(x, w))
    with torch.no_grad():
        assert torch.equal(L.rms_norm(x, w), _plain_rms_norm(x, w))
    got = torch.autograd.grad(y, live, g)
    plain = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    want = torch.autograd.grad(_plain_rms_norm(*plain), plain, g)
    to_auto, to_jax = RMS[dtype]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(j_rms_norm, jnp.asarray(x0, jdt), jnp.asarray(w0, jdt))
    ref = vjp(jnp.asarray(g0, jdt))
    for a, b, r in zip(got, want, ref):
        assert a.dtype == dtype
        _close(a.float().numpy(), b.float().numpy(), to_auto)
        _close(a.float().numpy(), np.asarray(r.astype(jnp.float32)), to_jax)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_norm_linear_against_autograd(dtype, tol, monkeypatch):
    monkeypatch.setattr(L, "NORM_CHUNK_BYTES", 4 * 32 * 5)
    rng = np.random.default_rng(12)
    x, w, w1, w2, g1, g2 = (torch.as_tensor(rng.normal(size=s), dtype=dtype) for s in
                            ((2, 9, 32), (32,), (32, 24), (32, 8), (2, 9, 24), (2, 9, 8)))
    live = [t.clone().requires_grad_(True) for t in (x, w, w1, w2)]
    y1, y2 = L.norm_linear(live[0], live[1], 1e-5, live[2:])
    h = _plain_rms_norm(x, w)
    assert torch.equal(y1.detach(), h @ w1) and torch.equal(y2.detach(), h @ w2)
    got = torch.autograd.grad((y1, y2), live, (g1, g2))
    plain = [t.clone().requires_grad_(True) for t in (x, w, w1, w2)]
    hp = _plain_rms_norm(plain[0], plain[1])
    want = torch.autograd.grad((hp @ plain[2], hp @ plain[3]), plain, (g1, g2))
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a.float().numpy(), b.float().numpy(), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_functions_against_autograd(dtype, monkeypatch):
    monkeypatch.setattr(T, "ROW_CHUNK_BYTES", 4 * 40 * 6)
    rng = np.random.default_rng(13)
    z = torch.as_tensor(3 * rng.normal(size=(2, 15, 40)), dtype=dtype)
    labels = torch.as_tensor(rng.integers(0, 40, size=(2, 15)))
    g = torch.as_tensor(rng.normal(size=(2, 15)), dtype=torch.float32)
    live, plain = z.clone().requires_grad_(True), z.clone().requires_grad_(True)
    got = L.nll(live, labels)
    want = -torch.gather(torch.log_softmax(L.up32(plain), -1), -1, labels[..., None])[..., 0]
    assert torch.equal(got.detach(), want.detach())
    _close(torch.autograd.grad(got, live, g)[0].float().numpy(),
           torch.autograd.grad(want, plain, g)[0].float().numpy(), 1e-6)
    # a vocab block of 16 at 10: the parts and their gradient
    block, v0 = z[..., 10:26], 10
    mx = T.block_max(z)
    gp = torch.as_tensor(rng.normal(size=(2, 2, 15)), dtype=torch.float32)
    live, plain = block.clone().requires_grad_(True), block.clone().requires_grad_(True)
    got = T.block_parts(live, labels, v0, mx)
    zf = L.up32(plain)
    local = labels - v0
    mine = (local >= 0) & (local < 16)
    t = torch.gather(zf, -1, local.clamp(0, 15)[..., None])[..., 0]
    want = torch.stack([torch.exp(zf - mx[..., None]).sum(-1),
                        torch.where(mine, t, torch.zeros_like(t))])
    assert torch.equal(got.detach(), want.detach())
    _close(torch.autograd.grad(got, live, gp)[0].float().numpy(),
           torch.autograd.grad(want, plain, gp)[0].float().numpy(), 1e-6)


def test_norm_linear_takes_a_weight_of_no_column():
    # a process of the model group that holds no query head projects onto
    # wq's 0 columns: its gradients are the other products' alone
    rng = np.random.default_rng(14)
    x, w, w0, w1, g1 = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32) for s in
                        ((2, 5, 16), (16,), (16, 0), (16, 6), (2, 5, 6)))
    live = [t.clone().requires_grad_(True) for t in (x, w, w0, w1)]
    y0, y1 = L.norm_linear(live[0], live[1], 1e-5, live[2:])
    assert y0.shape == (2, 5, 0)
    got = torch.autograd.grad((y0, y1), live, (torch.zeros(2, 5, 0), g1))
    plain = [t.clone().requires_grad_(True) for t in (x, w, w1)]
    want = torch.autograd.grad(_plain_rms_norm(plain[0], plain[1]) @ plain[2], plain, g1)
    assert got[2].shape == (16, 0)
    for a, b in zip((got[0], got[1], got[3]), want):
        _close(a.numpy(), b.numpy(), 1e-5)
