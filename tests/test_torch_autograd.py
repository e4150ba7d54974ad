"""The port's three autograd Functions against the reference's custom VJPs.

Each port kernel wrapper is a ``torch.autograd.Function`` whose backward
mirrors the JAX package's ``jax.custom_vjp``.  On the CPU the forward runs
the kernel's plain version and the backward its plain backward
(``token_scatter_add_ref``, ``grouped_ffn_bwd`` and ``flash_attention_bwd``
in float32), so these tests hold the VJPs against ``jax.vjp`` of the
reference as its own tests run it on the CPU: the Pallas kernels in
interpret mode, or the plain function whose VJP the reference takes.
Inputs and output cotangents come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import chunked_attention as j_chunked
from repro.kernels.grouped_ffn import ops as j_ffn_ops
from repro.kernels.grouped_ffn.ref import grouped_ffn_ref as j_ffn_ref
from repro.kernels.token_scatter.ops import token_gather as j_gather
from repro_torch.core.moe_comm import MoECommConfig, MoEDispatcher
from repro_torch.kernels.flash_attention.ops import attention, flash_attention, mha_ref, route
from repro_torch.kernels.grouped_ffn.ops import grouped_ffn
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan, mlstm_scan_ref
from repro_torch.kernels.relay_copy.ops import relay_copy
from repro_torch.kernels.token_scatter.ops import (
    inverse_index,
    token_gather,
    token_scatter_add,
    token_scatter_add_ref,
)

pytestmark = pytest.mark.torch_port


def _vjp_torch(fn, args, g):
    """(output, gradients of every float argument) of ``fn`` for cotangent g."""
    live = [torch.as_tensor(a).requires_grad_(True) if a.dtype.kind == "f"
            else torch.as_tensor(a) for a in args]
    out = fn(*live)
    grads = torch.autograd.grad(out, [t for t in live if t.requires_grad],
                                torch.as_tensor(g))
    return out.detach(), grads


def _close(got, want, tol):
    """max|got - want| <= tol x max|want| (a leaf's largest value sets the scale)."""
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3g} > {tol:g} x {scale:.3g}"


# --------------------------------------------------------------------------- #
# token_gather: the scatter-add VJP
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,m,d", [(16, 40, 8), (64, 100, 32), (5, 30, 3)])
def test_token_gather_vjp_matches_reference(n, m, d):
    # repeated, negative and out-of-range (clipped) indices; f32 sums of a
    # few terms in another order: 1e-6 relative
    rng = np.random.default_rng(n * m)
    x = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(-4, n + 4, size=(m,)).astype(np.int32)
    g = rng.normal(size=(m, d)).astype(np.float32)
    out, (gx,) = _vjp_torch(lambda t: token_gather(t, torch.as_tensor(idx)), [x], g)
    jout, vjp = jax.vjp(lambda t: j_gather(t, jnp.asarray(idx)), jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    _close(gx.numpy(), np.asarray(jgx), 1e-6)


def test_token_gather_vjp_bf16_two_sources_bit_exact():
    # every row has at most two sources: one rounding of a two-term sum, in
    # either order, so the port's f32-then-round equals the reference's bf16
    # scatter-add bit for bit
    rng = np.random.default_rng(3)
    n, d = 32, 16
    idx = np.concatenate([np.arange(n), rng.permutation(n)[:20], [-1, -3, n + 2]])
    idx = rng.permutation(idx).astype(np.int32)
    idx[idx == n + 2] = -2                      # keep row n - 1 at two sources
    x = rng.normal(size=(n, d)).astype(np.float32)
    g = rng.normal(size=(idx.size, d)).astype(np.float32)
    xt = torch.as_tensor(x).to(torch.bfloat16).requires_grad_(True)
    (gx,) = torch.autograd.grad(token_gather(xt, torch.as_tensor(idx)), xt,
                                torch.as_tensor(g).to(torch.bfloat16))
    _, vjp = jax.vjp(lambda t: j_gather(t, jnp.asarray(idx)),
                     jnp.asarray(x, dtype=jnp.bfloat16))
    (jgx,) = vjp(jnp.asarray(g, dtype=jnp.bfloat16))
    assert gx.dtype == torch.bfloat16
    np.testing.assert_array_equal(gx.float().numpy(), np.asarray(jgx.astype(jnp.float32)))


def test_token_gather_saves_only_the_index_and_builds_no_graph_without_grad():
    x = torch.randn(6, 4, requires_grad=True)
    idx = torch.tensor([5, -1, 2, 2])
    y = token_gather(x, idx)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and torch.equal(saved[0], idx)
    assert token_gather(x.detach(), idx).grad_fn is None
    with torch.no_grad():
        assert token_gather(x, idx).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inverse_index_lists_each_rows_sources_in_order(dtype):
    # the kernel's inverse index, summed in order in f32, is the plain version
    rng = np.random.default_rng(7)
    n, d = 20, 6
    idx = torch.as_tensor(rng.integers(-3, n + 3, size=(50,)))
    g = torch.as_tensor(rng.normal(size=(50, d))).to(dtype)
    order, offsets = inverse_index(idx, n)
    want = token_scatter_add_ref(g, idx, n)
    out = torch.zeros((n, d), dtype=torch.float32)
    for r in range(n):
        src = order[offsets[r]:offsets[r + 1]]
        assert torch.all(src[1:] > src[:-1])                  # increasing i
        assert torch.all(idx[src].clamp_max(n - 1) == r)
        for i in src:
            out[r] += g[i].float()
    assert int(offsets[-1]) == int((idx >= 0).sum())
    np.testing.assert_array_equal(out.to(dtype).float().numpy(), want.float().numpy())
    np.testing.assert_array_equal(token_scatter_add(g, idx, n).float().numpy(),
                                  want.float().numpy())


@pytest.mark.parametrize("kernel", ["mlstm_scan", "relay_copy"])
def test_kernels_without_backward_differentiate_on_the_cpu(kernel):
    # their CUDA routes raise under a gradient; the plain versions, on the
    # CPU, keep autograd: relay_copy's gradient is the cotangent itself,
    # mlstm_scan's that of its per-step recurrence
    rng = np.random.default_rng(9)
    if kernel == "relay_copy":
        x = torch.as_tensor(rng.normal(size=(512, 8)), dtype=torch.float32).requires_grad_(True)
        g = torch.as_tensor(rng.normal(size=(512, 8)), dtype=torch.float32)
        (gx,) = torch.autograd.grad(relay_copy(x, block_chunk=128), x, g)
        assert torch.equal(gx, g)
        return
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 2, 24, 8)) * 0.3, dtype=torch.float32)
               .requires_grad_(True) for _ in range(3))
    ig = torch.as_tensor(rng.normal(size=(1, 2, 24)) * 0.5, dtype=torch.float32)
    lf = torch.nn.functional.logsigmoid(
        torch.as_tensor(rng.normal(size=(1, 2, 24)) + 2.0, dtype=torch.float32))
    g = torch.as_tensor(rng.normal(size=(1, 2, 24, 8)), dtype=torch.float32)
    got = torch.autograd.grad(mlstm_scan(q, k, v, ig, lf, chunk=8)[0], (q, k, v), g)
    want = torch.autograd.grad(mlstm_scan_ref(q, k, v, ig, lf)[0], (q, k, v), g)
    for a, b in zip(got, want):
        assert a.abs().max() > 0
        _close(a.numpy(), b.numpy(), 1e-5)     # f32: chunked vs per-step sums


def test_dispatch_sideband_builds_no_graph():
    # the payload carries the gradient; the f32 expert-id sideband does not
    disp = MoEDispatcher(MoECommConfig(n_devices=4, n_experts=8, d_model=8, chunk_tokens=4,
                                       capacity_factor=4.0, group_size=2))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.normal(size=(4, 16, 8)), dtype=torch.float32)
    toks.requires_grad_(True)
    eidx = torch.as_tensor(rng.integers(0, 8, size=(4, 16, 2)))
    recv, e_local, _ = disp.dispatch(toks, eidx)
    assert recv.requires_grad and not e_local.requires_grad


# --------------------------------------------------------------------------- #
# grouped_ffn: the VJP of grouped_ffn_ref
# --------------------------------------------------------------------------- #


def _ffn_inputs(N, D, F, E, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, D)) * 0.5).astype(np.float32)
    eid = rng.integers(-1, E, size=(N,)).astype(np.int32)
    w = [(rng.normal(size=s) * 0.05).astype(np.float32)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    g = rng.normal(size=(N, D)).astype(np.float32)
    return x, eid, w, g


@pytest.mark.parametrize("N,E,bt,scan", [(200, 4, 64, False), (96, 3, 32, False),
                                         (512, 8, 128, False), (7, 2, 32, False),
                                         (700, 4, 128, True)])
def test_grouped_ffn_vjp_matches_reference(N, E, bt, scan, monkeypatch):
    # up to 4 x block_tokens rows the reference takes its custom VJP
    # (_grouped_ffn: the Pallas kernel in interpret mode forward, the VJP of
    # grouped_ffn_ref backward); above that NIMBLE_FFN_IMPL=scan pins its
    # drop-free scan branch (native autodiff), as the default dense branch
    # drops by capacity.  f32 products of D and F terms in another order:
    # 1e-5 of each gradient's largest value
    if scan:
        monkeypatch.setenv("NIMBLE_FFN_IMPL", "scan")
    D, F = 32, 64
    x, eid, (wg, wu, wd), g = _ffn_inputs(N, D, F, E, seed=N + E)

    def port(x_, wg_, wu_, wd_):
        return grouped_ffn(x_, torch.as_tensor(eid), wg_, wu_, wd_, block_tokens=bt)

    out, grads = _vjp_torch(port, [x, wg, wu, wd], g)

    def ref(x_, wg_, wu_, wd_):
        return j_ffn_ops.grouped_ffn(x_, jnp.asarray(eid), wg_, wu_, wd_, block_tokens=bt,
                                     block_ffn=32)

    jout, vjp = jax.vjp(ref, *map(jnp.asarray, (x, wg, wu, wd)))
    jgrads = vjp(jnp.asarray(g))
    _close(out.numpy(), np.asarray(jout), 1e-5)
    for got, want in zip(grads, jgrads):
        _close(got.numpy(), np.asarray(want), 1e-5)
    assert (grads[0].numpy()[eid < 0] == 0).all()


def test_grouped_ffn_vjp_zero_for_unused_experts_and_all_padding():
    x, eid, (wg, wu, wd), g = _ffn_inputs(40, 16, 32, 4, seed=5)
    eid = np.where(eid == 2, 1, eid)                      # expert 2 gets no row
    _, (gx, gwg, gwu, gwd) = _vjp_torch(
        lambda *a: grouped_ffn(a[0], torch.as_tensor(eid), *a[1:], block_tokens=32),
        [x, wg, wu, wd], g)
    for gw in (gwg, gwu, gwd):
        assert (gw[2] == 0).all() and (gw[1] != 0).any()
    none = np.full_like(eid, -1)
    _, grads = _vjp_torch(
        lambda *a: grouped_ffn(a[0], torch.as_tensor(none), *a[1:], block_tokens=32),
        [x, wg, wu, wd], g)
    assert all((t == 0).all() for t in grads)


#: the bf16 backward's error against the float64 truth may be at most this
#: many times the reference's: the reference's VJP of ``grouped_ffn_ref``
#: rounds only its outputs to bf16, while the port's products also take
#: ``h``, ``da`` and ``db`` as bf16 operands (one more rounding each); with
#: ``a``, ``b`` and ``dh`` kept in float32 that costs 1.0-1.16x on the CPU
_BF16_FFN_VJP_RATIO = 1.5


def _ffn_truth_f64(x, eid, wg, wu, wd, g):
    """The VJP of ``grouped_ffn_ref`` in float64, by torch autograd."""
    live = [torch.as_tensor(a, dtype=torch.float64).requires_grad_(True)
            for a in (x, wg, wu, wd)]
    xx, gg, uu, dd = live
    out = torch.zeros_like(xx)
    e_id = torch.as_tensor(eid).long()
    for e in range(wg.shape[0]):
        y = (torch.nn.functional.silu(xx @ gg[e]) * (xx @ uu[e])) @ dd[e]
        out = torch.where((e_id == e)[:, None], y, out)
    return torch.autograd.grad(out, live, torch.as_tensor(g, dtype=torch.float64))


@pytest.mark.parametrize("N,D,F", [(512, 128, 256), (2048, 256, 512)])
def test_grouped_ffn_vjp_bf16_within_reference_error(N, D, F):
    # bf16 inputs and cotangent (the values both sides see); the port's
    # Function (plain forward, grouped_ffn_bwd) against jax.vjp of the
    # reference's grouped_ffn_ref, each measured against the float64 VJP on
    # the same bf16 values, as a fraction of each gradient's largest value
    E = 8
    x, eid, w, g = _ffn_inputs(N, D, F, E, seed=N + D)
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in (x, *w, g)]
    vals = [t.float().numpy() for t in bf]
    truth = _ffn_truth_f64(vals[0], eid, *vals[1:4], vals[4])
    live = [t.clone().requires_grad_(True) for t in bf[:4]]
    y = grouped_ffn(live[0], torch.as_tensor(eid), *live[1:], block_tokens=128)
    port = torch.autograd.grad(y, live, bf[4])
    _, vjp = jax.vjp(lambda *a: j_ffn_ref(a[0], jnp.asarray(eid), *a[1:]),
                     *(jnp.asarray(v, dtype=jnp.bfloat16) for v in vals[:4]))
    ref = vjp(jnp.asarray(vals[4], dtype=jnp.bfloat16))
    for name, p, r, t in zip(("x", "wg", "wu", "wd"), port, ref, truth):
        assert p.dtype == torch.bfloat16
        t = t.numpy()
        scale = np.abs(t).max()
        err_port = np.abs(p.float().numpy() - t).max() / scale
        err_ref = np.abs(np.asarray(r.astype(jnp.float32)) - t).max() / scale
        assert err_port <= _BF16_FFN_VJP_RATIO * err_ref, (
            f"g{name}: port {err_port:.3g} > {_BF16_FFN_VJP_RATIO} x reference {err_ref:.3g}")


# --------------------------------------------------------------------------- #
# flash attention: the VJP of chunked_attention
# --------------------------------------------------------------------------- #

_ATTN_CASES = {
    "causal": dict(causal=True, window=None, q_offset=0, sq=128, sk=128),
    "window": dict(causal=True, window=40, q_offset=0, sq=160, sk=160),
    "q_offset": dict(causal=True, window=None, q_offset=32, sq=128, sk=160),
    "window_offset": dict(causal=True, window=48, q_offset=32, sq=128, sk=160),
    "noncausal": dict(causal=False, window=None, q_offset=0, sq=128, sk=128),
}


@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
def test_flash_attention_vjp_matches_reference(case):
    # the reference's _attention_tpu VJP is jax.vjp of chunked_attention with
    # the same mask; GQA, 4 query heads over 2 kv heads.  f32 softmax sums in
    # another order: 1e-5 of each gradient's largest value
    c = dict(_ATTN_CASES[case])
    sq, sk = c.pop("sq"), c.pop("sk")
    rng = np.random.default_rng(sq + sk + (c["window"] or 0))
    q = rng.normal(size=(2, 4, sq, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, sk, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, sk, 16)).astype(np.float32)
    g = rng.normal(size=(2, 4, sq, 16)).astype(np.float32)
    out, grads = _vjp_torch(lambda *a: flash_attention(*a, **c), [q, k, v], g)
    jout, vjp = jax.vjp(lambda *a: j_chunked(*a, chunk=64, **c), *map(jnp.asarray, (q, k, v)))
    _close(out.numpy(), np.asarray(jout), 1e-5)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        _close(got.numpy(), np.asarray(want), 1e-5)


def test_attention_dispatch_differentiates_through_the_kernel_route():
    # Sq >= 128 takes the flash route on the card (route); every route's
    # gradient is the one attention Function's (attention_bwd from the saved
    # row statistics, one chunk here), whichever forward it ran, and equals
    # autograd's through the plain attention: the same f32 function
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32).requires_grad_(True)
               for s in ((1, 4, 128, 16), (1, 2, 128, 16), (1, 2, 128, 16)))
    assert route("cuda", 128, 128) == "flash_attention" and route("cpu", 128, 128) == "mha_ref"
    o = flash_attention(q, k, v, causal=True, window=64)
    assert type(o.grad_fn).__name__ == "_AttentionBackward"
    g = torch.as_tensor(rng.normal(size=o.shape), dtype=torch.float32)
    got = torch.autograd.grad(o, (q, k, v), g)
    routed = attention(q, k, v, True, 64, 0)
    assert type(routed.grad_fn).__name__ == "_AttentionBackward"
    assert torch.equal(routed, mha_ref(q, k, v, causal=True, window=64))
    plain = mha_ref(q, k, v, causal=True, window=64)
    assert type(plain.grad_fn).__name__ != "_AttentionBackward"
    want = torch.autograd.grad(plain, (q, k, v), g)
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy(), 1e-6)
    for a, b in zip(torch.autograd.grad(routed, (q, k, v), g), want):
        _close(a.numpy(), b.numpy(), 1e-6)
