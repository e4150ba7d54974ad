"""Port kernels' plain versions against the JAX package's kernels.

On the CPU each port wrapper runs its kernel's plain version, so these tests
hold that plain version against the reference's ``ref.py`` oracle and its
Pallas kernel in interpret mode, as the reference's own tests run them.
The CUDA kernels themselves are held against the same plain versions on
the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash import flash_attention as j_flash
from repro.kernels.flash_attention.ref import mha_ref as j_mha_ref
from repro.kernels.grouped_ffn import ops as j_ffn_ops
from repro.kernels.grouped_ffn.ffn import grouped_ffn_blocked as j_blocked
from repro.kernels.grouped_ffn.ref import grouped_ffn_ref as j_ffn_ref
from repro.kernels.token_scatter.ops import token_gather as j_gather
from repro.kernels.token_scatter.ref import token_gather_ref as j_gather_ref
from repro_torch.kernels.flash_attention.ops import attention, flash_attention, mha_ref
from repro_torch.kernels.grouped_ffn import ops as t_ffn_ops
from repro_torch.kernels.token_scatter.ops import token_gather

pytestmark = pytest.mark.torch_port

_DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _both(a: np.ndarray, dt: str):
    """The same values in both frameworks (bf16 rounds alike: nearest even)."""
    tdt, jdt = _DT[dt]
    return torch.as_tensor(a).to(tdt), jnp.asarray(a, dtype=jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --------------------------------------------------------------------------- #
# token_gather
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,m,d", [(64, 100, 32), (16, 16, 128), (128, 7, 8)])
def test_token_gather_matches_reference(n, m, d, dt):
    rng = np.random.default_rng(n + m)
    xt, xj = _both(rng.normal(size=(n, d)).astype(np.float32), dt)
    idx = rng.integers(-1, n, size=(m,)).astype(np.int32)
    idx[::3] = -1                                      # zero rows
    got = token_gather(xt, torch.as_tensor(idx))
    assert got.dtype == xt.dtype
    # a copy: bit-exact against the oracle and the interpret-mode kernel
    np.testing.assert_array_equal(_np(got), _np(j_gather_ref(xj, jnp.asarray(idx))))
    np.testing.assert_array_equal(_np(got), _np(j_gather(xj, jnp.asarray(idx))))


# --------------------------------------------------------------------------- #
# grouped FFN
# --------------------------------------------------------------------------- #


def _ffn_inputs(N, D, F, E, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, D)) * 0.5).astype(np.float32)
    eid = rng.integers(-1, E, size=(N,)).astype(np.int32)
    w = [(rng.normal(size=s) * 0.05).astype(np.float32)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, eid, w


@pytest.mark.parametrize("N,E,bt", [(200, 4, 64), (64, 3, 32), (7, 2, 32)])
def test_arrange_equals_reference(N, E, bt):
    _, eid, _ = _ffn_inputs(N, 8, 8, E, seed=N)
    jo, jp, jb, jm = j_ffn_ops._arrange(jnp.asarray(eid), E, bt)
    to, tp, tb, tm = t_ffn_ops._arrange(torch.as_tensor(eid), E, bt)
    assert tm == jm
    for a, b in ((to, jo), (tp, jp), (tb, jb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("N,E", [(200, 4), (100, 2)])
def test_grouped_ffn_matches_reference(N, E):
    # N <= 4 * block_tokens, so the reference takes its blocked Pallas kernel
    # (interpret mode); f32 sums in another order: 1e-5 relative
    D, F, bt = 32, 64, 64
    x, eid, (wg, wu, wd) = _ffn_inputs(N, D, F, E, seed=E)
    want = j_ffn_ops.grouped_ffn(*map(jnp.asarray, (x, eid, wg, wu, wd)),
                                 block_tokens=bt, block_ffn=32)
    got = t_ffn_ops.grouped_ffn(*map(torch.as_tensor, (x, eid, wg, wu, wd)),
                                block_tokens=bt)
    oracle = j_ffn_ref(*map(jnp.asarray, (x, eid, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-6)
    assert (got.numpy()[eid < 0] == 0).all()


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_blocked_plain_matches_pallas_kernel(dt, tol):
    # per-block expert ids, zero blocks past the last segment included;
    # bf16: inputs and output round to bf16 alike, sums differ in order
    D, F, E, bt = 32, 64, 3, 32
    x, _, (wg, wu, wd) = _ffn_inputs(4 * bt, D, F, E, seed=11)
    x[3 * bt:] = 0.0                                   # an all-zero block
    be = np.array([2, 0, 1, 2], np.int32)
    xt, xj = _both(x, dt)
    ws = [_both(w, dt) for w in (wg, wu, wd)]
    want = j_blocked(xj, jnp.asarray(be), *(w[1] for w in ws), block_tokens=bt,
                     block_ffn=32, interpret=True)
    got = t_ffn_ops.grouped_ffn_blocked(xt, torch.as_tensor(be), *(w[0] for w in ws),
                                        block_tokens=bt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 0.1)
    assert (_np(got)[3 * bt:] == 0).all()


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #

_FLASH_CASES = {
    "causal": dict(causal=True, window=None, q_offset=0, sq=64, sk=64),
    "window": dict(causal=True, window=24, q_offset=0, sq=64, sk=64),
    "q_offset": dict(causal=True, window=None, q_offset=32, sq=32, sk=64),
    "window_offset": dict(causal=True, window=16, q_offset=32, sq=32, sk=64),
    "noncausal": dict(causal=False, window=None, q_offset=0, sq=64, sk=64),
}


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_attention_matches_reference(case, dt, tol):
    # GQA: 4 query heads over 2 kv heads.  f32: softmax sums in another
    # order, 1e-5; bf16: output rounding, 2e-2 absolute on O(1) values
    c = dict(_FLASH_CASES[case])
    sq, sk = c.pop("sq"), c.pop("sk")
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(1, 4, sq, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, sk, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, sk, 16)).astype(np.float32)
    (qt, qj), (kt, kj), (vt, vj) = _both(q, dt), _both(k, dt), _both(v, dt)
    got = flash_attention(qt, kt, vt, **c)             # CPU: the plain version
    assert got.dtype == qt.dtype
    want = j_flash(qj, kj, vj, bq=32, bk=32, interpret=True, **c)
    oracle = j_mha_ref(qj, kj, vj, **c)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=0)
    np.testing.assert_array_equal(_np(mha_ref(qt, kt, vt, **c)), _np(got))
    np.testing.assert_array_equal(_np(attention(qt, kt, vt, **c)), _np(got))


def test_cuda_wrappers_refuse_a_foreign_device():
    # the kernels run only on the card; off it, outside the CPU, they raise
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        token_gather(x, torch.zeros(2, dtype=torch.int64, device="meta"))
