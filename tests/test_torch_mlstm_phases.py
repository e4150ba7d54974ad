"""The CUDA mlstm_scan kernel's decomposition, as plain torch, against the reference.

``mlstm_scan_phases`` (below) writes the kernel's three launches
(``csrc/mlstm_scan.cu``) in torch: every chunk's state update at its own
stabilizer, the stabilizer chain with the prefix over chunks, and the
chunk-parallel output.  Here, on the CPU, it is
held against the JAX package's per-step oracle (``mlstm_scan_ref``), its
Pallas kernel in interpret mode (``mlstm_scan``) and the port's plain
version (``mlstm_scan_chunked_ref``), so an error in the algebra shows
before the kernel runs on the card (``test_torch_cuda.py`` holds the kernel
against the same plain version there).
"""

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan import mlstm_scan as j_mlstm_scan
from repro.kernels.mlstm_scan import mlstm_scan_ref as j_mlstm_scan_ref
from repro_torch.kernels.mlstm_scan.ops import State, _pad, init_state, mlstm_scan_chunked_ref

pytestmark = pytest.mark.torch_port

# f32 on both sides, sums in other orders: max|diff| <= 1e-4 x max|ref|
TOL = 1e-4


def mlstm_scan_phases(q, k, v, ig, lf, *, chunk: int = 64, state: Optional[State] = None,
                      parts: Optional[dict] = None) -> Tuple[torch.Tensor, State]:
    """The CUDA kernel's three launches as plain torch -> (h, final state).

    1. every chunk's own gates and its state update at its own stabilizer
       G = max_j g_j: dC' = sum_j e^{g_j - G} k_j v_j^T, dn' likewise;
    2. the stabilizer chain in chunk order (u_L = max(m, G), decay =
       e^{m - u_L}, scale = e^{G - u_L}, m <- Lf_L + u_L) and the prefix
       C_in(c + 1) = decay C_in(c) + scale dC'(c), n likewise;
    3. every chunk's output at once from its C_in, n_in and m_in.

    ``parts``, when given, receives the denominators ``den`` (before the
    floor) and the floors ``floor`` [B, H, chunks, L], and the chain's
    ``scale`` [B, H, chunks].
    """
    b, hh, s, dh = q.shape
    dv = v.shape[-1]
    st = state if state is not None else init_state(b, hh, dh, q.device, dv)
    q, k, v, ig, lf, L = _pad(q, k, v, ig, lf, chunk)
    nc = q.shape[2] // L
    qc, kc, vc = (a.reshape(b, hh, nc, L, a.shape[-1]) for a in (q, k, v))
    igc, lfc = (a.reshape(b, hh, nc, L) for a in (ig, lf))
    # 1. mlstm_delta
    Lf = torch.cumsum(lfc, dim=3)
    g = igc - Lf
    cm = torch.cummax(g, dim=3).values
    G = cm[..., -1]                                        # [B,H,nc]
    a = torch.exp(g - G[..., None])
    dC = torch.einsum("bhcj,bhcjd,bhcjp->bhcdp", a, kc, vc)
    dn = torch.einsum("bhcj,bhcjd->bhcd", a, kc)
    # 2. mlstm_prefix
    m, C, n = st["m"], st["C"], st["n"]
    m_in, C_in, n_in, scales = [], [], [], []
    for c in range(nc):
        u_L = torch.maximum(m, G[..., c])
        decay, scale = torch.exp(m - u_L), torch.exp(G[..., c] - u_L)
        m_in.append(m)
        scales.append(scale)
        C_in.append(C)
        n_in.append(n)
        C = decay[..., None, None] * C + scale[..., None, None] * dC[:, :, c]
        n = decay[..., None] * n + scale[..., None] * dn[:, :, c]
        m = Lf[..., c, -1] + u_L
    m_in, C_in, n_in = (torch.stack(x, dim=2) for x in (m_in, C_in, n_in))
    # 3. mlstm_out
    u = torch.maximum(m_in[..., None], cm)                 # [B,H,nc,L]
    w_in = torch.exp(m_in[..., None] - u)
    floor = torch.exp(-(Lf + u))
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    W = torch.exp(torch.where(causal, g[..., None, :] - u[..., :, None], float("-inf")))
    S = torch.einsum("bhctd,bhcjd->bhctj", qc, kc) * W
    num = torch.einsum("bhctj,bhcjp->bhctp", S, vc) \
        + w_in[..., None] * torch.einsum("bhctd,bhcdp->bhctp", qc, C_in)
    den = S.sum(dim=4) + w_in * torch.einsum("bhctd,bhcd->bhct", qc, n_in)
    h = num / torch.maximum(den.abs(), floor)[..., None]
    if parts is not None:
        parts.update(den=den, floor=floor, scale=torch.stack(scales, dim=2))
    return h.reshape(b, hh, nc * L, dv)[:, :, :s], {"C": C, "n": n, "m": m}


def _inputs(b, h, s, dh, seed, extreme=False):
    # the reference's kernel-test inputs (tests/test_mlstm_scan_kernel.py);
    # extreme: input gates around -5 with rare spikes to +8 and forget gates
    # near 1, so a chunk's own stabilizer often falls below the carried one
    # (the chain's scale < 1) and many denominators sit at their e^{-m} floor
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.normal(size=(b, h, s, dh)) * 0.3).astype(np.float32) for _ in range(3))
    if extreme:
        ig = rng.normal(size=(b, h, s)) * 3 - 5
        ig[rng.random(size=(b, h, s)) < 0.02] = 8.0
        fg = rng.normal(size=(b, h, s)) * 2 + 5
    else:
        ig = rng.normal(size=(b, h, s)) * 0.5
        fg = rng.normal(size=(b, h, s)) + 2.0
    lf = np.log(1.0 / (1.0 + np.exp(-fg)))
    return q, k, v, ig.astype(np.float32), lf.astype(np.float32)


def _within(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert np.isfinite(err) and err <= TOL * max(scale, 1e-30), \
        f"{what}: max|diff| {err:.3g} > {TOL:g} x {scale:.3g}"


def _pallas(q, k, v, ig, lf, chunk):
    # the Pallas kernel takes whole chunks: pad as xlstm.py:182-188 does
    s = q.shape[2]
    L = min(chunk, s)
    pad = -(-s // L) * L - s
    pad4 = ((0, 0), (0, 0), (0, pad), (0, 0))
    q, k, v = (np.pad(a, pad4) for a in (q, k, v))
    ig = np.pad(ig, pad4[:3], constant_values=-1e30)
    lf = np.pad(lf, pad4[:3])
    out = j_mlstm_scan(*map(jnp.asarray, (q, k, v, ig, lf)), chunk=L, interpret=True)
    return np.asarray(out)[:, :, :s]


def _against_everything(q, k, v, ig, lf, chunk, parts=None):
    t = [torch.as_tensor(a) for a in (q, k, v, ig, lf)]
    got, st = mlstm_scan_phases(*t, chunk=chunk, parts=parts)
    want, st_ref = mlstm_scan_chunked_ref(*t, chunk=chunk)
    _within(got, want, "h vs the port's mlstm_scan_chunked_ref")
    for key in ("C", "n", "m"):
        _within(st[key], st_ref[key], f"final {key} vs mlstm_scan_chunked_ref")
    _within(got, j_mlstm_scan_ref(*map(jnp.asarray, (q, k, v, ig, lf))),
            "h vs JAX mlstm_scan_ref (per step)")
    _within(got, _pallas(q, k, v, ig, lf, chunk), "h vs JAX mlstm_scan (Pallas, interpret)")
    return got, st


@pytest.mark.parametrize("b,h,s,dh,chunk", [
    (1, 2, 64, 16, 16),
    (2, 1, 128, 32, 64),
    (1, 2, 96, 16, 64),      # S not a multiple of the chunk: padded to 128
    (1, 1, 200, 32, 32),     # padded to 224
    (2, 2, 8, 16, 64),       # S below the chunk: L = 8
    (1, 1, 256, 48, 64),
])
def test_phases_match_the_reference(b, h, s, dh, chunk):
    _against_everything(*_inputs(b, h, s, dh, seed=s + dh + chunk), chunk)


@pytest.mark.parametrize("s,dh,chunk", [(128, 64, 32), (256, 16, 16), (300, 32, 64)])
def test_phases_with_extreme_gates(s, dh, chunk):
    parts = {}
    _against_everything(*_inputs(1, 2, s, dh, seed=1, extreme=True), chunk, parts)
    floored = (parts["floor"] > parts["den"].abs()).float().mean().item()
    assert 0.0 < floored < 1.0, f"the floor binds at a share {floored} of the steps"
    assert bool((parts["scale"] < 0.5).any()), "no chunk rescaled by the chain"


@pytest.mark.parametrize("split,chunk", [(64, 64), (100, 64), (37, 16)])
def test_phases_carry_a_state(split, chunk):
    # two calls chained through the carried state equal one call over the
    # whole sequence (the JAX oracles start from the zero state only)
    q, k, v, ig, lf = _inputs(1, 2, 192, 32, seed=split)
    t = [torch.as_tensor(a) for a in (q, k, v, ig, lf)]
    first, st_a = mlstm_scan_phases(*(a[:, :, :split] for a in t), chunk=chunk)
    second, st_b = mlstm_scan_phases(*(a[:, :, split:] for a in t), chunk=chunk, state=st_a)
    whole = torch.cat([first, second], dim=2)
    _within(whole, j_mlstm_scan_ref(*map(jnp.asarray, (q, k, v, ig, lf))),
            "chained h vs JAX mlstm_scan_ref")
    want, st_ref = mlstm_scan_chunked_ref(*(a[:, :, split:] for a in t), chunk=chunk,
                                          state=st_a)
    _within(second, want, "second call vs mlstm_scan_chunked_ref from the state")
    _, st_whole = mlstm_scan_chunked_ref(*t, chunk=chunk)
    for key in ("C", "n", "m"):
        _within(st_b[key], st_ref[key], f"final {key} vs mlstm_scan_chunked_ref")
        _within(st_b[key], st_whole[key], f"final {key} vs one call")


@pytest.mark.parametrize("dh,dv,chunk", [(192, 48, 64), (192, 96, 64), (32, 8, 16),
                                         (24, 6, 16)])
def test_phases_at_a_value_width_below_the_key_width(dh, dv, chunk):
    """The value columns of a model group's process (48 and 96 of a head of
    192 on model 16 and 8): the phases at dv < dk against the plain chunk
    loop, and against the JAX per-step oracle's columns of the whole head
    (every value column's recurrence reads all dk key columns, none of the
    other value columns)."""
    q, k, v, ig, lf = _inputs(1, 2, 160, dh, seed=dh + dv)
    t = [torch.as_tensor(a) for a in (q, k, v[..., :dv], ig, lf)]
    got, st = mlstm_scan_phases(*t, chunk=chunk)
    want, st_ref = mlstm_scan_chunked_ref(*t, chunk=chunk)
    _within(got, want, "h vs the port's mlstm_scan_chunked_ref")
    for key in ("C", "n", "m"):
        _within(st[key], st_ref[key], f"final {key} vs mlstm_scan_chunked_ref")
    whole = np.asarray(j_mlstm_scan_ref(*map(jnp.asarray, (q, k, v, ig, lf))))
    _within(got, whole[..., :dv], "h vs JAX mlstm_scan_ref's value columns")
