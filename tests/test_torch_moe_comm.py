"""Port's MoE dispatch/combine over stacked ranks: closed-form checks.

The same checks as ``repro/launch/selftest.py:54-90`` (each expert scales
its tokens by ``global_id + 1``, so the combined output has a closed form),
run on the port's stacked ranks, plus the capacity-drop accounting.
"""

import numpy as np
import pytest
import torch

from repro.core import moe_comm as jmc
from repro_torch.core.moe_comm import MoECommConfig, MoEDispatcher
from repro_torch.core.planner import PlannerConfig

pytestmark = pytest.mark.torch_port

N_DEV, T, D, K, N_EXP = 8, 64, 16, 2, 16


def _inputs(seed=1):
    """The selftest's skewed routing: half the assignments hit experts 0-1."""
    n = N_DEV
    rng = np.random.default_rng(seed)
    toks = rng.normal(size=(n * T, D)).astype(np.float32)
    eidx = rng.integers(0, N_EXP, size=(n * T, K)).astype(np.int32)
    hot = rng.random((n * T, K)) < 0.5
    eidx = np.where(hot, rng.integers(0, 2, size=(n * T, K)), eidx).astype(np.int32)
    gw = rng.random((n * T, K)).astype(np.float32)
    return toks, eidx, gw


def _run(disp, toks, eidx, gw):
    n, epd = N_DEV, disp.cfg.experts_per_device
    recv, el, st = disp.dispatch(torch.as_tensor(toks).view(n, T, D),
                                 torch.as_tensor(eidx).view(n, T, K))
    rank = torch.arange(n)[:, None, None, None]
    scale = torch.where(el >= 0, (el + rank * epd + 1).float(), 0.0)
    out = disp.combine(recv * scale[..., None], st, torch.as_tensor(gw).view(n, T, K))
    return out.reshape(n * T, D).numpy(), st


def _kept_mask(eidx, cap_tok):
    """numpy: assignment (t, j) survives when it is among the first cap_tok
    assignments (in flat order) of its rank to its destination."""
    n, epd = N_DEV, N_EXP // N_DEV
    kept = np.zeros(eidx.shape, bool)
    for r in range(n):
        flat = eidx[r * T:(r + 1) * T].reshape(-1) // epd
        seen = np.zeros(n, int)
        for a, dest in enumerate(flat):
            kept[r * T + a // K, a % K] = seen[dest] < cap_tok
            seen[dest] += 1
    return kept


@pytest.mark.parametrize("mode,planner_cfg", [
    ("direct", None),
    ("nimble", None),
    # split_threshold 0 lets small messages take relay paths too
    ("nimble", PlannerConfig(split_threshold=0.0)),
    ("stripe", None),
])
def test_closed_form_no_drops(mode, planner_cfg):
    toks, eidx, gw = _inputs()
    cfg = MoECommConfig(n_devices=N_DEV, n_experts=N_EXP, d_model=D,
                        chunk_tokens=4, capacity_factor=8.0, mode=mode)
    y, st = _run(MoEDispatcher(cfg, planner_cfg=planner_cfg), toks, eidx, gw)
    yref = np.zeros_like(toks)
    for j in range(K):
        yref += gw[:, j:j + 1] * toks * (eidx[:, j:j + 1] + 1.0)
    # f32 products summed over k=2 in another order: 1e-4, as the selftest
    assert np.abs(y - yref).max() < 1e-4
    assert int(st["dropped"]) == 0


@pytest.mark.parametrize("mode", ["direct", "nimble"])
def test_overflow_drops_counted_and_kept_tokens_served(mode):
    toks, eidx, gw = _inputs(seed=4)
    cfg = MoECommConfig(n_devices=N_DEV, n_experts=N_EXP, d_model=D,
                        chunk_tokens=4, capacity_factor=1.0, mode=mode)
    disp = MoEDispatcher(cfg)
    y, st = _run(disp, toks, eidx, gw)
    kept = _kept_mask(eidx, disp.capacity_tokens(T * K))
    assert int(st["dropped"]) == int((~kept).sum()) > 0
    # every kept assignment gets its expert output, every dropped one none
    # (the reference's duplicate sideband write could erase a kept one)
    yref = np.zeros_like(toks)
    for j in range(K):
        yref += np.where(kept[:, j:j + 1],
                         gw[:, j:j + 1] * toks * (eidx[:, j:j + 1] + 1.0), 0.0)
    assert np.abs(y - yref).max() < 1e-4


@pytest.mark.parametrize("n_assign,cf,ct", [(128, 8.0, 4), (512, 2.0, 16), (8, 2.0, 16)])
def test_capacity_equals_reference(n_assign, cf, ct):
    kw = dict(n_devices=N_DEV, n_experts=N_EXP, d_model=D, chunk_tokens=ct,
              capacity_factor=cf)
    want = jmc.MoEDispatcher("x", jmc.MoECommConfig(**kw)).capacity_tokens(n_assign)
    assert MoEDispatcher(MoECommConfig(**kw)).capacity_tokens(n_assign) == want


def test_unowned_tokens_route_nowhere():
    """Replicated-token mode: each rank routes only the tokens it owns."""
    n = N_DEV
    toks, eidx, gw = _inputs(seed=6)
    toks, eidx, gw = toks[:T], eidx[:T], gw[:T]          # one copy per rank
    cfg = MoECommConfig(n_devices=n, n_experts=N_EXP, d_model=D, chunk_tokens=4,
                        capacity_factor=8.0)
    disp = MoEDispatcher(cfg)
    owned = (torch.arange(T) % n)[None, :] == torch.arange(n)[:, None]
    recv, el, st = disp.dispatch(torch.as_tensor(toks).expand(n, T, D),
                                 torch.as_tensor(eidx).expand(n, T, K),
                                 token_valid=owned)
    rank = torch.arange(n)[:, None, None, None]
    scale = torch.where(el >= 0, (el + rank * cfg.experts_per_device + 1).float(), 0.0)
    out = disp.combine(recv * scale[..., None], st,
                       torch.as_tensor(gw).expand(n, T, K)).sum(0).numpy()
    yref = np.zeros_like(toks)
    for j in range(K):
        yref += gw[:, j:j + 1] * toks * (eidx[:, j:j + 1] + 1.0)
    assert np.abs(out - yref).max() < 1e-4
    assert int(st["dropped"]) == 0
