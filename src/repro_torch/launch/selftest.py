"""Multi-rank selftest on the port's stacked ranks.

    python -m repro_torch.launch.selftest                 # on the card
    python -m repro_torch.launch.selftest --device cpu

Counterpart of ``repro/launch/selftest.py``, with the reference's three arms
on one device (the EP group's ranks stacked on a leading axis, as the port's
dataplane runs them):

  1. the NIMBLE dataplane in the ``direct``, ``stripe`` and ``nimble`` modes
     (8 ranks, groups of 4), bit-exact against the numpy oracle
     ``ref_all_to_allv``;
  2. MoE dispatch/combine in the ``direct`` and ``nimble`` modes under skew
     against the dense per-token closed form (each expert scales its tokens
     by its global id + 1), within 1e-4;
  3. an EP train step of reduced ``granite-moe-1b-a400m`` (8 experts, top-2)
     on EP 4 in groups of 2 against EP 1: the loss finite and within the
     reference's 5e-2 of EP 1's.  At a capacity that drops nothing (checked)
     each expert's rows arrive in the same order on both, so the port also
     holds every gradient leaf within 1e-5 of its largest value (the CPU's
     embedding backward sums a token's rows in a thread-dependent order) and
     prints whether loss and gradients are equal bit for bit (on the card
     they are).

Prints one line an arm and ``[selftest] ALL OK``, returning 0, or
``[selftest] FAILURES``, returning 1.  Runs on ``--device`` (the card by
default; without one it exits non-zero unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ..configs.base import get_config
from ..core.dataplane import NimbleAllToAll, ref_all_to_allv
from ..core.moe_comm import MoECommConfig, MoEDispatcher
from ..models.registry import build_model
from ..optim import adamw
from ..sharding.context import ParallelContext
from ..train.step import loss_and_grads, make_train_step
from ..tree import leaves


def dataplane_arm(device, n: int = 8, C: int = 16, E: int = 32) -> bool:
    rng = np.random.default_rng(0)
    x_all = rng.normal(size=(n, n, C, E)).astype(np.float32)
    counts = rng.integers(0, C + 1, size=(n, n)).astype(np.int32)
    for s in range(n):
        for d in range(n):
            x_all[s, d, counts[s, d]:] = 0.0
    yref, rref = ref_all_to_allv(x_all, counts)
    ok = True
    for mode in ("direct", "stripe", "nimble"):
        comm = NimbleAllToAll(n, 4, max_chunks=C, chunk_bytes=E * 4, mode=mode)
        y, r = comm(torch.as_tensor(x_all, device=device), torch.as_tensor(counts, device=device))
        good = np.array_equal(y.cpu().numpy(), yref) and np.array_equal(r.cpu().numpy(), rref)
        print(f"[selftest] dataplane {mode}: {'OK' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


def moe_comm_arm(device, n: int = 8, T: int = 64, d: int = 16, k: int = 2,
                 n_exp: int = 16) -> bool:
    rng = np.random.default_rng(1)
    toks = rng.normal(size=(n * T, d)).astype(np.float32)
    eidx = rng.integers(0, n_exp, size=(n * T, k)).astype(np.int32)
    hot = rng.random((n * T, k)) < 0.5
    eidx = np.where(hot, rng.integers(0, 2, size=(n * T, k)), eidx).astype(np.int32)
    gw = rng.random((n * T, k)).astype(np.float32)
    yref = np.zeros_like(toks)
    for j in range(k):
        yref += gw[:, j:j + 1] * toks * (eidx[:, j:j + 1] + 1.0)
    ok = True
    for mode in ("direct", "nimble"):
        cfg = MoECommConfig(n_devices=n, n_experts=n_exp, d_model=d, chunk_tokens=4,
                            capacity_factor=8.0, mode=mode)
        disp = MoEDispatcher(cfg)
        recv, el, st = disp.dispatch(torch.as_tensor(toks, device=device).view(n, T, d),
                                     torch.as_tensor(eidx, device=device).view(n, T, k))
        rank = torch.arange(n, device=device)[:, None, None, None]
        scale = torch.where(el >= 0, (el + rank * cfg.experts_per_device + 1).float(), 0.0)
        y = disp.combine(recv * scale[..., None], st,
                         torch.as_tensor(gw, device=device).view(n, T, k))
        err = float(np.abs(y.reshape(n * T, d).cpu().numpy() - yref).max())
        good = err < 1e-4
        print(f"[selftest] moe_comm {mode}: {'OK' if good else 'FAIL'} (max|err| {err:.3g})",
              flush=True)
        ok &= good
    return ok


def ep_train_arm(device) -> bool:
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), n_experts=8,
                              top_k=2, moe_capacity_factor=8.0)
    ctx = ParallelContext(ep_size=4, group_size=2, moe_mode="nimble", device=device)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (8, 32)), device=device)
             for k in ("tokens", "labels")}
    model = build_model(cfg, ctx)
    params = model.init(0)
    one = build_model(cfg, dataclasses.replace(ctx, ep_size=1))
    stats = {}
    l_ep, g_ep = loss_and_grads(model, params, batch, stats=stats)
    l_1, g_1 = loss_and_grads(one, params, batch)
    dropped = int(stats["dropped"])
    pairs = list(zip(leaves(g_ep), leaves(g_1)))
    exact = torch.equal(l_ep, l_1) and all(torch.equal(a, b) for a, b in pairs)
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in pairs)
    _, _, metrics = make_train_step(model, adamw.AdamWConfig())(
        params, adamw.init(params), batch)
    loss_ep, loss_1 = float(l_ep), float(l_1)
    good = (np.isfinite(loss_ep) and abs(loss_ep - loss_1) < 5e-2 and dropped == 0
            and worst <= 1e-5 and np.isfinite(float(metrics["loss"])))
    print(f"[selftest] EP train step: loss_ep={loss_ep:.4f} loss_single={loss_1:.4f} "
          f"dropped {dropped}, gradients worst leaf {worst:.3g} of its max, loss and "
          f"gradients {'equal' if exact else 'not equal'} bit for bit "
          f"{'OK' if good else 'FAIL'}", flush=True)
    return good


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's multi-rank selftest")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the selftest runs on the card; pass --device cpu "
                 "to run it on the host")
    ok = (dataplane_arm(args.device) and moe_comm_arm(args.device)
          and ep_train_arm(args.device))
    print(f"[selftest] {'ALL OK' if ok else 'FAILURES'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
