"""Multi-rank selftest: on the port's stacked ranks, or across processes.

    python -m repro_torch.launch.selftest                 # on the card
    python -m repro_torch.launch.selftest --device cpu
    python -m repro_torch.launch.selftest --procs 8 --device cpu   # 8 processes, gloo

Counterpart of ``repro/launch/selftest.py``, with the reference's three arms:

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

Without ``--procs`` every rank is stacked in this process.  ``--procs P``
runs the arms in ``P`` spawned processes (``launch/dist.py``; NCCL with a
card a process on the card, gloo on the CPU): arms 1-2 with the 8 ranks
over a ``(data 1, model P)`` mesh; arm 3 on a ``(data P / m, model m)``
mesh, ``m = gcd(P, 4)`` (the reference's ``(data 2, model 4)`` at ``P =
8``), every parameter and AdamW moment held as this process's block under
``sharding/specs.py::build_param_specs`` (gathered on use), the global
batch over data x model, held against EP 1 within 5e-2
and against the stacked EP 4 path within 1e-5 of each gradient leaf's
largest value.  Every process must agree (and build the same plans).

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
from ..core.dataplane import ref_all_to_allv
from ..core.moe_comm import MoECommConfig, MoEDispatcher
from ..models.registry import build_model
from ..optim import adamw
from ..sharding.context import ParallelContext
from ..train.step import loss_and_grads, make_train_step
from ..tree import leaves
from .dist_checks import exchange, exchange_inputs, rank_block


def _agree(value, group) -> bool:
    """Whether every process of ``group`` holds the same ``value``."""
    if group is None:
        return True
    import torch.distributed as dist

    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, value, group=group)
    return all(v == got[0] for v in got)


def dataplane_arm(device, n: int = 8, C: int = 16, E: int = 32, group=None):
    x_all, counts = exchange_inputs(n, C, E, 0, "f32")
    yref, rref = ref_all_to_allv(x_all, counts)
    blk = rank_block(group, n)
    out = []
    for mode, got in exchange(group, device, n=n, G=4, C=C, E=E).items():
        good = np.array_equal(got["y"], yref[blk]) and np.array_equal(got["recv"], rref[blk])
        good &= _agree(got["plan"], group)
        out.append((good, f"dataplane {mode}", ""))
    return out


def moe_comm_arm(device, n: int = 8, T: int = 64, d: int = 16, k: int = 2,
                 n_exp: int = 16, group=None):
    rng = np.random.default_rng(1)
    toks = rng.normal(size=(n * T, d)).astype(np.float32)
    eidx = rng.integers(0, n_exp, size=(n * T, k)).astype(np.int32)
    hot = rng.random((n * T, k)) < 0.5
    eidx = np.where(hot, rng.integers(0, 2, size=(n * T, k)), eidx).astype(np.int32)
    gw = rng.random((n * T, k)).astype(np.float32)
    yref = np.zeros_like(toks)
    for j in range(k):
        yref += gw[:, j:j + 1] * toks * (eidx[:, j:j + 1] + 1.0)
    blk = rank_block(group, n)
    r0, L = blk.start, blk.stop - blk.start
    rows = slice(r0 * T, (r0 + L) * T)
    out = []
    for mode in ("direct", "nimble"):
        cfg = MoECommConfig(n_devices=n, n_experts=n_exp, d_model=d, chunk_tokens=4,
                            capacity_factor=8.0, mode=mode)
        disp = MoEDispatcher(cfg, group=group)
        recv, el, st = disp.dispatch(
            torch.as_tensor(toks[rows], device=device).view(L, T, d),
            torch.as_tensor(eidx[rows], device=device).view(L, T, k))
        rank = r0 + torch.arange(L, device=device)[:, None, None, None]
        scale = torch.where(el >= 0, (el + rank * cfg.experts_per_device + 1).float(), 0.0)
        y = disp.combine(recv * scale[..., None], st,
                         torch.as_tensor(gw[rows], device=device).view(L, T, k))
        err = float(np.abs(y.reshape(L * T, d).cpu().numpy() - yref[rows]).max())
        good = err < 1e-4
        out.append((good, f"moe_comm {mode}", f" (max|err| {err:.3g})"))
    return out


def ep_train_config():
    return dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), n_experts=8,
                               top_k=2, moe_capacity_factor=8.0)


def ep_train_batch(cfg, device):
    rng = np.random.default_rng(0)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (8, 32)), device=device)
            for k in ("tokens", "labels")}


def _worst(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30)) for a, b in zip(got, want))


def ep_train_arm(device):
    cfg = ep_train_config()
    ctx = ParallelContext(ep_size=4, group_size=2, moe_mode="nimble", device=device)
    batch = ep_train_batch(cfg, device)
    model = build_model(cfg, ctx)
    params = model.init(0)
    one = build_model(cfg, dataclasses.replace(ctx, ep_size=1))
    stats = {}
    l_ep, g_ep = loss_and_grads(model, params, batch, stats=stats)
    l_1, g_1 = loss_and_grads(one, params, batch)
    dropped = int(stats["dropped"])
    pairs = list(zip(leaves(g_ep), leaves(g_1)))
    exact = torch.equal(l_ep, l_1) and all(torch.equal(a, b) for a, b in pairs)
    worst = _worst(leaves(g_ep), leaves(g_1))
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


def ep_train_dist(device, mesh, tree=None, ep_size: int = 4):
    """This process's train step on ``mesh`` on ``ep_size`` EP ranks (in
    groups of 2), from seed 0's weights or the reference's ``tree`` (numpy,
    through ``params_from_jax``): (global loss, dropped, its gradient leaves
    as arrays, its mesh coordinate, a full step's metrics)."""
    from ..weights import params_from_jax

    cfg = ep_train_config()
    ctx = ParallelContext(mesh=mesh, ep_size=ep_size, group_size=2, moe_mode="nimble",
                          device=device)
    model = build_model(cfg, ctx)
    params = model.init(0) if tree is None else params_from_jax(tree, cfg, ctx)
    batch = ep_train_batch(cfg, device)
    stats = {}
    loss, grads = loss_and_grads(model, params, batch, stats=stats)
    _, _, m = make_train_step(model, adamw.AdamWConfig())(params, adamw.init(params), batch)
    return dict(loss=float(loss), dropped=int(stats["dropped"]),
                grads=[g.float().cpu().numpy() for g in leaves(grads)],
                coord=dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
                step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


def assemble_grads(results, params_like, key: str = "grads") -> list:
    """Whole leaves from the processes' blocks (:func:`ep_train_dist` or
    ``dist_checks.rows`` results: ``results[i][key]`` in leaf order, and
    ``coord``): each leaf put together from the blocks its spec
    (``build_param_specs`` over the processes' mesh) splits it into, as
    ``sharding.specs.local_shard`` cuts them."""
    from ..sharding.specs import at_path, build_param_specs, leaf_paths, unshard

    sizes = {a: 1 + max(r["coord"][a] for r in results) for a in results[0]["coord"]}
    specs = build_param_specs(params_like, sizes)
    at = {tuple(sorted(r["coord"].items())): r[key] for r in results}

    def leaf(i, spec):
        def block(coord):
            return at[tuple(sorted({a: coord.get(a, 0) for a in sizes}.items()))][i]
        return unshard(block, spec, sizes)

    return [leaf(i, at_path(specs, path))
            for i, (path, _) in enumerate(leaf_paths(params_like))]


def _procs_worker(rank: int, world: int, device: str):
    """One process of ``--procs``: the three arms; -> ([(ok, label, detail)] of
    arms 1-2, arm 3's :func:`ep_train_dist`)."""
    from .mesh import ep_mesh_shape, make_test_mesh

    if device != "cpu":
        device = f"cuda:{rank}"
    line = make_test_mesh(world, world)
    out = dataplane_arm(device, group=line.get_group("model"))
    out += moe_comm_arm(device, group=line.get_group("model"))
    return out, ep_train_dist(device, make_test_mesh(world, ep_mesh_shape(world, 4)[1]))


def procs_main(procs: int, device: str) -> bool:
    from .dist import spawn
    from .mesh import ep_mesh_shape

    backend = "gloo" if device == "cpu" else "nccl"
    results = spawn(_procs_worker, procs, device, backend=backend, timeout_s=600)
    ok = True
    for i, (_, label, detail) in enumerate(results[0][0]):
        good = all(r[0][i][0] for r in results)
        print(f"[selftest] {label} ({procs} processes): {'OK' if good else 'FAIL'}"
              f"{detail}", flush=True)
        ok &= good
    # the EP train arm: against EP 1 and the stacked EP 4 path, on this process
    cfg = ep_train_config()
    dev = device if device == "cpu" else "cuda"
    ctx = ParallelContext(ep_size=4, group_size=2, moe_mode="nimble", device=dev)
    model = build_model(cfg, ctx)
    params = model.init(0)
    batch = ep_train_batch(cfg, dev)
    l_st, g_st = loss_and_grads(model, params, batch)
    l_1, _ = loss_and_grads(build_model(cfg, dataclasses.replace(ctx, ep_size=1)),
                            params, batch)
    dists = [r[1] for r in results]
    got = [torch.as_tensor(g) for g in assemble_grads(dists, params)]
    worst = _worst(got, [g.cpu() for g in leaves(g_st)])
    loss = dists[0]["loss"]
    same = all(r["loss"] == loss for r in dists)
    dropped = dists[0]["dropped"]
    good = (same and np.isfinite(loss) and abs(loss - float(l_1)) < 5e-2 and dropped == 0
            and worst <= 1e-5 and abs(loss - float(l_st)) <= 1e-6 * abs(float(l_st))
            and all(np.isfinite(r["step_loss"]) for r in dists))
    data, model_n = ep_mesh_shape(procs, 4)
    print(f"[selftest] EP train step ({procs} processes, mesh data {data} x model {model_n}, "
          f"ep 4 in groups of 2): loss_ep={loss:.4f} loss_single={float(l_1):.4f} "
          f"loss_stacked={float(l_st):.4f} dropped {dropped}, gradients against the "
          f"stacked EP 4 path worst leaf {worst:.3g} of its max, the processes' losses "
          f"{'equal' if same else 'DIFFER'} {'OK' if good else 'FAIL'}", flush=True)
    return ok and good


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's multi-rank selftest")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=None,
                    help="run the arms across this many processes (a card each on the "
                         "card, gloo on the CPU)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the selftest runs on the card; pass --device cpu "
                 "to run it on the host")
    if args.procs is not None:
        ok = procs_main(args.procs, args.device)
    else:
        ok = True
        for arm in (dataplane_arm, moe_comm_arm):
            for good, label, detail in arm(args.device):
                print(f"[selftest] {label}: {'OK' if good else 'FAIL'}{detail}", flush=True)
                ok &= good
        ok = ok and ep_train_arm(args.device)
    print(f"[selftest] {'ALL OK' if ok else 'FAILURES'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
