"""The multi-process paths' cases, each run in every process of a world.

    from repro_torch.launch.dist import spawn
    from repro_torch.launch import dist_checks
    out = spawn(dist_checks.run_cases, P, [("x", "exchange", dict(n=8, G=4)), ...])

``run_cases`` runs the named cases in order in each process and returns
``{name: result}``; each result holds this process's block of the outputs
as numpy arrays, which the caller holds against the stacked path (every
rank in one process) and the numpy oracle.  Inputs are made from seeds
here, so the caller makes the same ones (``exchange_inputs``,
``layer_inputs``).  The cases:

  * ``exchange`` — :class:`NimbleAllToAll` in each mode on this process's
    block of ``[n, n, C, E]`` buffers: ``y``, ``recv``, the plan's digest,
    the messages sent a hop;
  * ``baseline`` — :func:`baseline_all_to_all` on the same block;
  * ``layer`` — the MoE layer (``make_moe_ffn``: router, dispatch, grouped
    FFN, combine) on this process's rows, forward and the gradients of
    ``sum(y * cot) + aux / P`` with respect to its tokens, the router and
    its expert leaves;
  * ``masked`` — the layer on tokens replicated over the model group (the
    masked branch): forward, and whether it raises under a gradient;
  * ``train`` — the EP train step of reduced granite on a ``(data, model)``
    mesh from a given weight tree (``params_from_jax``).

Every case builds its mesh over the whole world: ``(data 1, model P)``
unless it says otherwise.  The functions live in the package so that
spawned children can import them.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

MODES = ("direct", "stripe", "nimble")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def exchange_inputs(n: int, C: int, E: int, seed: int, dtype: str):
    """Buffers ``[n, n, C, E]`` (zero past each count, values exact in
    ``dtype``) and counts ``[n, n]``."""
    rng = np.random.default_rng(seed)
    x_all = rng.normal(size=(n, n, C, E)).astype(np.float32)
    counts = rng.integers(0, C + 1, size=(n, n)).astype(np.int32)
    for s in range(n):
        for d in range(n):
            x_all[s, d, counts[s, d]:] = 0.0
    x_all = torch.as_tensor(x_all).to(DTYPES[dtype]).float().numpy()
    return x_all, counts


def rank_block(group, n: int) -> slice:
    """This process's block of ``n`` ranks in ``group`` (all without one)."""
    if group is None:
        return slice(0, n)
    import torch.distributed as dist

    L = n // dist.get_world_size(group)
    r0 = dist.get_rank(group) * L
    return slice(r0, r0 + L)


def plan_digest(plan: torch.Tensor) -> str:
    return hashlib.sha256(plan.cpu().numpy().tobytes()).hexdigest()[:16]


def exchange(group, device, n=8, G=4, C=16, E=32, seed=0, dtype="f32",
             chunk_bytes=None) -> Dict[str, dict]:
    from ..core.dataplane import NimbleAllToAll

    x_all, counts = exchange_inputs(n, C, E, seed, dtype)
    blk = rank_block(group, n)
    out = {}
    for mode in MODES:
        comm = NimbleAllToAll(n, G, max_chunks=C, mode=mode, group=group,
                              chunk_bytes=float(chunk_bytes or E * 4))
        y, r = comm(torch.as_tensor(x_all[blk], device=device).to(DTYPES[dtype]),
                    torch.as_tensor(counts[blk], device=device))
        plan = comm.plan_from_counts(comm.gather_counts(
            torch.as_tensor(counts[blk], device=device)))
        out[mode] = dict(y=y.float().cpu().numpy(), recv=r.cpu().numpy(),
                         plan=plan_digest(plan), dtype=str(y.dtype),
                         messages_per_hop=comm.messages_per_hop)
    return out


def baseline(group, device, n=8, C=16, E=32, seed=0) -> np.ndarray:
    from ..core.dataplane import baseline_all_to_all

    x_all, _ = exchange_inputs(n, C, E, seed, "f32")
    return baseline_all_to_all(torch.as_tensor(x_all[rank_block(group, n)], device=device),
                               group).cpu().numpy()


def layer_config(n_experts: int = 8):
    from ..configs.base import get_config

    return dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                               n_experts=n_experts, top_k=2, d_model=32, d_ff=64,
                               moe_capacity_factor=8.0)


def layer_inputs(cfg, B: int, S: int, seed: int = 0):
    """(params of one MoE layer: router, wg, wu, wd; tokens [B, S, D]; the
    output's cotangent) from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": torch.randn(D, E, generator=g) * D ** -0.5,
         "wg": torch.randn(E, D, F, generator=g) * D ** -0.5,
         "wu": torch.randn(E, D, F, generator=g) * D ** -0.5,
         "wd": torch.randn(E, F, D, generator=g) * F ** -0.5}
    return p, torch.randn(B, S, D, generator=g), torch.randn(B, S, D, generator=g)


def _expert_block(p, group, n_experts) -> dict:
    """The layer's params with the expert leaves cut to this process's block."""
    import torch.distributed as dist

    e = n_experts // dist.get_world_size(group)
    e0 = dist.get_rank(group) * e
    return {k: v if k == "router" else v[e0:e0 + e] for k, v in p.items()}


def layer_grads(apply, p, x, cot, share: float = 1.0) -> dict:
    """``apply``'s output and the gradients of ``sum(y * cot) + share * aux``:
    over processes holding shares of the batch, their objectives sum to the
    stacked one's (the load-balance loss is the global batch's)."""
    live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    xl = x.detach().requires_grad_(True)
    y, aux, dropped = apply(live, xl)
    g = torch.autograd.grad((y * cot).sum() + aux * share,
                            [xl] + [live[k] for k in sorted(live)])
    out = {"y": y.detach().cpu().numpy(), "aux": float(aux.detach()),
           "dropped": int(dropped), "x": g[0].cpu().numpy()}
    out.update({k: t.cpu().numpy() for k, t in zip(sorted(live), g[1:])})
    return out


def _layer_ctx(mesh, n, G, mode, device):
    from ..sharding.context import ParallelContext

    return ParallelContext(mesh=mesh, ep_size=n, group_size=G, moe_mode=mode,
                           moe_chunk_tokens=4, device=str(device))


def _on(device, *ts):
    return [{k: v.to(device) for k, v in t.items()} if isinstance(t, dict) else t.to(device)
            for t in ts]


def layer(group, device, mesh=None, n=8, G=4, B=4, S=16, mode="nimble", seed=0) -> dict:
    from ..models.moe import make_moe_ffn

    cfg = layer_config()
    p, x, cot = _on(device, *layer_inputs(cfg, B, S, seed))
    ctx = _layer_ctx(mesh, n, G, mode, device)
    idx, count = ctx.token_block
    b = B // count
    mine = _expert_block(p, group, cfg.n_experts)
    rows = slice(idx * b, (idx + 1) * b)
    return layer_grads(make_moe_ffn(cfg, ctx), mine, x[rows], cot[rows], 1.0 / count)


def masked(group, device, mesh=None, n=4, G=2, N=3, mode="nimble", seed=0) -> dict:
    """The masked branch: every process holds the same N tokens."""
    from ..models.moe import make_moe_ffn

    cfg = layer_config()
    p, x, _ = _on(device, *layer_inputs(cfg, 1, N, seed))
    ctx = _layer_ctx(mesh, n, G, mode, device)
    mine = _expert_block(p, group, cfg.n_experts)
    apply = make_moe_ffn(cfg, ctx)
    with torch.no_grad():
        y, aux, dropped = apply(mine, x)
    try:
        live = {k: v.detach().requires_grad_(True) for k, v in mine.items()}
        apply(live, x)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    return {"y": y.cpu().numpy(), "aux": float(aux), "dropped": int(dropped), "raised": raised}


def train(group, device, tree=None, data=2, model=4, ep_size=4) -> dict:
    """The selftest's train step (reduced granite, 8 experts, top-2, on
    ``ep_size`` EP ranks in groups of 2) on a ``(data, model)`` mesh from the
    weight tree ``tree`` (numpy, the reference's layout)."""
    from .mesh import make_test_mesh
    from .selftest import ep_train_dist

    return ep_train_dist(device, make_test_mesh(data * model, model), tree, ep_size)


CASES = {"exchange": exchange, "baseline": baseline, "layer": layer, "masked": masked,
         "train": train}


def run_cases(rank: int, world: int, cases: List[Tuple[str, str, dict]],
              device: str = "cpu") -> dict:
    """Run ``cases`` (key, case name, keyword arguments) in this process on a
    ``(data 1, model world)`` mesh; -> {key: result}."""
    from .mesh import make_test_mesh

    mesh = make_test_mesh(world, world)
    group = mesh.get_group("model")
    out = {}
    for key, name, kw in cases:
        if name in ("layer", "masked"):
            kw = dict(kw, mesh=mesh)
        out[key] = CASES[name](group, device, **kw)
    return out
