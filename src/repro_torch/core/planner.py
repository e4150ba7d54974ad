"""Execution-time planner — the fixed-iteration multiplicative-weights MCF.

PyTorch counterpart of ``repro/core/planner.py``: Algorithm 1 as a
**fixed-T, vectorized** MWU loop over plain tensor ops, so it re-plans from
the live demand matrix on whatever device the demand lives on, with no host
round trip.

All pairs route a λ-fraction of their residual simultaneously each
iteration; after T iterations the residual is dumped on the least-hop alive
path.  Pricing and charging run against the per-pair candidate rows of the
shared :class:`~repro_torch.core.incidence.PathIncidence`.

Determinism: the load accumulation (JAX's ``segment_sum``) is an
``index_put_(..., accumulate=True)``.  On CUDA that op sorts the indices and
sums each resource's contributions in a fixed order, so the loads do not
change from run to run — unlike ``index_add_``, whose float atomics add in
a varying order and can flip the argmin between near-equal costs.
``torch.argmin`` keeps the first minimal index, as ``jnp.argmin`` does.  On
the CPU the plans equal JAX's bit for bit, and on the card they equal the
CPU's (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Tuple

import numpy as np
import torch

from .schedule import PlannerTables

_BIG = 1e30
# price tiers above any real path cost: a small-message-gated relay path is
# preferable to a *down* path, which is preferable to K-padding.
_BIG_DOWN = 1e32
_BIG_INVALID = 1e34
#: paths whose bottleneck capacity falls below this are treated as down
_DEAD_PATH_CAP = 1.0


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    lam: float = 0.25            # λ — fraction of residual routed per visit
    n_iters: int = 24            # T — static MWU iterations
    chunk_bytes: float = float(1 << 20)  # ε — quantization granularity
    split_threshold: float = float(1 << 20)  # paper: <=1 MB never splits


@dataclasses.dataclass(frozen=True)
class _DeviceTables:
    """The incidence tables' per-pair candidate rows, as tensors on a device."""

    caps: torch.Tensor       # [R] f32
    rids: torch.Tensor       # [n*n, K, MC] int64
    mult: torch.Tensor       # [n*n, K, MC] f32
    mask: torch.Tensor       # [n*n, K, MC] f32
    pen: torch.Tensor        # [n*n, K] f32
    relay: torch.Tensor      # [n*n, K] bool
    down: torch.Tensor       # [n*n, K] bool
    invalid: torch.Tensor    # [n*n, K] bool
    k_dump: torch.Tensor     # [n*n] int64 — least-hop alive candidate


_DEVICE_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_DEVICE_CACHE_CAP = 64


def device_tables(tables: PlannerTables, device) -> _DeviceTables:
    """Cached tensor copy of ``tables``' candidate rows on ``device``.

    Keyed by the tables object's identity; the cache entry holds a
    reference to the tables so the identity cannot be reused while cached.
    """
    device = torch.device(device)
    key = (id(tables), str(device))
    hit = _DEVICE_CACHE.get(key)
    if hit is not None:
        _DEVICE_CACHE.move_to_end(key)
        return hit[1]
    pc = tables.pair_candidates
    down = pc.valid & (pc.min_cap < _DEAD_PATH_CAP)
    alive = pc.valid & ~down
    k_dump = np.where(alive.any(-1), np.argmax(alive, axis=-1), 0)

    def t(a, dtype):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    dt = _DeviceTables(
        caps=t(tables.caps, torch.float32),
        rids=t(pc.rids, torch.int64),
        mult=t(pc.mult, torch.float32),
        mask=t(pc.mask, torch.float32),
        pen=t(pc.penalty, torch.float32),
        relay=t(pc.relay, torch.bool),
        down=t(down, torch.bool),
        invalid=t(~pc.valid, torch.bool),
        k_dump=t(k_dump, torch.int64),
    )
    _DEVICE_CACHE[key] = (tables, dt)
    while len(_DEVICE_CACHE) > _DEVICE_CACHE_CAP:
        _DEVICE_CACHE.popitem(last=False)
    return dt


def plan_flows_batch(
    demand_bytes: torch.Tensor,        # [B, n, n] float32, zero diagonal
    tables: PlannerTables,
    cfg: PlannerConfig = PlannerConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plan B demand matrices at once: -> (flows [B, n, n, K], loads [B, R]).

    The reference's ``prev_loads`` (EMA hysteresis) and ``ext_loads``
    (other tenants' prices) serve its runtime and fabric arbiter, which are
    not ported yet.
    """
    dev = demand_bytes.device
    tb = device_tables(tables, dev)
    n, K, R = tables.n, tables.K, tables.n_resources
    B = demand_bytes.shape[0]
    NN = n * n

    res = demand_bytes.to(torch.float32).reshape(B, NN)
    msg = res.clone()                                  # per-pair message size
    eps = torch.tensor(cfg.chunk_bytes, dtype=torch.float32, device=dev)
    lam = torch.tensor(cfg.lam, dtype=torch.float32, device=dev)

    loads = torch.zeros((B, R), dtype=torch.float32, device=dev)

    small = tb.relay[None] & (msg[..., None] <= cfg.split_threshold)  # [B,NN,K]
    flows = torch.zeros((B, NN, K), dtype=torch.float32, device=dev)
    pair = torch.arange(NN, device=dev)
    batch_off = (torch.arange(B, device=dev) * R)[:, None, None]       # [B,1,1]
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    big_down = torch.tensor(_BIG_DOWN, dtype=torch.float32, device=dev)
    big_inv = torch.tensor(_BIG_INVALID, dtype=torch.float32, device=dev)

    for _ in range(cfg.n_iters):
        costs = loads / tb.caps                                      # [B, R]
        cand = costs[:, tb.rids] * tb.mask                            # [B,NN,K,MC]
        pcK = cand.amax(dim=-1) + tb.pen
        pcK = torch.where(small, big, pcK)
        pcK = torch.where(tb.down, big_down, pcK)
        pcK = torch.where(tb.invalid, big_inv, pcK)
        best_k = torch.argmin(pcK, dim=-1)                            # [B, NN]
        # Algorithm 1 lines 24-28: quantized λ-fraction of the residual
        f = torch.where(res < eps, res, torch.floor(res * lam / eps) * eps)
        f = torch.where((res >= eps) & (f <= 0), torch.minimum(eps, res), f)
        f = torch.clamp_min(f, 0.0)
        onehot = torch.nn.functional.one_hot(best_k, K).to(torch.float32)
        flows = flows + f[..., None] * onehot
        rids = tb.rids[pair, best_k]                                  # [B,NN,MC]
        mult = tb.mult[pair, best_k]
        seg = torch.zeros(B * R, dtype=torch.float32, device=dev)
        seg.index_put_(((rids + batch_off).reshape(-1),),
                       (f[..., None] * mult).reshape(-1), accumulate=True)
        loads = loads + seg.view(B, R)
        res = res - f
    # residual after T iterations -> least-hop *alive* path
    flows[:, pair, tb.k_dump] += res
    return flows.reshape(B, n, n, K), loads


def plan_flows(
    demand_bytes: torch.Tensor,        # [n, n] float32, zero diagonal
    tables: PlannerTables,
    cfg: PlannerConfig = PlannerConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (flows [n, n, K] bytes, resource loads [n_resources])."""
    flows, loads = plan_flows_batch(demand_bytes[None], tables, cfg)
    return flows[0], loads[0]


def quantize_chunks(
    flows: torch.Tensor,          # [..., n, n, K] bytes
    demand_chunks: torch.Tensor,  # [..., n, n] int — exact chunk counts
    slot_caps: np.ndarray,        # [n_rel, K] static slot capacities
    rel_of_pair: np.ndarray,      # [n, n] static rel id (-1 on diagonal)
    chunk_bytes: float,
) -> torch.Tensor:
    """Round flows to integer chunks: alternates floor+clamp, direct absorbs.

    Guarantees sum_k chunks[s,d,k] == demand_chunks[s,d] and
    chunks[s,d,k] <= S[rel(s,d),k], so the dataplane never overflows a slot
    segment (k=0 capacity is C >= any per-destination demand by layout).
    """
    K = flows.shape[-1]
    caps = torch.as_tensor(
        np.asarray(slot_caps)[np.maximum(rel_of_pair, 0)], dtype=torch.int32
    ).to(flows.device)                                        # [n, n, K]
    remaining = demand_chunks.to(torch.int32)
    out = []
    for k in range(K - 1, 0, -1):  # alternates, highest k first
        want = torch.floor(flows[..., k] / chunk_bytes).to(torch.int32)
        got = torch.minimum(torch.minimum(want, caps[..., k]), remaining)
        out.append(got)
        remaining = remaining - got
    return torch.stack([remaining] + out[::-1], dim=-1)  # k=0 absorbs rest


def plan_chunks(
    demand_chunks: torch.Tensor,   # [n, n] or [B, n, n] int
    tables: PlannerTables,
    cfg: PlannerConfig,
    slot_caps: np.ndarray,
    rel_of_pair: np.ndarray,
) -> torch.Tensor:
    """Chunk demand -> per-path chunk assignment ([B,] n, n, K) int32."""
    single = demand_chunks.dim() == 2
    dc = demand_chunks[None] if single else demand_chunks
    D = dc.to(torch.float32) * cfg.chunk_bytes
    flows, _ = plan_flows_batch(D, tables, cfg)
    chunks = quantize_chunks(flows, dc, slot_caps, rel_of_pair, cfg.chunk_bytes)
    return chunks[0] if single else chunks
