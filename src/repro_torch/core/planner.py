"""Execution-time planner — the fixed-iteration multiplicative-weights MCF.

PyTorch counterpart of ``repro/core/planner.py``: Algorithm 1 as a
**fixed-T, vectorized** MWU loop over plain tensor ops, so it re-plans from
the live demand matrix on whatever device the demand lives on, with no host
round trip.

All pairs route a λ-fraction of their residual simultaneously each
iteration; after T iterations the residual is dumped on the least-hop alive
path.  Pricing and charging run against the per-pair candidate rows of the
shared :class:`~repro_torch.core.incidence.PathIncidence`.

Determinism: each iteration adds its charges to every resource's load in
one fixed order, the reference's: the load first, then the charging pairs
in pair order (XLA folds ``loads + segment_sum(...)`` into one scatter-add
that runs in that order).  The order is static: every candidate row entry
of every pair, grouped by resource (``_DeviceTables.seg_order``), where the
candidates not chosen this iteration charge an exact zero.  A
``torch.segment_reduce`` over a 2-D input adds each segment's values one
after another, on the CPU and on the card alike, so the loads do not depend
on how many pairs share a resource or on the device.  ``torch.argmin``
keeps the first minimal index, as ``jnp.argmin`` does.  On the CPU the
plans and loads equal JAX's bit for bit, and on the card they equal the
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
    hysteresis: float = 0.5


def planner_provenance(cfg: PlannerConfig) -> dict:
    """Solver-parameter fingerprint of a plan, as the reference records it."""
    return {
        "engine": "mwu",
        "lam": float(cfg.lam),
        "n_iters": int(cfg.n_iters),
        "chunk_bytes": float(cfg.chunk_bytes),
        "hysteresis": float(cfg.hysteresis),
    }


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
    # the load sum's fixed order: per resource r, position r (its load) and
    # then every candidate row entry charging r, in (pair, k, slot) order,
    # as positions into [loads (R), charges (n*n*K*MC)]
    seg_order: torch.Tensor  # [R + entries with mult > 0] int64
    seg_lengths: torch.Tensor  # [R] int64


_DEVICE_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_DEVICE_CACHE_CAP = 64


def device_tables(tables: PlannerTables, device) -> _DeviceTables:
    """Cached tensor copy of ``tables``' candidate rows on ``device``.

    Keyed by the tables object's identity; the cache entry holds a
    reference to the tables so the identity cannot be reused while cached.
    Under a ``FakeTensorMode`` (the dry run) the tensors are fake and live
    only as long as that mode: they are built afresh and not cached.
    """
    device = torch.device(device)
    key = (id(tables), str(device))
    fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
    hit = None if fake else _DEVICE_CACHE.get(key)
    if hit is not None:
        _DEVICE_CACHE.move_to_end(key)
        return hit[1]
    pc = tables.pair_candidates
    down = pc.valid & (pc.min_cap < _DEAD_PATH_CAP)
    alive = pc.valid & ~down
    k_dump = np.where(alive.any(-1), np.argmax(alive, axis=-1), 0)

    def t(a, dtype):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    # the load sum's order; a 0-padded slot (mult 0) always charges an exact
    # zero, so it is left out: the dummy resource's segment is its load alone
    R = tables.n_resources
    pos = np.flatnonzero(pc.mask.reshape(-1))
    rid = pc.rids.reshape(-1)[pos].astype(np.int64)
    entries = np.argsort(rid, kind="stable")           # by resource, then position
    counts = np.bincount(rid, minlength=R)
    lengths = counts + 1
    start = np.cumsum(lengths) - lengths               # where each segment begins
    order = np.empty(R + rid.size, dtype=np.int64)
    order[start] = np.arange(R)
    rank = np.arange(rid.size) - np.repeat(np.cumsum(counts) - counts, counts)
    order[start[rid[entries]] + 1 + rank] = R + pos[entries]

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
        seg_order=t(order, torch.int64),
        seg_lengths=t(lengths, torch.int64),
    )
    if fake:
        return dt
    _DEVICE_CACHE[key] = (tables, dt)
    while len(_DEVICE_CACHE) > _DEVICE_CACHE_CAP:
        _DEVICE_CACHE.popitem(last=False)
    return dt


def plan_flows_batch(
    demand_bytes: torch.Tensor,        # [B, n, n] float32, zero diagonal
    tables: PlannerTables,
    cfg: PlannerConfig = PlannerConfig(),
    prev_loads: torch.Tensor | None = None,  # [B, n_resources] or None
    ext_loads: torch.Tensor | None = None,   # [B, n_resources] or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plan B demand matrices at once: -> (flows [B, n, n, K], loads [B, R]).

    ``prev_loads`` is each entry's previous load vector, folded through the
    EMA (``cfg.hysteresis``) into the returned loads.  ``ext_loads`` is
    other tenants' committed load (a fabric arbiter's exported prices): it
    raises resource costs during the solve but is **not** carried into the
    returned loads, and is never EMA-smoothed; ``None`` keeps the cost
    expression the unpriced one.
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

    if prev_loads is None:
        loads = torch.zeros((B, R), dtype=torch.float32, device=dev)
    else:
        loads = torch.tensor(cfg.hysteresis, dtype=torch.float32, device=dev) * prev_loads
    ext = None if ext_loads is None else ext_loads.to(torch.float32)

    small = tb.relay[None] & (msg[..., None] <= cfg.split_threshold)  # [B,NN,K]
    flows = torch.zeros((B, NN, K), dtype=torch.float32, device=dev)
    pair = torch.arange(NN, device=dev)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    big_down = torch.tensor(_BIG_DOWN, dtype=torch.float32, device=dev)
    big_inv = torch.tensor(_BIG_INVALID, dtype=torch.float32, device=dev)

    for _ in range(cfg.n_iters):
        priced = loads if ext is None else loads + ext
        costs = priced / tb.caps                                     # [B, R]
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
        # every candidate row's charge, zero where the candidate is not chosen
        charge = (f[..., None, None] * tb.mult) * onehot[..., None]  # [B,NN,K,MC]
        vals = torch.cat([loads, charge.reshape(B, -1)], dim=1)       # [B, R + L]
        loads = torch.segment_reduce(
            vals.t().index_select(0, tb.seg_order), "sum",
            lengths=tb.seg_lengths, axis=0, unsafe=True,
        ).t()
        res = res - f
    # residual after T iterations -> least-hop *alive* path
    flows[:, pair, tb.k_dump] += res
    return flows.reshape(B, n, n, K), loads


def plan_flows(
    demand_bytes: torch.Tensor,        # [n, n] float32, zero diagonal
    tables: PlannerTables,
    cfg: PlannerConfig = PlannerConfig(),
    prev_loads: torch.Tensor | None = None,  # [n_resources] or None
    ext_loads: torch.Tensor | None = None,   # [n_resources] or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (flows [n, n, K] bytes, resource loads [n_resources])."""
    flows, loads = plan_flows_batch(
        demand_bytes[None], tables, cfg,
        None if prev_loads is None else prev_loads[None],
        None if ext_loads is None else ext_loads[None],
    )
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
