"""NIMBLE dataplane — scheduled multi-path All-to-Allv over stacked ranks.

PyTorch counterpart of ``repro/core/dataplane.py``.  The reference runs one
SPMD program per device under ``shard_map``; here every rank of the EP
group lives in one process, as a leading rank axis, so the whole exchange
runs on one card (or on the CPU):

  * the *structure* (slots, rounds, permutations) is static — built once
    from the topology by ``schedule.build_schedule``;
  * the *flow amounts* are dynamic — the stacked ``[n, n]`` send counts
    are what the reference's ``all_gather`` gives every device, so the MWU
    planner runs once and its plan holds for every rank;
  * each round applies, for every hop of the round, the reference's
    ``ppermute(sub, perm_pairs(hop))`` as ``new[dst] = old[src]`` along the
    rank axis.  The hops of one round touch disjoint slots, so a round is
    one gather over the ``[rank, slot]`` state;
  * slot fill, rounds and reassembly are all row gathers through the
    ``token_gather`` kernel: each destination slot receives at most one
    source row, so the reference's scatters equal gathers bit for bit.

Modes: ``nimble`` (planned), ``direct`` (static least-hop, NCCL/PXN-like)
and ``stripe`` (even multirail striping, UCX-like), over the same slots.

The stacked ranks need no mesh axis, so the port's endpoint takes no
``axis_name``, and :meth:`NimbleAllToAll.from_session` none either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.token_scatter.ops import token_gather
from .cost import CostModel
from .planner import PlannerConfig, plan_chunks, plan_flows_batch, quantize_chunks
from .schedule import (
    CommSchedule,
    PlannerTables,
    build_planner_tables,
    build_schedule,
)
from .topology import Topology


def rel_id_of(m: int, dq: int, G: int) -> int:
    """rel enumeration order: m-major, (0,0) skipped."""
    return m * G + dq - 1


def build_rel_of_pair(n: int, G: int) -> np.ndarray:
    """[n, n] rel id for every ordered pair (-1 on the diagonal)."""
    NG = n // G
    out = np.full((n, n), -1, dtype=np.int32)
    for s in range(n):
        g, p = divmod(s, G)
        for d in range(n):
            if s == d:
                continue
            gd, q = divmod(d, G)
            out[s, d] = rel_id_of((gd - g) % NG, (q - p) % G, G)
    return out


class NimbleAllToAll:
    """All-to-allv over the stacked ranks of one EP group.

    ``y, recv = comm(x, send_chunks)`` where ``x: [n, n, C, E]`` holds each
    rank's padded per-destination send buffers and ``send_chunks: [n, n]``
    the live chunk counts (row = sending rank).  ``y[d, s]`` is what rank
    ``d`` received from rank ``s``.
    """

    def __init__(
        self,
        n_devices: int,
        group_size: int = 4,
        *,
        max_chunks: int,
        chunk_bytes: float,
        alt_frac: float = 0.5,
        planner_cfg: Optional[PlannerConfig] = None,
        cost_model: Optional[CostModel] = None,
        mode: str = "nimble",  # nimble | direct | stripe
        topo: Optional[Topology] = None,
    ):
        if mode not in ("nimble", "direct", "stripe"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        # ``topo`` lets a Session (or any caller with a non-default fabric:
        # custom caps, pods, degraded links) supply the exact Topology the
        # planner should price; geometry must match the dataplane's ranks
        if topo is not None:
            if (topo.n_devices, topo.group_size) != (n_devices, group_size):
                raise ValueError(
                    f"topology geometry ({topo.n_devices}, "
                    f"{topo.group_size}) != dataplane geometry "
                    f"({n_devices}, {group_size})"
                )
            self.topo = topo
        else:
            self.topo = Topology(n_devices, group_size)
        # direct routes everything on k=0, so it provisions no alternate slots
        if mode == "direct":
            alt_frac = 0.0
        self.sched: CommSchedule = build_schedule(self.topo, max_chunks, alt_frac)
        self.tables: PlannerTables = build_planner_tables(self.topo, cost_model)
        self.cfg = planner_cfg or PlannerConfig(chunk_bytes=chunk_bytes)
        if self.cfg.chunk_bytes != chunk_bytes:
            self.cfg = dataclasses.replace(self.cfg, chunk_bytes=chunk_bytes)
        self.rel_of_pair = build_rel_of_pair(n_devices, group_size)
        # optional execution-time telemetry sink (runtime.LinkTelemetry):
        # host-driven plan_batch calls harvest planned resource loads into it
        self.telemetry = None
        self.K = self.sched.K
        self.C = max_chunks
        self._maps = {}
        self._build_static_maps()

    @classmethod
    def from_session(
        cls,
        session,
        *,
        max_chunks: int,
        chunk_bytes: float,
        alt_frac: float = 0.5,
        mode: str = "nimble",
        planner_cfg: Optional[PlannerConfig] = None,
    ) -> "NimbleAllToAll":
        """Session-wired endpoint.

        Topology, cost model, and planner defaults come from the session
        (duck-typed: ``.topo``, ``.cost_model``, ``.spec.planner``,
        ``.runtime`` — this module never imports ``repro_torch.api``); when
        the session runs an orchestration runtime, the endpoint's telemetry
        is attached so host-driven ``plan_batch`` calls feed its monitor
        stage.  With an all-default session this is constructor-equivalent
        to hand-wiring ``NimbleAllToAll(...)`` — bit-identical plans.
        """
        topo = session.topo
        comm = cls(
            topo.n_devices,
            topo.group_size,
            max_chunks=max_chunks,
            chunk_bytes=chunk_bytes,
            alt_frac=alt_frac,
            planner_cfg=(
                planner_cfg if planner_cfg is not None else session.spec.planner
            ),
            cost_model=session.cost_model,
            mode=mode,
            topo=topo,
        )
        runtime = getattr(session, "runtime", None)
        if runtime is not None:
            comm.attach_telemetry(runtime.telemetry)
        return comm

    # -- static index maps --------------------------------------------------------
    def _build_static_maps(self) -> None:
        n, G, NG = self.topo.n_devices, self.topo.group_size, self.topo.n_groups
        sched = self.sched
        rels = sched.rels
        n_slots = sched.n_slots
        rel_m = np.array([r.m for r in rels])
        rel_dq = np.array([r.dq for r in rels])
        ranks = np.arange(n)
        g, p = ranks // G, ranks % G
        # dest[r, rel]: where rank r's relation rel points
        self._dest = ((g[:, None] + rel_m) % NG) * G + (p[:, None] + rel_dq) % G
        # per round: new[d, slot] = old[src_rank[d, slot], slot]
        self._round_src = []
        for rnd in sched.rounds:
            src_rank = np.repeat(ranks[:, None], n_slots, axis=1)
            for hop, slot_ids in rnd:
                inv = np.empty(n, dtype=np.int64)
                for s, d in sched.perm_pairs(hop):
                    inv[d] = s
                src_rank[:, slot_ids] = inv[:, None]
            self._round_src.append(src_rank * n_slots + np.arange(n_slots))
        # first slot of each (rel, k) segment (unused where S[rel, k] == 0)
        seg_start = np.zeros((len(rels), self.K), dtype=np.int64)
        seg_start.reshape(-1)[1:] = np.cumsum(sched.S.reshape(-1))[:-1]
        self._seg_start = seg_start

    def _static(self, device) -> dict:
        """Static maps as tensors on ``device`` (built once per device)."""
        key = str(device)
        if key not in self._maps:
            t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
            self._maps[key] = dict(
                dest=t(self._dest),
                slot_rel=t(self.sched.slot_rel),
                slot_k=t(self.sched.slot_k),
                slot_pos=t(self.sched.slot_pos),
                rounds=[t(r).reshape(-1) for r in self._round_src],
                seg_start=t(self._seg_start),
                rel_of_pair=t(np.maximum(self.rel_of_pair, 0)),
                caps=torch.as_tensor(self.sched.S[np.maximum(self.rel_of_pair, 0)],
                                     dtype=torch.int32, device=device),
            )
        return self._maps[key]

    # -- plan -----------------------------------------------------------------------
    def plan_from_counts(self, demand_chunks: torch.Tensor) -> torch.Tensor:
        """Stacked live counts [n, n] -> replicated plan [n, n, K] (int32).

        Every rank's counts are already here, as the reference's all-gather
        gives them to every device, so the plan is computed once.
        """
        n, K = self.topo.n_devices, self.K
        dc = demand_chunks.to(torch.int32)
        if self.mode == "direct":
            # static least-hop: everything on k=0 (PXN destination-rail path)
            z = torch.zeros((n, n, K), dtype=torch.int32, device=dc.device)
            z[..., 0] = dc
            return z
        if self.mode == "stripe":
            # UCX-style: even split across candidates, remainder on k=0
            caps = self._static(dc.device)["caps"]                  # [n,n,K]
            kvalid = (caps > 0).to(torch.int32)
            nk = kvalid.sum(-1, dtype=torch.int32).clamp_min(1)
            share = dc[..., None] // nk[..., None]
            share = torch.minimum(share * kvalid, caps)
            rem = dc - share.sum(-1, dtype=torch.int32)
            share[..., 0] += rem
            return share
        return plan_chunks(dc, self.tables, self.cfg, self.sched.S,
                           self.rel_of_pair)

    def attach_telemetry(self, sink) -> None:
        """Attach a ``runtime.LinkTelemetry`` (or duck-typed) sink.

        Subsequent host-driven :meth:`plan_batch` calls record each planned
        demand matrix and its per-resource loads via ``sink.record_loads``
        (self-numbered windows), feeding the orchestration runtime's
        monitor stage from real plan executions without touching the
        per-call dataplane path.  Only ``mode="nimble"`` produces a load
        vector — the static baselines plan elementwise and record nothing.
        """
        self.telemetry = sink

    def plan_batch(self, demand_chunks: torch.Tensor) -> torch.Tensor:
        """Plan a batch of demand matrices in one call: [B, n, n] -> [B, n, n, K].

        Multi-tenant / per-layer entry point: every batch entry is planned
        by the batched MWU against the same cached incidence tables and
        quantized to slot capacities, on the demand's device.  Static modes
        apply their elementwise rules to each entry.
        """
        dc = torch.as_tensor(demand_chunks).to(torch.int32)
        if self.mode != "nimble":
            return torch.stack([self.plan_from_counts(d) for d in dc])
        D = dc.to(torch.float32) * self.cfg.chunk_bytes
        flows, loads = plan_flows_batch(D, self.tables, self.cfg)
        if self.telemetry is not None:
            # strip the trailing dummy resource the planner pads with
            loads_np = loads.cpu().numpy()[:, :-1]
            D_np = D.cpu().numpy()
            for b in range(loads_np.shape[0]):
                self.telemetry.record_loads(None, loads_np[b],
                                            pair_bytes=D_np[b])
        return quantize_chunks(flows, dc, self.sched.S, self.rel_of_pair,
                               self.cfg.chunk_bytes)

    # -- execution ------------------------------------------------------------------
    def __call__(
        self, x: torch.Tensor, send_chunks: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [n, n, C, E] per-destination buffers; send_chunks: [n, n]."""
        chunks = self.plan_from_counts(send_chunks)
        y = self.execute(x, chunks)
        recv = chunks.sum(-1).T.to(send_chunks.dtype)            # recv[d, s]
        diag = torch.arange(recv.shape[0], device=recv.device)
        recv[diag, diag] = send_chunks[diag, diag]
        return y, recv

    def execute(self, x: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
        """Move x [n, n, C, E] according to a (replicated) plan [n, n, K]."""
        n = self.topo.n_devices
        C, K = self.C, self.K
        E = x.shape[-1]
        if tuple(x.shape) != (n, n, C, E):
            raise ValueError(f"execute: x {tuple(x.shape)} != {(n, n, C, E)}")
        st = self._static(x.device)
        n_slots = self.sched.n_slots
        ranks = torch.arange(n, device=x.device)
        chunks = chunks.to(torch.int64)

        # slot fill: rank r's slot (rel, k, pos) takes chunk start + pos of
        # its buffer for dest(r, rel), when the plan puts that many there
        my = chunks[ranks[:, None], st["dest"]]                  # [n, n_rel, K]
        start = torch.cumsum(my, -1) - my
        cnt = my[:, st["slot_rel"], st["slot_k"]]                # [n, n_slots]
        chunk_idx = start[:, st["slot_rel"], st["slot_k"]] + st["slot_pos"]
        src_row = (ranks[:, None] * n + st["dest"][:, st["slot_rel"]]) * C + chunk_idx
        src_row = torch.where(st["slot_pos"] < cnt, src_row, -1)
        state = token_gather(x.reshape(n * n * C, E), src_row.reshape(-1))

        # three normalized rounds of hop permutations along the rank axis
        for rnd in st["rounds"]:
            state = token_gather(state, rnd)

        # reassembly: y[d, s, c] comes from the slot of (rel(s->d), k, pos)
        # that carried chunk c of s's plan for d
        cnt_sd = chunks.transpose(0, 1)                          # [d, s, K]
        rend = torch.cumsum(cnt_sd, -1)
        c = torch.arange(C, device=x.device)
        k_of = (rend[:, :, None, :] <= c[:, None]).sum(-1)       # [d, s, C]
        ok = k_of < K
        kc = k_of.clamp_max(K - 1)
        rstart = torch.gather(rend - cnt_sd, 2, kc)
        rel = st["rel_of_pair"].T[:, :, None].expand(n, n, C)    # rel(s -> d)
        slot = st["seg_start"][rel, kc] + c - rstart
        row = ranks[:, None, None] * n_slots + slot
        ok = ok & (ranks[:, None] != ranks[None, :])[..., None]
        y = token_gather(state, torch.where(ok, row, -1).reshape(-1))
        y = y.view(n, n, C, E)
        # local traffic, written in place: safe under autograd because
        # token_gather's backward saves its index only, not its output
        y[ranks, ranks] = x[ranks, ranks]
        return y


# -- host-side oracle -----------------------------------------------------------


def ref_all_to_allv(
    x_all: np.ndarray, counts_all: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy oracle: x_all [n, n, C, E], counts_all [n, n] -> (y, recv).

    y[d, s, c] = x_all[s, d, c] for c < counts_all[s, d], else 0.
    """
    n, _, C, E = x_all.shape
    y = np.zeros_like(x_all)
    recv = np.zeros((n, n), dtype=counts_all.dtype)
    for s in range(n):
        for d in range(n):
            c = int(counts_all[s, d])
            y[d, s, :c] = x_all[s, d, :c]
            recv[d, s] = c
    return y, recv
