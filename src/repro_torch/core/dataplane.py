"""NIMBLE dataplane — scheduled multi-path All-to-Allv over the EP ranks.

PyTorch counterpart of ``repro/core/dataplane.py``.  The reference runs one
SPMD program a device under ``shard_map``, one rank a device.  Here a
process hosts a contiguous block of ``L = n / P`` ranks on a leading rank
axis, where ``P`` is the size of the model group it is given (``group``);
``P = 1`` (no group) stacks every rank in one process, on one card or on
the CPU, and ``P = n`` is the reference's SPMD form:

  * the *structure* (slots, rounds, permutations) is static — built once
    from the topology by ``schedule.build_schedule``;
  * the *flow amounts* are dynamic — the ``[L, n]`` send counts of every
    process are all-gathered into the ``[n, n]`` matrix the reference's
    ``all_gather`` gives every device, so every process runs the MWU
    planner on the same counts and holds the same plan;
  * each round applies, for every hop of the round, the reference's
    ``ppermute(sub, perm_pairs(hop))``: ``new[dst] = old[src]``.  Slots whose
    source rank is in this process's block move by a row gather; the rest
    travel as one contiguous buffer for each peer process, in (destination
    rank, slot) order, one ``batch_isend_irecv`` a hop (none at ``P = 1``).
    That exchange is an ``autograd.Function`` whose backward sends the
    cotangents back along the inverse permutation, as ``ppermute``'s
    transpose gives the reference;
  * slot fill, rounds and reassembly are row gathers through the
    ``token_gather`` kernel: each destination slot receives at most one
    source row, so the reference's scatters equal gathers bit for bit.

Modes: ``nimble`` (planned), ``direct`` (static least-hop, NCCL/PXN-like)
and ``stripe`` (even multirail striping, UCX-like), over the same slots.
:func:`baseline_all_to_all` is the stock collective over the same layout.

The port's endpoint names no mesh axis: it takes the model axis's process
group (``group``), and :meth:`NimbleAllToAll.from_session` too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
    """All-to-allv over the ranks of one EP group.

    ``y, recv = comm(x, send_chunks)`` where ``x: [L, n, C, E]`` holds the
    padded per-destination send buffers of this process's ``L`` ranks and
    ``send_chunks: [L, n]`` their live chunk counts (row = sending rank).
    ``y[d, s]`` is what this process's ``d``-th rank received from rank
    ``s``.  Without a ``group`` (or with one of size 1), ``L = n``.
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
        group=None,
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
        self.n = n_devices
        # this process's block of ranks: [r0, r0 + L) of the P processes' n
        self.group = group
        self.P = 1 if group is None else dist.get_world_size(group)
        if n_devices % self.P:
            raise ValueError(f"{self.P} processes do not split {n_devices} ranks")
        self.L = n_devices // self.P
        self.proc = 0 if group is None else dist.get_rank(group)
        self.r0 = self.proc * self.L
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
        group=None,
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
            group=group,
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
        # first slot of each (rel, k) segment (unused where S[rel, k] == 0)
        seg_start = np.zeros((len(rels), self.K), dtype=np.int64)
        seg_start.reshape(-1)[1:] = np.cumsum(sched.S.reshape(-1))[:-1]
        self._seg_start = seg_start
        self._build_rounds()

    def _build_rounds(self) -> None:
        """Each round: per hop, the local rows sent to each peer process and
        the rows received from it, in (destination rank, slot) order; and
        the round's gather ``new[d, slot] = old[src(d, slot), slot]`` over
        [local state; received rows].  At P = 1 every source is local: no
        message, one gather a round."""
        sched, n_slots = self.sched, self.sched.n_slots
        L, r0, me = self.L, self.r0, self.proc
        peers = ([None] if self.group is None else
                 [dist.get_global_rank(self.group, q) for q in range(self.P)])
        block = range(r0, r0 + L)
        self._rounds = []
        self.messages_per_hop = []
        for rnd in sched.rounds:
            index = np.arange(L)[:, None] * n_slots + np.arange(n_slots)  # unmoved
            base = L * n_slots
            hops = []
            for hop, slot_ids in rnd:
                fwd = np.empty(self.n, dtype=np.int64)
                inv = np.empty(self.n, dtype=np.int64)
                for s, d in sched.perm_pairs(hop):
                    fwd[s], inv[d] = d, s
                send_rows, send_counts, recv_counts = [], [], []
                for q in range(self.P):
                    if q == me:
                        send_counts.append(0)
                        recv_counts.append(0)
                        continue
                    srcs = sorted((int(fwd[s]), s) for s in block if fwd[s] // L == q)
                    for _, s in srcs:
                        send_rows.extend((s - r0) * n_slots + slot_ids)
                    send_counts.append(len(srcs) * len(slot_ids))
                    dsts = [d for d in block if inv[d] // L == q]
                    for d in dsts:
                        index[d - r0, slot_ids] = base + np.arange(len(slot_ids))
                        base += len(slot_ids)
                    recv_counts.append(len(dsts) * len(slot_ids))
                for d in block:                   # sources in this block
                    if inv[d] // L == me:
                        index[d - r0, slot_ids] = (inv[d] - r0) * n_slots + slot_ids
                hops.append((_Transfer(self.group, peers, send_counts, recv_counts),
                             np.asarray(send_rows, dtype=np.int64)))
            self._rounds.append((hops, index.reshape(-1)))
            self.messages_per_hop.append([sum(c > 0 for c in x.send_counts)
                                          for x, _ in hops])

    def _static(self, device) -> dict:
        """Static maps as tensors on ``device`` (built once per device)."""
        key = str(device)
        if key not in self._maps:
            t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
            blk = slice(self.r0, self.r0 + self.L)
            rounds = [([(x, t(rows)) for x, rows in hops if not x.idle], t(index))
                      for hops, index in self._rounds]
            self._maps[key] = dict(
                dest=t(self._dest[blk]),
                slot_rel=t(self.sched.slot_rel),
                slot_k=t(self.sched.slot_k),
                slot_pos=t(self.sched.slot_pos),
                rounds=rounds,
                seg_start=t(self._seg_start),
                rel_of_pair=t(np.maximum(self.rel_of_pair, 0)),
                caps=torch.as_tensor(self.sched.S[np.maximum(self.rel_of_pair, 0)],
                                     dtype=torch.int32, device=device),
                ranks=t(np.arange(self.r0, self.r0 + self.L)),
                local=t(np.arange(self.L)),
            )
        return self._maps[key]

    # -- plan -----------------------------------------------------------------------
    def gather_counts(self, send_chunks: torch.Tensor) -> torch.Tensor:
        """This process's live counts [L, n] -> every rank's [n, n]: the
        reference's ``all_gather`` over the model group (itself at P = 1)."""
        if self.P == 1:
            return send_chunks
        out = send_chunks.new_empty((self.n, self.n))
        dist.all_gather_into_tensor(out, send_chunks.contiguous(), group=self.group)
        return out

    def plan_from_counts(self, demand_chunks: torch.Tensor) -> torch.Tensor:
        """Every rank's live counts [n, n] -> replicated plan [n, n, K] (int32).

        Every process holds the same counts (:meth:`gather_counts`), as the
        reference's all-gather gives them to every device, so every process
        computes the same plan.
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
        """x: [L, n, C, E] per-destination buffers; send_chunks: [L, n]."""
        chunks = self.plan_from_counts(self.gather_counts(send_chunks))
        y = self.execute(x, chunks)
        recv = chunks.sum(-1).T[self.r0:self.r0 + self.L].to(send_chunks.dtype)
        st = self._static(recv.device)
        recv[st["local"], st["ranks"]] = send_chunks[st["local"], st["ranks"]]
        return y, recv                                           # recv[d, s]

    def execute(self, x: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
        """Move x [L, n, C, E] according to a (replicated) plan [n, n, K]."""
        n, L = self.n, self.L
        C, K = self.C, self.K
        E = x.shape[-1]
        if tuple(x.shape) != (L, n, C, E):
            raise ValueError(f"execute: x {tuple(x.shape)} != {(L, n, C, E)}")
        st = self._static(x.device)
        n_slots = self.sched.n_slots
        ranks, local = st["ranks"], st["local"]
        chunks = chunks.to(torch.int64)

        # slot fill: rank r's slot (rel, k, pos) takes chunk start + pos of
        # its buffer for dest(r, rel), when the plan puts that many there
        my = chunks[ranks[:, None], st["dest"]]                  # [L, n_rel, K]
        start = torch.cumsum(my, -1) - my
        cnt = my[:, st["slot_rel"], st["slot_k"]]                # [L, n_slots]
        chunk_idx = start[:, st["slot_rel"], st["slot_k"]] + st["slot_pos"]
        src_row = (local[:, None] * n + st["dest"][:, st["slot_rel"]]) * C + chunk_idx
        src_row = torch.where(st["slot_pos"] < cnt, src_row, -1)
        state = token_gather(x.reshape(L * n * C, E), src_row.reshape(-1))

        # three normalized rounds of hop permutations along the rank axis
        for hops, index in st["rounds"]:
            parts = [state]
            for xfer, rows in hops:                    # hops with a message only
                send = token_gather(state, rows) if rows.numel() else state[:0]
                parts.append(_HopExchange.apply(send, xfer))
            state = token_gather(torch.cat(parts) if hops else state, index)

        # reassembly: y[d, s, c] comes from the slot of (rel(s->d), k, pos)
        # that carried chunk c of s's plan for d
        cnt_sd = chunks.transpose(0, 1)[self.r0:self.r0 + L]     # [d, s, K]
        rend = torch.cumsum(cnt_sd, -1)
        c = torch.arange(C, device=x.device)
        k_of = (rend[:, :, None, :] <= c[:, None]).sum(-1)       # [d, s, C]
        ok = k_of < K
        kc = k_of.clamp_max(K - 1)
        rstart = torch.gather(rend - cnt_sd, 2, kc)
        rel = st["rel_of_pair"].T[self.r0:self.r0 + L, :, None].expand(L, n, C)
        slot = st["seg_start"][rel, kc] + c - rstart
        row = local[:, None, None] * n_slots + slot
        ok = ok & (ranks[:, None] != torch.arange(n, device=x.device)[None, :])[..., None]
        y = token_gather(state, torch.where(ok, row, -1).reshape(-1))
        y = y.view(L, n, C, E)
        # local traffic, written in place: safe under autograd because
        # token_gather's backward saves its index only, not its output
        y[local, ranks] = x[local, ranks]
        return y


class _Transfer:
    """One hop's messages between this process and each peer of its group:
    rows sent to and received from peer ``q`` (global rank ``peers[q]``)."""

    def __init__(self, group, peers, send_counts, recv_counts):
        self.group, self.peers = group, peers
        self.send_counts, self.recv_counts = send_counts, recv_counts
        self.idle = not (any(send_counts) or any(recv_counts))

    def run(self, buf: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """Send ``buf``'s blocks, receive the peers' into a new buffer (the
        opposite way round when ``reverse``); one ``batch_isend_irecv``."""
        sc, rc = ((self.recv_counts, self.send_counts) if reverse
                  else (self.send_counts, self.recv_counts))
        out = buf.new_empty((sum(rc),) + tuple(buf.shape[1:]))
        ops, so, ro = [], 0, 0
        for peer, s, r in zip(self.peers, sc, rc):
            if s:
                ops.append(dist.P2POp(dist.isend, buf[so:so + s], peer, self.group))
                so += s
            if r:
                ops.append(dist.P2POp(dist.irecv, out[ro:ro + r], peer, self.group))
                ro += r
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out


class _HopExchange(torch.autograd.Function):
    """A hop's cross-process rows; its backward sends the cotangents back
    along the inverse permutation (``ppermute``'s transpose)."""

    @staticmethod
    def forward(ctx, send: torch.Tensor, xfer: _Transfer) -> torch.Tensor:
        ctx.xfer = xfer
        return xfer.run(send.contiguous())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.xfer.run(grad.contiguous(), reverse=True), None


def baseline_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The stock collective over the same layout: ``y[d, s] = x[s, d]`` for
    every rank, padding included.  ``x: [L, n, C, E]``; over the model
    group ``dist.all_to_all_single``, without one a transpose of the rank
    axes (``L = n``)."""
    P = 1 if group is None else dist.get_world_size(group)
    L, n = x.shape[:2]
    if L * P != n:
        raise ValueError(f"baseline_all_to_all: {L} ranks x {P} processes != {n}")
    if P == 1:
        return x.transpose(0, 1).contiguous()
    # [L(src), P(dest proc), L(dest), ...] -> dest process major
    send = x.reshape(L, P, L, *x.shape[2:]).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)                 # [P(src proc), L(src), L(dest), ...]
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(2, 0, 1, *range(3, recv.dim())).reshape(L, n, *x.shape[2:])


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
