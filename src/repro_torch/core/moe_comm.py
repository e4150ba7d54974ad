"""Expert-parallel dispatch / combine over the NIMBLE dataplane (paper §V-D).

PyTorch counterpart of ``repro/core/moe_comm.py``, over stacked ranks: every
tensor carries a leading rank axis of size ``n_devices``, and rank ``r``
owns experts ``[r * epd, (r + 1) * epd)``.

  1. each rank's token-to-expert assignments are packed into per-destination
     chunk buffers — the "Kernel Scatter" stage, here a gather through the
     ``token_gather`` kernel: each buffer slot takes at most one kept
     assignment, so the reference's scatter equals a gather bit for bit;
  2. the live demand matrix is planned and executed by
     :class:`~repro_torch.core.dataplane.NimbleAllToAll`; the tokens ride
     the payload, the expert ids a float32 sideband on the SAME plan;
  3. the caller runs the expert FFN on the received tokens;
  4. outputs return through the transposed plan and are gathered back into
     token order and combined with the gate weights.

Capacity: the static per-destination buffer holds ``capacity_tokens``
assignments; overflow assignments are dropped and counted.  The sideband
is written for kept assignments only.  (The reference writes it at
``min(slot, cap - 1)`` for every assignment, so an overflowing one can
overwrite a kept token's id with -1; the port does not copy that.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.token_scatter.ops import token_gather
from .dataplane import NimbleAllToAll
from .planner import PlannerConfig


@dataclasses.dataclass
class MoECommConfig:
    n_devices: int                 # EP group size
    n_experts: int
    d_model: int
    chunk_tokens: int = 16         # ε in tokens — planner chunk granularity
    capacity_factor: float = 2.0   # per-destination buffer vs uniform share
    group_size: int = 4            # ranks per "node" on the NIMBLE axis
    alt_frac: float = 0.5
    mode: str = "nimble"           # nimble | direct | stripe
    payload_dtype: torch.dtype = torch.float32

    @property
    def experts_per_device(self) -> int:
        if self.n_experts % self.n_devices:
            raise ValueError(f"{self.n_experts} experts do not split over "
                             f"{self.n_devices} ranks")
        return self.n_experts // self.n_devices


class MoEDispatcher:
    """Dispatch/combine helper for one EP group of stacked ranks."""

    def __init__(self, cfg: MoECommConfig,
                 planner_cfg: Optional[PlannerConfig] = None):
        self.cfg = cfg
        self._comms: Dict[int, NimbleAllToAll] = {}
        self._planner_cfg = planner_cfg

    def capacity_tokens(self, n_assign: int) -> int:
        cfg = self.cfg
        per_dest = int(np.ceil(n_assign / cfg.n_devices * cfg.capacity_factor))
        ct = cfg.chunk_tokens
        return int(np.ceil(per_dest / ct)) * ct

    def _comm(self, n_chunks: int) -> NimbleAllToAll:
        if n_chunks not in self._comms:
            itemsize = torch.empty((), dtype=self.cfg.payload_dtype).element_size()
            self._comms[n_chunks] = NimbleAllToAll(
                self.cfg.n_devices,
                self.cfg.group_size,
                max_chunks=n_chunks,
                chunk_bytes=float(self.cfg.chunk_tokens * self.cfg.d_model * itemsize),
                alt_frac=self.cfg.alt_frac,
                planner_cfg=self._planner_cfg,
                mode=self.cfg.mode,
            )
        return self._comms[n_chunks]

    # -- dispatch ----------------------------------------------------------------
    def dispatch(
        self,
        tokens: torch.Tensor,       # [n, T, d] each rank's local tokens
        expert_idx: torch.Tensor,   # [n, T, k] global expert ids
        token_valid: Optional[torch.Tensor] = None,  # [n, T] bool ownership
    ):
        """Route token copies to expert-owning ranks.

        Returns (recv_tokens [n, n, C, ct, d], expert_local [n, n, C, ct]
        with -1 padding, state) where ``recv_tokens[r, s]`` is what rank r
        received from rank s and ``state`` carries what combine needs.
        """
        cfg = self.cfg
        n, ct, d = cfg.n_devices, cfg.chunk_tokens, cfg.d_model
        R, T, k = expert_idx.shape
        if R != n or tuple(tokens.shape) != (n, T, d):
            raise ValueError(f"dispatch: tokens {tuple(tokens.shape)}, "
                             f"expert_idx {tuple(expert_idx.shape)}, {n} ranks")
        dev = tokens.device
        A = T * k
        cap_tok = self.capacity_tokens(A)
        C = cap_tok // ct
        comm = self._comm(C)
        epd = cfg.experts_per_device
        ranks = torch.arange(n, device=dev)

        dest = (expert_idx.long() // epd).reshape(n, A)              # [n, A]
        if token_valid is not None:
            # unowned tokens route to a sentinel, so they enter no buffer
            dest = torch.where(token_valid.repeat_interleave(k, dim=1), dest, n)
        # stable pack: position of each assignment within its destination
        order = torch.argsort(dest, dim=1, stable=True)
        counts = (dest[:, :, None] == ranks).sum(1)                  # [n, n]
        offsets = torch.cumsum(counts, 1) - counts
        dest_sorted = torch.gather(dest, 1, order)
        slot_sorted = torch.arange(A, device=dev) - torch.gather(
            offsets, 1, dest_sorted.clamp_max(n - 1))
        kept_sorted = (slot_sorted < cap_tok) & (dest_sorted < n)
        slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
        kept = torch.empty_like(kept_sorted).scatter_(1, order, kept_sorted)

        # pack as a gather: buffer slot s of destination j holds assignment
        # order[offsets[j] + s] while s < min(counts[j], cap)
        s_ar = torch.arange(cap_tok, device=dev)
        filled = s_ar < counts.clamp_max(cap_tok)[:, :, None]         # [n, n, cap]
        a_pos = (offsets[:, :, None] + s_ar).clamp_max(A - 1).reshape(n, -1)
        a_idx = torch.gather(order, 1, a_pos).view(n, n, cap_tok)
        tok_row = torch.where(filled, ranks[:, None, None] * T + a_idx // k, -1)
        x = token_gather(tokens.reshape(n * T, d).to(cfg.payload_dtype),
                         tok_row.reshape(-1)).view(n, n, C, ct * d)
        # float32 sideband carries expert id + 1, so an empty slot decodes to -1
        e_row = torch.where(filled, ranks[:, None, None] * A + a_idx, -1)
        e_plus = (expert_idx.reshape(n * A, 1) + 1).to(torch.float32)
        e_side = token_gather(e_plus, e_row.reshape(-1)).view(n, n, C, ct)

        send_chunks = ((counts.clamp_max(cap_tok) + ct - 1) // ct).to(torch.int32)
        plan = comm.plan_from_counts(send_chunks)                    # [n, n, K]
        y = comm.execute(x, plan)
        ey = comm.execute(e_side, plan)

        expert_global = torch.round(ey).long() - 1                   # [n, n, C, ct]
        expert_local = expert_global - (ranks * epd)[:, None, None, None]
        expert_local = torch.where(
            (expert_global >= 0) & (expert_local >= 0) & (expert_local < epd),
            expert_local, -1)
        owned = dest < n
        state = dict(
            plan=plan,
            dest=dest,
            slot=slot,
            kept=kept,
            C=C,
            cap_tok=cap_tok,
            # capacity drops among owned assignments (the reference's count
            # also includes the unowned ones of replicated-token mode)
            dropped=(owned & ~kept).sum(),
        )
        return y.view(n, n, C, ct, d), expert_local, state

    # -- combine -----------------------------------------------------------------
    def combine(
        self,
        expert_out: torch.Tensor,   # [n, n, C, ct, d] outputs in recv layout
        state,
        gate_w: torch.Tensor,       # [n, T, k] gate weights
    ) -> torch.Tensor:
        """Return expert outputs to token owners and gate-combine: [n, T, d]."""
        cfg = self.cfg
        n, ct, d = cfg.n_devices, cfg.chunk_tokens, cfg.d_model
        _, T, k = gate_w.shape
        C, cap_tok = state["C"], state["cap_tok"]
        comm = self._comm(C)
        ranks = torch.arange(n, device=expert_out.device)

        # transpose plan: what a rank received per source is what it sends back
        plan_T = state["plan"].transpose(0, 1)
        y = comm.execute(
            expert_out.reshape(n, n, C, ct * d).to(cfg.payload_dtype), plan_T)
        # gather each assignment's processed token from (dest, slot)
        row = (ranks[:, None] * n + state["dest"].clamp_max(n - 1)) * cap_tok \
            + state["slot"].clamp_max(cap_tok - 1)
        row = torch.where(state["kept"], row, -1)
        a_out = token_gather(y.reshape(n * n * cap_tok, d), row.reshape(-1))
        a_out = a_out.view(n, T, k, d)
        w = gate_w.to(a_out.dtype)[..., None]
        return (a_out * w).sum(dim=2)
