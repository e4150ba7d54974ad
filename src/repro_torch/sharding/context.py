"""Parallelism context threaded through the port's models.

Counterpart of ``repro/sharding/context.py`` without a mesh: the ranks of
the expert-parallel group are stacked in one process (see
``core/dataplane.py``), so the context carries only the EP group's geometry,
the dtypes and the device.

  * ``ep_size`` / ``group_size`` — EP ranks, and ranks per "node" on the
    NIMBLE axis (the paper's 2 x 4 testbed is ``ep_size=8, group_size=4``);
  * ``moe_mode`` / ``moe_chunk_tokens`` / ``moe_alt_frac`` — the
    dispatcher's dataplane mode, chunk size in tokens, and alternate-path
    slot share;
  * ``device`` — where parameters, caches and activations live: the card
    unless the caller asks for ``"cpu"``;
  * ``session`` — an optional :class:`repro_torch.api.Session` supplying
    ready-wired MoE dispatchers (cost model, planner config, runtime
    telemetry); ``None`` builds the dispatcher from this context alone.

``ep_size == 1`` (``SINGLE``) computes the experts locally.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    ep_size: int = 1
    group_size: int = 4
    moe_mode: str = "nimble"               # nimble | direct | stripe
    moe_chunk_tokens: int = 16
    moe_alt_frac: float = 0.5
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    device: str = "cuda"
    session: Optional[object] = None


SINGLE = ParallelContext()

#: the launchers' ``--dtype`` names
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
