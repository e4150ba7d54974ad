"""Model facade: the reference's ``Model`` interface for the ported families.

``build_model(cfg, ctx)`` returns a :class:`Model` exposing
``init / forward / init_cache / decode_step`` with the reference's
signatures, apart from ``init`` taking an integer seed.  The port supports
the ``moe`` family, without attention biases, so far.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from ..configs.base import InputShape, ModelConfig
from ..sharding.context import SINGLE, ParallelContext
from . import moe

_FAMILIES = {"moe": moe}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    ctx: ParallelContext
    mod: Any

    @functools.cached_property
    def moe_apply(self):
        """The expert layer, built once (its dispatcher caches dataplanes)."""
        return self.mod.make_moe_ffn(self.cfg, self.ctx)

    def init(self, seed: int):
        return self.mod.init(seed, self.cfg, self.ctx)

    def forward(self, params, batch: Dict[str, torch.Tensor], *, window=None,
                last_only: bool = False, stats: Optional[dict] = None):
        """-> (logits, aux); ``stats`` accumulates capacity drops."""
        return self.mod.forward(params, batch["tokens"], self.cfg, self.ctx,
                                window=window, last_only=last_only,
                                moe_apply=self.moe_apply, stats=stats)

    def init_cache(self, batch: int, shape: InputShape):
        """A ring-buffer cache as deep as ``shape.seq_len``."""
        return self.mod.init_cache(self.cfg, batch, max(shape.seq_len, 1), self.ctx)

    def decode_step(self, params, cache, token, pos: int,
                    stats: Optional[dict] = None):
        return self.mod.decode_step(params, cache, token, pos, self.cfg, self.ctx,
                                    moe_apply=self.moe_apply, stats=stats)


def build_model(cfg: ModelConfig, ctx: ParallelContext = SINGLE) -> Model:
    if cfg.arch_type not in _FAMILIES:
        raise KeyError(f"arch_type {cfg.arch_type!r} is not ported yet")
    if cfg.qkv_bias:
        raise ValueError(f"{cfg.name}: attention biases are not ported yet")
    return Model(cfg, ctx, _FAMILIES[cfg.arch_type])
