"""Model facade: the reference's ``Model`` interface for the ported families.

``build_model(cfg, ctx)`` returns a :class:`Model` exposing
``init / forward / loss / init_cache / decode_step`` with the reference's
signatures, apart from ``init`` taking an integer seed.  The port supports
the ``dense`` family (llama-style), the ``moe`` family and the ``ssm``
family (xLSTM).  Only the ``moe`` family takes the expert layer
(``moe_apply``) and the ``stats`` accumulator of capacity drops; the
attention families take ``window``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from ..configs.base import InputShape, ModelConfig
from ..sharding.context import SINGLE, ParallelContext
from . import dense, moe, xlstm

_FAMILIES = {"dense": dense, "moe": moe, "ssm": xlstm}

# decode cache length policy: sub-quadratic archs keep O(1)/windowed state
_LONG = "long_500k"


def family(cfg: ModelConfig):
    """The model module of ``cfg``'s family."""
    if cfg.arch_type not in _FAMILIES:
        raise KeyError(f"arch_type {cfg.arch_type!r} is not ported yet")
    return _FAMILIES[cfg.arch_type]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    ctx: ParallelContext
    mod: Any

    @functools.cached_property
    def moe_apply(self):
        """The expert layer, built once (its dispatcher caches dataplanes)."""
        return self.mod.make_moe_ffn(self.cfg, self.ctx)

    def _extra(self, stats: Optional[dict]) -> Dict[str, Any]:
        """The family's own keyword arguments to ``forward``/``decode_step``."""
        if self.cfg.arch_type == "moe":
            return {"moe_apply": self.moe_apply, "stats": stats}
        if stats is not None:
            raise ValueError(f"{self.cfg.name}: stats counts MoE capacity drops; "
                             f"the {self.cfg.arch_type} family has none")
        return {}

    def init(self, seed: int):
        return self.mod.init(seed, self.cfg, self.ctx)

    def forward(self, params, batch: Dict[str, torch.Tensor], *, window=None,
                last_only: bool = False, stats: Optional[dict] = None):
        """-> (logits, aux); ``stats`` (moe only) accumulates capacity drops."""
        extra = self._extra(stats)
        if self.mod is not xlstm:        # attention-free: no window to apply
            extra["window"] = window
        out = self.mod.forward(params, batch["tokens"], self.cfg, self.ctx,
                               last_only=last_only, **extra)
        if isinstance(out, tuple):
            return out                   # (logits, aux)
        return out, torch.zeros((), dtype=torch.float32, device=out.device)

    def loss(self, params, batch: Dict[str, torch.Tensor], *, window=None,
             aux_weight: float = 0.01, stats: Optional[dict] = None) -> torch.Tensor:
        """Mean next-token NLL (``log_softmax`` in float32) + ``aux_weight`` x aux.

        The reference's ``Model.loss`` (``registry.py:59-68``); ``stats`` as
        in :meth:`forward`.
        """
        logits, aux = self.forward(params, batch, window=window, stats=stats)
        labels = batch["labels"].long()
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(lp, -1, labels[..., None])[..., 0]
        return nll.mean() + aux_weight * aux

    def cache_len(self, shape: InputShape) -> int:
        if self.cfg.arch_type == "ssm":
            return 0                     # O(1) recurrent state
        if shape.name == _LONG:
            return self.cfg.window or 4096
        return shape.seq_len

    def init_cache(self, batch: int, shape: InputShape):
        return self.mod.init_cache(self.cfg, batch, max(self.cache_len(shape), 1),
                                   self.ctx)

    def decode_step(self, params, cache, token, pos: int,
                    stats: Optional[dict] = None):
        return self.mod.decode_step(params, cache, token, pos, self.cfg, self.ctx,
                                    **self._extra(stats))


def build_model(cfg: ModelConfig, ctx: ParallelContext = SINGLE) -> Model:
    mod = family(cfg)
    if mod is not moe and ctx.ep_size > 1:
        raise ValueError(f"{cfg.name}: the {cfg.arch_type} family has no experts to "
                         f"place; ep_size must be 1, got {ctx.ep_size}")
    return Model(cfg, ctx, mod)
