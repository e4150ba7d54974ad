"""Model facade: the reference's ``Model`` interface over the six families.

``build_model(cfg, ctx)`` returns a :class:`Model` exposing
``init / forward / loss / init_cache / decode_step / supports /
input_specs`` with the reference's signatures, apart from ``init`` taking
an integer seed.  The families are the reference's: ``dense``
(llama-style), ``moe``, ``hybrid`` (zamba2), ``ssm`` (xLSTM), ``audio``
(whisper) and ``vlm`` (internvl2).  Only the ``moe`` family takes the expert
layer (``moe_apply``) and the ``stats`` accumulator of capacity drops;
every family but ``ssm`` takes ``window``; ``audio`` takes the batch's
``frames`` and ``vlm`` its ``patches``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from ..configs.base import InputShape, ModelConfig
from ..sharding.context import SINGLE, ParallelContext
from ..sharding.specs import shard_params
from . import dense, encdec, hybrid, moe, vlm, xlstm

_FAMILIES = {"dense": dense, "moe": moe, "hybrid": hybrid, "ssm": xlstm,
             "audio": encdec, "vlm": vlm}

# decode cache length policy: sub-quadratic archs keep O(1)/windowed state
_LONG = "long_500k"


def family(cfg: ModelConfig):
    """The model module of ``cfg``'s family."""
    if cfg.arch_type not in _FAMILIES:
        raise KeyError(f"unknown arch_type {cfg.arch_type!r}")
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

    def _extra(self, stats: Optional[dict], rows=None) -> Dict[str, Any]:
        """The family's own keyword arguments to ``forward``/``decode_step``;
        ``rows`` (a ``RowBlock``) tells the expert layer how the batch lies."""
        if self.cfg.arch_type == "moe":
            apply = self.moe_apply if rows is None else functools.partial(
                self.moe_apply, rows=rows)
            return {"moe_apply": apply, "stats": stats}
        if stats is not None:
            raise ValueError(f"{self.cfg.name}: stats counts MoE capacity drops; "
                             f"the {self.cfg.arch_type} family has none")
        return {}

    def init(self, seed: int):
        """Random weights from ``seed``: with a mesh, this process's blocks of
        the same weights (``sharding.specs.shard_params``)."""
        return shard_params(self.mod.init(seed, self.cfg, self.ctx), self.ctx)

    def forward(self, params, batch: Dict[str, torch.Tensor], *, window=None,
                last_only: bool = False, stats: Optional[dict] = None, rows=None):
        """-> (logits, aux); ``stats`` (moe only) accumulates capacity drops;
        ``rows``: the batch's placement over a mesh (``train/step.py``;
        ``None``: each process's rows its own)."""
        extra = self._extra(stats, rows)
        if self.mod is not xlstm:        # attention-free: no window to apply
            extra["window"] = window
        if self.cfg.arch_type == "audio":
            extra["frames"] = batch["frames"]
        if self.cfg.arch_type == "vlm":
            extra["patches"] = batch["patches"]
        out = self.mod.forward(params, batch["tokens"], self.cfg, self.ctx,
                               last_only=last_only, **extra)
        if isinstance(out, tuple):
            return out                   # (logits, aux)
        return out, torch.zeros((), dtype=torch.float32, device=out.device)

    def loss(self, params, batch: Dict[str, torch.Tensor], *, window=None,
             aux_weight: float = 0.01, stats: Optional[dict] = None,
             rows=None) -> torch.Tensor:
        """Mean next-token NLL (``log_softmax`` in float32) + ``aux_weight`` x aux.

        The reference's ``Model.loss`` (``registry.py:59-68``); ``stats`` as
        in :meth:`forward`, ``rows`` too.  The vlm family's logits cover the
        patch prefix too: only the text positions are scored.
        """
        logits, aux = self.forward(params, batch, window=window, stats=stats, rows=rows)
        labels = batch["labels"].long()
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(lp, -1, labels[..., None])[..., 0]
        return nll.mean() + aux_weight * aux

    def cache_len(self, shape: InputShape) -> int:
        if self.cfg.arch_type == "ssm":
            return 0                     # O(1) recurrent state
        if shape.name == _LONG:
            return self.cfg.window or 4096
        if self.cfg.arch_type == "audio":
            return min(shape.seq_len, 448)         # whisper's longest target
        return shape.seq_len

    def init_cache(self, batch: int, shape: InputShape):
        return self.mod.init_cache(self.cfg, batch, max(self.cache_len(shape), 1),
                                   self.ctx)

    def decode_step(self, params, cache, token, pos: int,
                    stats: Optional[dict] = None):
        return self.mod.decode_step(params, cache, token, pos, self.cfg, self.ctx,
                                    **self._extra(stats))

    # -- input specs -------------------------------------------------------------
    def supports(self, shape: InputShape) -> bool:
        return shape.name not in self.cfg.skip_shapes

    def input_specs(self, shape: InputShape) -> Dict[str, torch.Tensor]:
        """Stand-ins for every model input: tensors on the ``meta`` device
        (shape and dtype, no storage), as the reference's ``ShapeDtypeStruct``s."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def spec(shape_, dtype=torch.int32):
            return torch.empty(shape_, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            if cfg.arch_type == "audio":
                # the decoder scores text; the encoder consumes stub frames
                S = min(S, 448)
            specs = {"tokens": spec((B, S)), "labels": spec((B, S))}
            if cfg.arch_type == "audio":
                specs["frames"] = spec((B, cfg.n_audio_frames, cfg.d_model),
                                       self.ctx.compute_dtype)
            if cfg.arch_type == "vlm":
                specs["patches"] = spec((B, cfg.n_patches, cfg.d_model),
                                        self.ctx.compute_dtype)
            return specs
        # decode: one token against a seq_len-deep cache
        return {"token": spec((B,)), "pos": spec(())}


def build_model(cfg: ModelConfig, ctx: ParallelContext = SINGLE) -> Model:
    mod = family(cfg)
    if mod is not moe and ctx.ep_size > 1:
        raise ValueError(f"{cfg.name}: the {cfg.arch_type} family has no experts to "
                         f"place; ep_size must be 1, got {ctx.ep_size}")
    return Model(cfg, ctx, mod)
