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
from ..sharding.gather import Placement, placement
from ..sharding.specs import shard_params
from ..sharding.tp import vocab_parallel_nll
from . import dense, encdec, hybrid, moe, vlm, xlstm
from .layers import nll as token_nll

_FAMILIES = {"dense": dense, "moe": moe, "hybrid": hybrid, "ssm": xlstm,
             "audio": encdec, "vlm": vlm}

# decode cache length policy: sub-quadratic archs keep O(1)/windowed state
_LONG = "long_500k"

#: families that serve over a mesh as the reference places them: the model
#: group shares the prefill's and the decode step's products, and the KV
#: cache lies over it by heads or by slots (``sharding/specs.py::KVLayout``),
#: zamba2's Mamba states by SSM heads, xLSTM's (``ssm``) mLSTM states by
#: heads and value columns and its sLSTM states by channels
#: (``models/xlstm.py``)
_SERVE_TP_FAMILIES = (dense, vlm, moe, hybrid, encdec, xlstm)


class ServeCache(dict):
    """A decode cache's leaves (this process's blocks of them) and ``rows``,
    the serving ``RowBlock`` they were cut for (``None``: whole leaves, each
    process's rows its own), which :meth:`Model.decode_step` reads, so that
    the cache and the step cannot disagree on where the rows lie."""

    def __init__(self, leaves, rows=None):
        super().__init__(leaves)
        self.rows = rows


class ServeStates(list):
    """xLSTM's per-layer states (this process's blocks of them) and ``rows``,
    as :class:`ServeCache` holds a dict cache's."""

    def __init__(self, states, rows=None):
        super().__init__(states)
        self.rows = rows


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

    @property
    def placement(self) -> Placement:
        """Where the parameters lie over ``ctx.mesh`` (``sharding/gather.py``)."""
        return placement(self.mod.param_shapes, self.cfg, self.ctx)

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

    def serve_placement(self, rows) -> Placement:
        """Serving's placement of the parameters for ``rows`` (a ``RowBlock``
        or ``None``): TP use where the model group holds them replicated, for
        the families of :data:`_SERVE_TP_FAMILIES`; :attr:`placement` else."""
        tp_rows = rows if self.mod in _SERVE_TP_FAMILIES else None
        return placement(self.mod.param_shapes, self.cfg, self.ctx, tp_rows)

    def serve_rows(self, global_batch: int):
        """Serving's placement of this process's rows of ``global_batch``
        (``ctx.serve_rows``), the one place it is decided: the ``rows`` of a
        prefill's :meth:`forward` and the rows :meth:`init_cache` records with
        the cache for :meth:`decode_step`.  ``None`` without a mesh or on a
        world of one (every leaf read as it is, the rows its own)."""
        if self.ctx.mesh is None or self.ctx.mesh.size() == 1:
            return None
        return self.ctx.serve_rows(global_batch)

    def forward(self, params, batch: Dict[str, torch.Tensor], *, window=None,
                last_only: bool = False, stats: Optional[dict] = None, rows=None,
                place: Optional[Placement] = None):
        """-> (logits, aux); ``stats`` (moe only) accumulates capacity drops;
        ``rows``: the batch's placement over a mesh (``train/step.py``, or
        :meth:`serve_rows`); ``place``: the parameters' placement.  Without
        ``place`` this is serving's prefill: the parameters are placed by
        :meth:`serve_placement` for ``rows`` (on a mesh the model group shares
        the products of its replicated rows; with no ``rows`` every leaf is
        read whole and each process's rows are its own), and the logits come
        back whole, their vocab blocks gathered over the group."""
        serving = place is None
        if serving:
            place = self.serve_placement(rows)
        extra = self._extra(stats, rows)
        if self.mod is not xlstm:        # attention-free: no window to apply
            extra["window"] = window
        if self.cfg.arch_type == "audio":
            extra["frames"] = batch["frames"]
        if self.cfg.arch_type == "vlm":
            extra["patches"] = batch["patches"]
        out = self.mod.forward(params, batch["tokens"], self.cfg, self.ctx,
                               last_only=last_only, place=place, **extra)
        logits, aux = out if isinstance(out, tuple) else (
            out, torch.zeros((), dtype=torch.float32, device=out.device))
        return (place.whole_vocab(logits) if serving else logits), aux

    def loss(self, params, batch: Dict[str, torch.Tensor], *, window=None,
             aux_weight: float = 0.01, stats: Optional[dict] = None,
             rows=None) -> torch.Tensor:
        """Mean next-token NLL (``log_softmax`` in at least float32) + ``aux_weight`` x aux.

        The reference's ``Model.loss`` (``registry.py:59-68``); ``stats`` as
        in :meth:`forward`, ``rows`` too.  The vlm family's logits cover the
        patch prefix too: only the text positions are scored.  Where the
        model group holds the rows replicated and divides the vocab, each
        process computes its vocab block of the logits and the NLL comes
        from the blocks (``sharding/tp.py::vocab_parallel_nll``).
        """
        place = placement(self.mod.param_shapes, self.cfg, self.ctx, rows)
        logits, aux = self.forward(params, batch, window=window, stats=stats, rows=rows,
                                   place=place)
        labels = batch["labels"].long()
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        if place.vocab is not None:
            nll = vocab_parallel_nll(logits, labels, place.vocab.start, place.tp)
        else:
            nll = token_nll(logits, labels)
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
        """A cache of ``batch`` rows for ``shape``.  On a mesh ``batch`` is the
        global batch and the cache holds this process's rows (those that
        :meth:`serve_rows` gives it).  The families of
        :data:`_SERVE_TP_FAMILIES` return a :class:`ServeCache` that records
        those rows and holds this process's KV heads or slots over the model
        group (``sharding/specs.py::KVLayout``, the blocks ``shard_cache`` cuts
        from the whole), ``slot_pos`` whole, zamba2's Mamba states by SSM
        heads; xLSTM a :class:`ServeStates`, its layers' states by heads and
        value columns or by channels."""
        width = max(self.cache_len(shape), 1)
        rows = self.serve_rows(batch)
        local = batch if rows is None else batch // rows.count
        if self.mod not in _SERVE_TP_FAMILIES:
            return self.mod.init_cache(self.cfg, local, width, self.ctx)
        place = None if rows is None else self.serve_placement(rows)
        cache = self.mod.init_cache(self.cfg, local, width, self.ctx, place=place)
        return (ServeStates if isinstance(cache, list) else ServeCache)(cache, rows)

    def decode_step(self, params, cache, token, pos: int,
                    stats: Optional[dict] = None):
        """token [B] at position ``pos`` (a host int) -> (logits [B, V], the
        cache updated in place).  On a mesh ``token`` holds this process's
        rows and ``cache`` its blocks (:meth:`init_cache`), placed by the rows
        the cache records: the families of :data:`_SERVE_TP_FAMILIES` take
        :meth:`serve_placement` for them and return the logits whole; a cache
        that records none (or a plain dict) is read whole, the rows each
        process's own.  ``stats`` (moe) gains this process's drops: the
        model group routes its rows once, so the world's sum over the
        replicas on the data axes (``train/step.py::routed_copies``) is the
        step's."""
        if self.mod not in _SERVE_TP_FAMILIES:
            return self.mod.decode_step(params, cache, token, pos, self.cfg, self.ctx,
                                        **self._extra(stats))
        rows = getattr(cache, "rows", None)
        place = self.serve_placement(rows)
        logits, cache = self.mod.decode_step(params, cache, token, pos, self.cfg, self.ctx,
                                             place=place, **self._extra(stats, rows))
        return place.whole_vocab(logits), cache

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
