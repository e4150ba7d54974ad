"""InternVL2-style VLM [arXiv:2404.16821]: a vision stub and the dense backbone.

Counterpart of ``repro/models/vlm.py``.  The InternViT encoder + MLP
projector is a stub, as in the reference: ``patches [B, n_patches, d]``
arrive as precomputed projected patch embeddings.  The language model is
the dense llama-family backbone (``dense.py``); the image tokens are
prepended to the text sequence as a prefix, uniform across the batch.

Decode: ``pos`` is the absolute position including the patch prefix.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..sharding.context import SINGLE, ParallelContext
from ..sharding.gather import placement
from . import dense

param_shapes = dense.param_shapes


def init(seed: int, cfg: ModelConfig, ctx: ParallelContext = SINGLE):
    return dense.init(seed, cfg, ctx)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx: ParallelContext = SINGLE,
            *, patches: Optional[torch.Tensor] = None, window: Optional[int] = None,
            last_only: bool = False, place=None, **_) -> torch.Tensor:
    """tokens [B, S_text], patches [B, P, d] -> logits [B, P + S_text, V];
    ``place`` as ``dense.forward`` takes it."""
    if patches is None:
        raise ValueError("the vlm family needs stub patch embeddings (patches)")
    place = placement(param_shapes, cfg, ctx) if place is None else place
    tok_emb = dense.embed(params, tokens, place)
    x = torch.cat([patches.to(tok_emb.dtype), tok_emb], dim=1)
    return dense.forward(params, tokens, cfg, ctx, window=window, inputs_embeds=x,
                         last_only=last_only, place=place)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, ctx: ParallelContext = SINGLE,
               place=None):
    return dense.init_cache(cfg, batch, cache_len, ctx, place)


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig,
                ctx: ParallelContext = SINGLE, *, place=None):
    """``pos`` is the absolute position INCLUDING the patch prefix."""
    return dense.decode_step(params, cache, token, pos, cfg, ctx, place=place)
