"""Batched serving engine: prefill + greedy/temperature decode loop.

Counterpart of ``repro/serve/engine.py``.  ``make_serve_step`` is one
decode step, as the dry run counts it.  The prompt is prefilled as P
decode steps (the reference's prefill scan runs exactly those steps), then
each new token is sampled from the last logits: argmax when greedy, else a
draw from ``softmax(logits / temperature)`` with a ``torch.Generator``
seeded from ``seed`` (so its draws differ from JAX's).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import InputShape
from ..models.registry import Model


def make_serve_step(model: Model):
    """The single-token decode function that the dry run counts for the decode
    shapes (the reference's ``serve/engine.py:25-29``)."""
    def serve_step(params, cache, token, pos: int):
        """token [B] int, pos a host int -> (logits [B, V], cache')."""
        return model.decode_step(params, cache, token, pos)
    return serve_step


@dataclasses.dataclass
class ServeEngine:
    model: Model
    params: object
    max_len: int = 256

    def prefill(self, cache, prompts: torch.Tensor,
                stats: Optional[dict] = None):
        """prompts [B, P] -> (last logits [B, V], cache)."""
        logits = None
        for j in range(prompts.shape[1]):
            logits, cache = self.model.decode_step(self.params, cache,
                                                   prompts[:, j], j, stats=stats)
        return logits, cache

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,          # [B, P] int prompt tokens
        n_new: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
        stats: Optional[dict] = None,
    ) -> np.ndarray:
        B, P = prompts.shape
        if P < 1:
            raise ValueError("prompts must carry at least one token")
        dev = self.model.ctx.device
        shape = InputShape("serve", self.max_len, B, "decode")
        cache = self.model.init_cache(B, shape)
        gen = torch.Generator(device=dev).manual_seed(seed)
        logits, cache = self.prefill(
            cache, torch.as_tensor(prompts, dtype=torch.int64, device=dev), stats)
        out: List[torch.Tensor] = []
        for j in range(n_new):
            if temperature > 0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            logits, cache = self.model.decode_step(self.params, cache, tok, P + j,
                                                   stats=stats)
        return torch.stack(out, dim=1).cpu().numpy()
