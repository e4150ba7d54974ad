"""Data pipeline: a deterministic synthetic LM stream, sharded by host.

Copy of ``repro/data/pipeline.py`` (numpy only, so its batches equal the
reference's bit for bit).  The corpus is a stationary Zipf-like token
process with local bigram structure (so losses fall measurably in the
example training runs), deterministic in (seed, step, shard): every host
computes its own shard without coordination.  ``add_modality_stubs``
attaches the audio and vlm families' stub inputs, drawn as the reference
draws them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1        # host shards
    shard: int = 0
    zipf_a: float = 1.2
    ngram_repeat: float = 0.3   # P(copy a recent token) — learnable structure


class SyntheticLM:
    """Deterministic, shardable synthetic LM batches."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global_batch must divide by n_shards")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards
        # stationary Zipf token distribution
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self._p = p / p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard])
        )
        B, S = self.local_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(B, S + 1), p=self._p)
        # inject learnable bigram structure: with prob ngram_repeat, token
        # t+1 = f(token t) for a fixed random permutation f.
        perm_rng = np.random.default_rng(cfg.seed)  # fixed across steps
        f = perm_rng.permutation(cfg.vocab)
        copy = rng.random((B, S)) < cfg.ngram_repeat
        # apply sequentially so chained copies still satisfy t+1 = f(t) on
        # the FINAL sequence (vectorised-over-batch, loop over positions).
        for t in range(S):
            toks[:, t + 1] = np.where(copy[:, t], f[toks[:, t]], toks[:, t + 1])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def add_modality_stubs(batch: Dict[str, np.ndarray], cfg, rng_seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    """Attach stub frame/patch embeddings for audio/vlm archs (carve-out)."""
    rng = np.random.default_rng(rng_seed)
    B = batch["tokens"].shape[0]
    if cfg.arch_type == "audio":
        batch = dict(batch)
        batch["frames"] = rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)
        ).astype(np.float32)
        # whisper decoder max target length
        batch["tokens"] = batch["tokens"][:, :448]
        batch["labels"] = batch["labels"][:, :448]
    if cfg.arch_type == "vlm":
        batch = dict(batch)
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)
        ).astype(np.float32)
    return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device`` (the port's own helper): integer
    arrays as int64, floating ones (frames, patches) keep their dtype."""
    return {k: torch.as_tensor(v, device=device,
                               dtype=None if np.asarray(v).dtype.kind == "f" else torch.int64)
            for k, v in batch.items()}
