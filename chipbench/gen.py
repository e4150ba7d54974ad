"""The benchmark's one traffic generator: batches of token ids from a seed.

A mix's file (``traffic/<mix>.json``) gives the parameters; this module
reads them.  Tokens follow a stationary Zipf law over the vocabulary
(``zipf_a``; 0 draws them uniformly), and with probability
``ngram_repeat`` a token is followed by a fixed permutation of itself, so
that text-like repeats exist.  Batch ``i`` of seed ``s`` is drawn from
``SeedSequence([s, i, 0])``; the permutation is the mix's own, drawn from
its ``ngram_seed``, so that every seed repeats the same ids as often (which
ids are frequent decides the routing, and so the work): every seed gives
the same sizes and frequencies, and the same seed the same tokens.  The arithmetic is
a frozen copy of the ``SyntheticLM`` stream of ``repro_torch``'s data
pipeline, so that the benchmark's inputs do not move with the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def zipf_p(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, vocab + 1, dtype=np.float64), a)
    return p / p.sum()


def batch(seed: int, i: int, vocab: int, mix: dict) -> Dict[str, np.ndarray]:
    """Batch ``i``: ``tokens`` [B, S] and ``labels`` [B, S] (the next tokens),
    int32, B = ``mix["batch"]``, S = ``mix["seq"]``."""
    b, s = mix["batch"], mix["seq"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, i, 0]))
    toks = rng.choice(vocab, size=(b, s + 1), p=zipf_p(vocab, mix["zipf_a"]))
    f = np.random.default_rng(mix["ngram_seed"]).permutation(vocab)
    copy = rng.random((b, s)) < mix["ngram_repeat"]
    for t in range(s):
        toks[:, t + 1] = np.where(copy[:, t], f[toks[:, t]], toks[:, t + 1])
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def pool(seed: int, vocab: int, mix: dict):
    """The mix's ``pool`` batches of this seed, each all distinct rows."""
    return [batch(seed, i, vocab, mix) for i in range(mix["pool"])]

