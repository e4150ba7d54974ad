"""Whisper-small [arXiv:2212.04356] — enc-dec; conv/mel frontend STUBBED.

Copy of ``repro/configs/whisper_small.py``.

``input_specs`` provides precomputed frame embeddings [B, 1500, d] (the
conv frontend output), per the assignment carve-out.  ``long_500k`` is
skipped: a 30 s-context enc-dec has no 500k-token decode semantics
(DESIGN.md §7).
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="whisper-small",
    arch_type="audio",
    n_layers=12,               # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    n_audio_frames=1500,
    skip_shapes=("long_500k",),
))
