"""InternVL2-2B [arXiv:2404.16821] — InternViT (stub) + InternLM2 backbone.

Copy of ``repro/configs/internvl2_2b.py``.

The vision encoder + projector is a STUB per the assignment carve-out:
``input_specs`` provides precomputed patch embeddings [B, n_patches, d].
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    n_patches=256,             # one tile of ViT patch tokens after projector
    window=4096,
))
