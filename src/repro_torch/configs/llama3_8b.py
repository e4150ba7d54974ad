"""Llama-3 8B [arXiv:2407.21783] — GQA kv=8, 128k vocab.

Copy of ``repro/configs/llama3_8b.py``.
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    window=4096,
))
