"""TinyLlama 1.1B [arXiv:2401.02385] — llama2-arch small, GQA kv=4.

Copy of ``repro/configs/tinyllama_1_1b.py``.
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    rope_theta=10000.0,
    window=4096,               # SWA variant for long_500k (DESIGN.md §7)
))
