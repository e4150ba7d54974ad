"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + shared attention.

Copy of ``repro/configs/zamba2_1_2b.py``.
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,             # shared attn block is MHA
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_heads=32,
    ssm_expand=2,
    attn_every=6,              # shared attention block invoked every 6 layers
))
