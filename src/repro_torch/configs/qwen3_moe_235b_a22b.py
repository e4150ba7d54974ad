"""Qwen3-MoE 235B-A22B family [hf:Qwen/Qwen3-30B-A3B scaled per assignment].

Copy of ``repro/configs/qwen3_moe_235b_a22b.py``.

128 experts, top-8 routing, GQA with 4 KV heads, per-expert FFN 1536.
Primary NIMBLE target: EP dispatch/combine is the paper's skewed
All-to-Allv (§V-D).
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                 # per-expert intermediate size
    vocab=151936,
    n_experts=128,
    top_k=8,
    head_dim_override=128,
    qkv_bias=False,
    rope_theta=1e6,
    window=4096,               # sub-quadratic variant enables long_500k
))
