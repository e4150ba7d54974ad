"""Granite-3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

Copy of ``repro/configs/granite_moe_1b_a400m.py``; the example trainer
(``examples/train_moe_nimble.py``) derives its presets from it.

32 experts, top-8; small MoE — exercises EP skew at low expert counts.
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    top_k=8,
    window=4096,
))
