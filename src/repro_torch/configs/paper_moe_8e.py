"""The paper's own MoE evaluation block (§V-D).

Two-node, eight-GPU EP: 8 experts, token dim 4096 bf16, two-layer FFN with
4x expansion, top-2 routing — the Fig. 8 testbed reproduced as a config.
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="paper-moe-8e",
    arch_type="moe",
    n_layers=1,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,                # 4x expansion
    vocab=32000,
    n_experts=8,
    top_k=2,
    window=4096,
))
