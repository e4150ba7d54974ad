"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small, kv=3.

Copy of ``repro/configs/smollm_135m.py``.
"""
from .base import ModelConfig, register

register(ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    window=4096,
))
