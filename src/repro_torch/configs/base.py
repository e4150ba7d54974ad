"""Config system: model dataclass, input shapes and registry.

Copy of ``repro/configs/base.py``: the same dataclasses, the four assigned
input shapes and the reference's eleven architectures.  One
``configs/<arch>.py`` per architecture registers its published
configuration.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

# --------------------------------------------------------------------------- #
# model config
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 2.0
    # ssm / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0          # hybrid: shared attn block period
    # xlstm
    slstm_every: int = 2         # alternate sLSTM / mLSTM
    mlstm_chunk: int = 0         # 0 = per-step scan; >0 = chunkwise-parallel
    #                              mLSTM (§Perf memory-term optimization)
    slstm_assoc: bool = False    # sLSTM via associative_scan (§Perf)
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window size (sub-quadratic mode)
    # enc-dec (audio)
    n_enc_layers: int = 0
    n_audio_frames: int = 1500
    # vlm
    n_patches: int = 0           # image patch tokens prepended (stub frontend)
    head_dim_override: Optional[int] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # which input shapes this arch supports (DESIGN.md §7 skips)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        if self.head_dim_override:
            return self.head_dim_override
        return self.d_model // self.n_heads

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (brief: 2L, d<=512)."""
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        d = max(d_model // heads, 8) * heads
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            d_ff=max(64, d * 2) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, max_experts) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 2) if self.ssm_heads else 0,
            n_enc_layers=min(self.n_enc_layers, 2) if self.n_enc_layers else 0,
            n_audio_frames=min(self.n_audio_frames, 64),
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            window=min(self.window, 64) if self.window else None,
            head_dim_override=None,
        )


# --------------------------------------------------------------------------- #
# input shapes (assigned)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #

ARCH_IDS: List[str] = [
    "qwen3-moe-235b-a22b",
    "tinyllama-1.1b",
    "zamba2-1.2b",
    "internvl2-2b",
    "qwen2.5-14b",
    "llama3-8b",
    "granite-moe-1b-a400m",
    "xlstm-125m",
    "smollm-135m",
    "whisper-small",
    # the paper's own evaluation model (§V-D): 8-expert MoE block testbed
    "paper-moe-8e",
]

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        if arch_id not in ARCH_IDS:
            raise KeyError(f"unknown architecture {arch_id!r}")
        mod = arch_id.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[arch_id]


def all_configs() -> Dict[str, ModelConfig]:
    for a in ARCH_IDS:
        get_config(a)
    return dict(_REGISTRY)
