from .base import (
    ARCH_IDS,
    InputShape,
    ModelConfig,
    all_configs,
    get_config,
    register,
)

__all__ = ["ModelConfig", "InputShape", "ARCH_IDS",
           "get_config", "all_configs", "register"]
