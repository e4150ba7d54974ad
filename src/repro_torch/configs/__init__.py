from .base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    all_configs,
    get_config,
    register,
)

__all__ = ["ModelConfig", "InputShape", "ARCH_IDS", "INPUT_SHAPES",
           "get_config", "all_configs", "register"]
