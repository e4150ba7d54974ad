"""Carry a JAX parameter tree into the port, unchanged in layout and values."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.moe import param_shapes
from .sharding.context import ParallelContext


def params_from_jax(tree: Mapping, cfg: ModelConfig, ctx: ParallelContext):
    """The reference's parameter tree, as numpy arrays -> the port's params.

    Keys and shapes must be the ones the port's ``moe`` model expects;
    values are cast to ``ctx.param_dtype`` on ``ctx.device``.
    """
    def convert(node, shapes, path):
        if isinstance(shapes, dict):
            if not isinstance(node, Mapping) or set(node) != set(shapes):
                got = sorted(node) if isinstance(node, Mapping) else type(node)
                raise ValueError(f"{path or 'params'}: keys {got} != {sorted(shapes)}")
            return {k: convert(node[k], shapes[k], f"{path}/{k}") for k in shapes}
        arr = np.asarray(node)
        if arr.shape != tuple(shapes):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(shapes)}")
        return torch.as_tensor(arr.astype(np.float32)).to(
            device=ctx.device, dtype=ctx.param_dtype)

    return convert(tree, param_shapes(cfg), "")
