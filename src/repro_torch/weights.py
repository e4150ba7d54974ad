"""Carry a JAX parameter tree into the port, unchanged in layout and values."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.registry import family
from .sharding.context import ParallelContext
from .sharding.specs import shard_params


def params_from_jax(tree: Mapping, cfg: ModelConfig, ctx: ParallelContext):
    """The reference's parameter tree, as numpy arrays -> the port's params.

    Keys, list lengths and shapes must be the ones ``cfg``'s family expects
    (its ``param_shapes``).  Values are cast to ``ctx.param_dtype`` on
    ``ctx.device``, apart from the leaves the family keeps in float32 (its
    ``F32_PARAMS``; float64 in a float64 context), as the reference does.  With ``ctx.mesh``, this
    process's blocks (``sharding.specs.shard_params``).
    """
    mod = family(cfg)
    keep_f32 = set(getattr(mod, "F32_PARAMS", ()))

    def convert(node, shapes, path, key):
        if isinstance(shapes, dict):
            if not isinstance(node, Mapping) or set(node) != set(shapes):
                got = sorted(node) if isinstance(node, Mapping) else type(node)
                raise ValueError(f"{path or 'params'}: keys {got} != {sorted(shapes)}")
            return {k: convert(node[k], shapes[k], f"{path}/{k}", k) for k in shapes}
        if isinstance(shapes, list):
            if not isinstance(node, Sequence) or len(node) != len(shapes):
                got = len(node) if isinstance(node, Sequence) else type(node)
                raise ValueError(f"{path}: {got} entries != {len(shapes)}")
            return [convert(n, s, f"{path}/{i}", key)
                    for i, (n, s) in enumerate(zip(node, shapes))]
        arr = np.asarray(node)
        if arr.shape != tuple(shapes):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(shapes)}")
        dtype = (torch.promote_types(ctx.param_dtype, torch.float32) if key in keep_f32
                 else ctx.param_dtype)
        arr = arr.astype(np.float64 if dtype == torch.float64 else np.float32)
        return torch.as_tensor(arr).to(device=ctx.device, dtype=dtype)

    return shard_params(convert(tree, mod.param_shapes(cfg), "", ""), ctx)
