"""Production and test meshes over an initialised process group.

Counterpart of ``repro/launch/mesh.py``.  Single pod: (data=16, model=16) =
256 devices.  Multi-pod: (pod=2, data=16, model=16) = 512 devices; the pod
axis is pure data parallel (gradient all-reduce over the inter-pod links),
the model axis hosts tensor/expert parallelism and is the NIMBLE
orchestration axis.  The shapes are plain mappings (:func:`production_shape`),
which is all that ``sharding/specs.py`` reads.

FUNCTIONS, not module constants: importing this module touches no device
and no process group.  A ``DeviceMesh`` is built over the group that
``torch.distributed.init_process_group`` (or ``launch/dist.py``'s
``spawn``) initialised, on the card under NCCL and on the CPU under gloo.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple


def production_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """Axis name -> size of the production mesh."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def _device_type() -> str:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group "
                           "(or repro_torch.launch.dist.spawn) first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def ep_mesh_shape(procs: int, ep_size: int) -> Tuple[int, int]:
    """(data, model) for ``procs`` processes hosting ``ep_size`` EP ranks:
    as many processes on the model axis as divide both (the reference's
    (data 2, model 4) for 8 processes and EP 4)."""
    model = math.gcd(procs, ep_size)
    return procs // model, model


def make_test_mesh(n_devices: Optional[int] = None, model: Optional[int] = None):
    """A ``("data", "model")`` mesh over the initialised group (selftests,
    examples): ``n_devices`` processes (the world by default), ``model`` of
    them on the model axis (all by default), the rest on data."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = _device_type()
    n = n_devices or dist.get_world_size()
    model = model or n
    if n % model:
        raise ValueError(f"model {model} does not divide {n} devices")
    return init_device_mesh(device, (n // model, model), mesh_dim_names=("data", "model"))
