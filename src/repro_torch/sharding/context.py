"""Parallelism context threaded through the port's models.

Counterpart of ``repro/sharding/context.py``:

  * ``mesh`` — a ``torch.distributed.device_mesh.DeviceMesh`` (``None``:
    one process, the EP group's ranks stacked in it, see
    ``core/dataplane.py``);
  * ``data_axes`` — mesh axes sharding the batch (with "pod": pods are pure
    data-parallel replicas);
  * ``model_axis`` — the expert-parallel axis, which is also the NIMBLE
    orchestration axis;
  * ``ep_size`` / ``group_size`` — EP **ranks**, and ranks per "node" on the
    NIMBLE axis (the paper's 2 x 4 testbed is ``ep_size=8, group_size=4``).
    The mesh's model dim counts **processes** and must divide ``ep_size``:
    each process hosts ``ep_size / model`` consecutive ranks, stacked.  A
    family without experts takes ``ep_size=1`` on any mesh (every process
    data-parallel);
  * ``moe_mode`` / ``moe_chunk_tokens`` / ``moe_alt_frac`` — the
    dispatcher's dataplane mode, chunk size in tokens, and alternate-path
    slot share;
  * ``remat`` — recompute each block's activations in the backward
    (``torch.utils.checkpoint``) instead of keeping them;
  * ``device`` — where parameters, caches and activations live: the card
    unless the caller asks for ``"cpu"``;
  * ``session`` — an optional :class:`repro_torch.api.Session` supplying
    ready-wired MoE dispatchers (cost model, planner config, runtime
    telemetry); ``None`` builds the dispatcher from this context alone.

``ep_size == 1`` (``SINGLE``) computes the experts locally.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: Optional[object] = None          # torch DeviceMesh
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    ep_size: int = 1
    group_size: int = 4
    moe_mode: str = "nimble"               # nimble | direct | stripe
    moe_chunk_tokens: int = 16
    moe_alt_frac: float = 0.5
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    remat: bool = False                    # activation checkpoint per block
    device: str = "cuda"
    session: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None and self.ep_size > 1 and self.ep_size % self.model_procs:
            raise ValueError(f"the mesh's {self.model_axis} dim ({self.model_procs} "
                             f"processes) does not divide ep_size {self.ep_size}")

    @property
    def token_axes(self) -> Tuple[str, ...]:
        """All axes across which flattened tokens are sharded for EP."""
        return tuple(self.data_axes) + (self.model_axis,)

    def _size(self, axes) -> int:
        if self.mesh is None:
            return 1
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        return math.prod(sizes.get(a, 1) for a in axes)

    @property
    def model_procs(self) -> int:
        """Processes on the model axis (1 without a mesh)."""
        return self._size((self.model_axis,))

    @property
    def data_procs(self) -> int:
        """Processes on the data axes (1 without a mesh)."""
        return self._size(self.data_axes)

    @property
    def model_group(self):
        """The model axis's process group (``None`` without a mesh)."""
        return None if self.mesh is None else self.mesh.get_group(self.model_axis)

    @property
    def data_groups(self) -> tuple:
        """The process group of each data axis (none without a mesh): a sum
        over the data axes is a sum over each in turn."""
        if self.mesh is None:
            return ()
        return tuple(self.mesh.get_group(a) for a in self.data_axes)

    @property
    def token_block(self) -> Tuple[int, int]:
        """(index, count): this process's block of the tokens over data x model."""
        if self.mesh is None:
            return 0, 1
        coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        idx = 0
        for a in self.token_axes:
            idx = idx * self._size((a,)) + coord.get(a, 0)
        return idx, self._size(self.token_axes)


def constrain_tokens(x, ctx: "ParallelContext"):
    """The reference pins a [B, S, D] activation's batch dim to the data axes;
    torch propagates no sharding, so there is nothing to pin: ``x`` as it is."""
    return x


SINGLE = ParallelContext()

#: the launchers' ``--dtype`` names
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
