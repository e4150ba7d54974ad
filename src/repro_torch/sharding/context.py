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

:meth:`ParallelContext.row_block` places a global batch's rows over the
mesh for the train step (:class:`RowBlock`), :meth:`ParallelContext.serve_rows`
for serving.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .specs import batch_spec, mesh_coord, mesh_sizes


@dataclasses.dataclass(frozen=True)
class RowBlock:
    """Where this process's rows of a global batch lie: block ``index`` of
    ``count`` distinct blocks, each held by ``replicas`` processes.
    ``split_over_model``: the blocks are split over the model axis too (each
    process's rows its own); otherwise the model group holds the same rows."""

    index: int
    count: int
    replicas: int
    split_over_model: bool

    @property
    def share(self) -> float:
        """A process's share of the global loss: one over the world."""
        return 1.0 / (self.count * self.replicas)


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

    def row_block(self, global_batch: int) -> RowBlock:
        """The train step's placement of ``global_batch`` rows: over data x
        model (:attr:`token_block`) where that divides them, else the
        reference's ``batch_spec`` (``sharding/specs.py``): over the data axes
        that divide them, replicated over the rest, the model axis included."""
        if self.mesh is None:
            return RowBlock(0, 1, 1, True)
        idx, count = self.token_block
        if global_batch % count == 0:
            return RowBlock(idx, count, 1, True)
        return self.serve_rows(global_batch)

    def serve_rows(self, global_batch: int) -> RowBlock:
        """Serving's placement of ``global_batch`` rows, as the reference's
        ``input_specs_sharding`` places a prefill's or a decode step's tokens:
        over the data axes that divide them (``batch_spec``), replicated over
        the rest, the model axis always, so that the model group shares each
        block's products (``sharding/tp.py``)."""
        if self.mesh is None:
            return RowBlock(0, 1, 1, True)
        (entry,) = batch_spec(self.mesh, self.data_axes, global_batch)
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        sizes, coord = mesh_sizes(self.mesh), mesh_coord(self.mesh)
        idx, count = 0, 1
        for a in axes:
            idx, count = idx * sizes[a] + coord[a], count * sizes[a]
        return RowBlock(idx, count, self.mesh.size() // count, False)


def constrain_tokens(x, ctx: "ParallelContext"):
    """The reference pins a [B, S, D] activation's batch dim to the data axes;
    torch propagates no sharding, so there is nothing to pin: ``x`` as it is."""
    return x


SINGLE = ParallelContext()

#: the launchers' ``--dtype`` names
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
