"""The port's stand-alone spawns and its worlds of one, on the CPU.

* ``selftest --procs 8 --device cpu`` ends ``ALL OK``;
* the examples across processes: ``train_moe_nimble`` on 8 and
  ``skewed_alltoallv`` on 4 (bit-exact against the stacked run);
* a failing process is reported by ``spawn``;
* in a world of one (``local_world``): ``shard_batch``'s placement of the
  rows, and the gradient all_reduce's buckets.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch import dist_checks, selftest
from repro_torch.launch.dist import local_world, spawn
from repro_torch.sharding.context import ParallelContext

pytestmark = pytest.mark.torch_port


def test_selftest_procs_8_all_ok(capsys):
    assert selftest.main(["--procs", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for arm in ("dataplane direct (8 processes): OK", "dataplane stripe (8 processes): OK",
                "dataplane nimble (8 processes): OK", "moe_comm direct (8 processes): OK",
                "moe_comm nimble (8 processes): OK", "EP train step (8 processes, mesh data "
                "2 x model 4", "ALL OK"):
        assert arm in out, arm


def test_spawn_reports_a_failing_process():
    with pytest.raises(RuntimeError, match="failed in process [01] of 2"):
        spawn(dist_checks.run_cases, 2, [("x", "exchange", dict(n=3, G=4))], timeout_s=120)


def test_shard_batch_raises_when_the_processes_do_not_split_it():
    """Over data x model where that divides the batch; else over the data
    axes that divide it, replicated over the rest (the model axis with them),
    each process's loss share still one over the world."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding.context import RowBlock
    from repro_torch.train.step import routed_copies, shard_batch

    batch = {"tokens": torch.arange(24).view(8, 3), "labels": torch.arange(24).view(8, 3)}
    with local_world("gloo"):
        ctx = ParallelContext(mesh=make_test_mesh(1, 1), ep_size=1, device="cpu")
        got, rows = shard_batch(batch, ctx)
        assert rows == RowBlock(0, 1, 1, True) and rows.share == 1.0
        assert torch.equal(got["tokens"], batch["tokens"])
    sizes = {"data": 2, "model": 4}
    ctx = ParallelContext(mesh=_FakeMesh(sizes, {"data": 1, "model": 3}), ep_size=4,
                          device="cpu")
    got, rows = shard_batch(batch, ctx)                 # 8 rows over 8 processes
    assert rows == RowBlock(7, 8, 1, True) and rows.share == 1 / 8
    assert torch.equal(got["tokens"], batch["tokens"][7:8])
    assert routed_copies(rows, ctx) == 1
    two = {k: v[:2] for k, v in batch.items()}          # 2 rows: over data only
    got, rows = shard_batch(two, ctx)
    assert rows == RowBlock(1, 2, 4, False) and rows.share == 1 / 8
    assert torch.equal(got["labels"], batch["labels"][1:2])
    assert routed_copies(rows, ctx) == 1               # the model group routes once
    pods = ParallelContext(mesh=_FakeMesh({"pod": 2, "data": 3, "model": 2},
                                          {"pod": 1, "data": 2, "model": 0}),
                           data_axes=("pod", "data"), ep_size=2, device="cpu")
    got, rows = shard_batch(two, pods)                  # pod divides, data does not
    assert rows == RowBlock(1, 2, 6, False) and rows.share == 1 / 12
    assert routed_copies(rows, pods) == 3              # the data replicas repeat it
    with pytest.raises(ValueError, match="holds 3 rows, not 8"):
        shard_batch({"tokens": batch["tokens"], "labels": batch["labels"][:3]}, ctx)


class _FakeMesh:
    """A mesh's names, shape and this process's coordinate, without a group."""

    def __init__(self, sizes, coord):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())
        self._coord = [coord[a] for a in sizes]

    def get_coordinate(self):
        return self._coord

    def size(self):
        return int(np.prod(self.shape))


def test_gradient_all_reduce_packs_buckets_and_copies_back(monkeypatch):
    from repro_torch.train import step

    monkeypatch.setattr(step, "BUCKET_BYTES", 64)
    g = torch.Generator().manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    ts = [torch.randn(n, generator=g).to(dt)
          for n, dt in ((4, f32), (40, f32), (3, bf16), (8, f32), (2, f32), (5, bf16))]
    ts.append(torch.randn(4, 6, generator=g).t())           # strided: through a buffer
    assert [[t.numel() for t in b] for b in step._buckets(ts)] == [
        [4], [40], [8, 2], [24], [3, 5]]
    want = [t.clone() for t in ts]
    with local_world("gloo"):
        step._all_reduce_flat(ts, (None,))                  # a sum over one process
    assert all(torch.equal(a, b) for a, b in zip(ts, want))


def test_train_moe_nimble_example_across_8_processes(capsys):
    from repro_torch.examples import train_moe_nimble

    losses = train_moe_nimble.main(["--device", "cpu", "--steps", "25", "--seq", "32",
                                    "--procs", "8"])
    out = capsys.readouterr().out
    assert "8 processes: the global loss equal on every process" in out
    assert "(improved)" in out and len(losses) == 25


def test_skewed_alltoallv_example_across_4_processes(capsys):
    from repro_torch.examples import skewed_alltoallv

    across = skewed_alltoallv.main(["--device", "cpu", "--procs", "4"])
    stacked = skewed_alltoallv.main(["--device", "cpu"])
    assert across == stacked                 # bit-exact flags and the same projections
    assert capsys.readouterr().out.count("all modes bit-exact vs oracle") == 2
