"""The port's checkpoints against the JAX package's, and the port's selftest, on the CPU.

Both packages write the same format (``step_%08d/shard_0.npz`` +
``index.json``): a checkpoint written by the reference (float32, int32 and
bfloat16 leaves, an ``OptState``) restores in the port bit for bit, and a
float32 one written by the port restores in the reference (which cannot
read its own bfloat16 leaves back: ``np.load`` gives ``|V2``).  Also
``latest_step``, the launcher's ``--ckpt-dir/--ckpt-every``, the selftest
and the entry points' refusal to run without a card.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import ckpt
from repro_torch.optim import adamw
from repro_torch.tree import leaves

pytestmark = pytest.mark.torch_port


def _bits(t):
    """A leaf's raw bits as numpy (bfloat16 as int16)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


def _j_tree():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    return {
        "params": {"w": jnp.asarray(w), "emb": jnp.asarray(w).astype(jnp.bfloat16),
                   "blocks": [jnp.ones((2,)), jnp.arange(3, dtype=jnp.int32)]},
        "opt": j_adamw.OptState(m={"w": jnp.asarray(w * 0.5)}, v={"w": jnp.asarray(w ** 2)},
                                step=jnp.int32(7)),
    }


def _t_tree():
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32))
    return {
        "params": {"w": w.clone(), "emb": w.to(torch.bfloat16),
                   "blocks": [torch.ones(2), torch.arange(3, dtype=torch.int32)]},
        "opt": adamw.OptState(m={"w": w * 0.5}, v={"w": w ** 2}, step=7),
    }


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    tree = _j_tree()
    j_ckpt.save(str(tmp_path), 3, tree)
    got, step = ckpt.restore(str(tmp_path), namedtuple_types={"OptState": adamw.OptState},
                             device="cpu")
    assert step == 3
    assert isinstance(got["opt"], adamw.OptState)
    assert got["opt"].step == 7 and type(got["opt"].step) is int
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert got["params"]["blocks"][1].dtype == torch.int32
    j_leaves = [x for x in leaves(tree) if not (hasattr(x, "ndim") and x.ndim == 0)]
    t_leaves = [x for x in leaves(got) if not isinstance(x, int)]
    assert len(j_leaves) == len(t_leaves) == 6
    for a, b in zip(t_leaves, j_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _t_tree()
    tree["params"].pop("emb")           # the reference cannot read bfloat16 back
    ckpt.save(str(tmp_path), 11, tree)
    got, step = j_ckpt.restore(str(tmp_path), namedtuple_types={"OptState": j_adamw.OptState})
    assert step == 11
    assert isinstance(got["opt"], j_adamw.OptState)
    assert got["opt"].step.dtype == jnp.int32 and int(got["opt"].step) == 7
    for a, b in zip(leaves(tree["params"]), leaves(got["params"])):
        assert str(np.asarray(b).dtype) == str(a.dtype).replace("torch.", "")
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_writes_the_reference_index_and_keys(tmp_path):
    # the same tree through both packages: the same .npz keys, index keys,
    # meta (shapes, dtypes, shards) and structure; bfloat16 as 2-byte raw
    dj = j_ckpt.save(str(tmp_path / "jax"), 5, _j_tree())
    dt = ckpt.save(str(tmp_path / "port"), 5, _t_tree())
    idx = [json.loads(open(os.path.join(d, "index.json"), "rb").read()) for d in (dj, dt)]
    assert idx[1] == idx[0]
    assert idx[1]["meta"]["params/emb"]["dtype"] == "bfloat16"
    npz = [np.load(os.path.join(d, "shard_0.npz")) for d in (dj, dt)]
    assert sorted(npz[1].files) == sorted(npz[0].files) == sorted(idx[0]["keys"])
    for key in npz[0].files:
        a, b = npz[0][key], npz[1][key]
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes(), key


def test_round_trip_is_bit_exact(tmp_path):
    tree = _t_tree()
    ckpt.save(str(tmp_path), 2, tree)
    got, _ = ckpt.restore(str(tmp_path), namedtuple_types={"OptState": adamw.OptState},
                          device="cpu")
    assert got["opt"].step == 7
    for a, b in zip(leaves(tree), leaves(got)):
        if isinstance(a, int):
            assert a == b
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step(tmp_path):
    # the reference's test_checkpoint_latest, and restore's default step
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    ckpt.save(str(tmp_path), 1, {"x": torch.ones(2)})
    ckpt.save(str(tmp_path), 5, {"x": torch.zeros(2)})
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 5
    assert torch.equal(restored["x"], torch.zeros(2))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), device="cpu")


def test_train_launcher_writes_checkpoints(tmp_path):
    from repro_torch.launch import train

    train.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--dtype", "f32",
                "--steps", "6", "--batch", "2", "--seq", "16", "--log-every", "5",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000005"]
    got, step = ckpt.restore(str(tmp_path), namedtuple_types={"OptState": adamw.OptState},
                             device="cpu")
    assert step == 5 and got["opt"].step == 5
    assert set(got) == {"params", "opt"} and "lm_head" in got["params"]
    # and the reference reads it (float32)
    jgot, _ = j_ckpt.restore(str(tmp_path), namedtuple_types={"OptState": j_adamw.OptState})
    for a, b in zip(leaves(got["params"]), leaves(jgot["params"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_selftest_passes_on_cpu(capsys):
    from repro_torch.launch import selftest

    assert selftest.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for arm in ("dataplane direct: OK", "dataplane stripe: OK", "dataplane nimble: OK",
                "moe_comm direct: OK", "moe_comm nimble: OK", "EP train step:",
                "ALL OK"):
        assert arm in out, arm
    assert "dropped 0, gradients worst leaf" in out


def test_entry_points_refuse_to_run_without_a_card(tmp_path, monkeypatch):
    from repro_torch.launch import selftest, serve, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt.save(str(tmp_path), 1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(str(tmp_path))
    for main, argv in ((train.main, ["--arch", "xlstm-125m", "--reduced"]),
                       (train.main, ["--arch", "smollm-135m", "--reduced"]),
                       (serve.main, ["--arch", "llama3-8b", "--reduced"]),
                       (selftest.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code != 0
