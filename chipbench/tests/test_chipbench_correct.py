"""``correct``, on the CPU at a small size: the port's timed path against
the plain reference (sound runs come out correct), the same path broken
underneath (each fault a cell can have comes out not correct), and the
control, the reference in float8 put in the program's place (not correct
under the cells' limits)."""

import dataclasses
import time

import pytest
import torch

from chipbench import control, harness
from conftest import ROOT, SEED


def run(bench, dirs, kind):
    cell = harness.resolve(bench, f"small.{kind}", dirs=dirs)
    out = cell.kind.run(cell, SEED, 1.0, False, "cpu", time.perf_counter())
    line, checks, err = harness.result(cell, out, False, {"platform": "cpu", "count": 1})
    assert err is None and len(checks) == len(cell.limits)
    return line


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_the_port_agrees_with_the_reference(small, kind, capacity):
    bench, dirs = small("float32", n_layers=2 if kind == "train" else 1, capacity=capacity)
    line = run(bench, dirs, kind)
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "check"
    if kind == "train":
        assert max(c["value"] for c in line["check"].values()) < 1e-5
    else:
        assert line["check"]["gap"]["value"] < 1e-4
        assert line["check"]["moe_gap"]["value"] < 1e-4
        assert line["check"]["drops_out"]["value"] == 0


def _no_update(cfg, params, grads, state, **kw):
    return params, state, {"grad_norm": torch.ones(()), "lr": 0.0}


def _half_loss(orig):
    def loss(self, params, batch, **kw):
        return orig(self, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, **kw)
    return loss


def _one_token_off(orig):
    def loss(self, params, batch, **kw):
        toks = batch["tokens"].clone()
        toks[0, 0] = (toks[0, 0] + 1) % self.cfg.vocab
        return orig(self, params, dict(batch, tokens=toks), **kw)
    return loss


def _served_token_off(orig):
    def forward(self, params, batch, **kw):
        logits, aux = orig(self, params, batch, **kw)
        logits = logits.clone()
        nxt = (logits[0, -1].argmax() + 1) % logits.shape[-1]
        logits[0, -1, nxt] = logits[0, -1].max() + 1e4       # the next id served
        return logits, aux
    return forward


def _half_served(orig):
    def forward(self, params, batch, **kw):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        logits, aux = orig(self, params, half, **kw)
        return torch.cat([logits, logits]), aux
    return forward


def _halved_capacity(orig):
    def program_config(config):
        cfg, par = orig(config)
        return dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_capacity_factor / 2), par
    return program_config


def _plant(monkeypatch, fault):
    from repro_torch.core import dataplane
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    if fault == "state unchanged":
        monkeypatch.setattr(adamw, "update", _no_update)
    elif fault == "half the batch":
        monkeypatch.setattr(registry.Model, "loss", _half_loss(registry.Model.loss))
    elif fault == "no exchange":
        monkeypatch.setattr(dataplane.NimbleAllToAll, "execute", lambda self, x, chunks: x)
    elif fault == "a token altered":
        monkeypatch.setattr(registry.Model, "loss", _one_token_off(registry.Model.loss))
    elif fault == "a served token altered":
        monkeypatch.setattr(registry.Model, "forward", _served_token_off(registry.Model.forward))
    elif fault == "half the batch served":
        monkeypatch.setattr(registry.Model, "forward", _half_served(registry.Model.forward))
    elif fault == "more dropped":
        monkeypatch.setattr(harness, "program_config", _halved_capacity(harness.program_config))


@pytest.mark.parametrize("kind,fault", [
    ("train", "state unchanged"), ("train", "half the batch"), ("train", "no exchange"),
    ("train", "a token altered"), ("prefill", "a served token altered"),
    ("prefill", "half the batch served"), ("prefill", "no exchange"),
    ("prefill", "more dropped")])
def test_a_broken_timed_path_is_not_correct(small, monkeypatch, kind, fault):
    bench, dirs = small("float32")
    _plant(monkeypatch, fault)
    line = run(bench, dirs, kind)
    assert not line["correct"], (fault, line["check"])


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_the_control_and_the_planted_faults_fail_the_cells_limits(small, kind):
    """The reference in float8, and each fault planted in it, at a bfloat16
    configuration: each fails one of the cell's numbers under its limit."""
    bench, dirs = small("bfloat16")
    cell = harness.resolve(bench, f"small.{kind}", dirs=dirs)
    read = control.train_readings if kind == "train" else control.prefill_readings
    for fault, numbers in read(cell, SEED, "cpu").items():
        assert any(numbers[k] > lim for k, lim in cell.limits.items()), (fault, numbers)


def test_no_module_of_jax_is_loaded(tmp_path):
    """A fresh process that loads the harness, both windows, the reference
    and the port's model holds no module whose top-level name is jax,
    jaxlib, flax or repro (repro_torch is not repro)."""
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from chipbench import harness, control, trace, readers\n"
            "from chipbench.kinds import common, train, prefill\n"
            "from chipbench.reference import model, train as t\n"
            "import repro_torch.models.registry, repro_torch.train.step\n"
            "print(harness.forbidden_modules())" % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip() == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("repro_torch_extra"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro.core"]
