"""Tensor-parallel compute (``sharding/tp.py``) on one process, without a world.

* The NLL from vocab blocks: m blocks of the logits, each block's max, sum
  of exps and target logit (``block_max``, ``block_parts``), put together
  by hand (the max over the blocks, the parts summed) and turned into the
  NLL (``nll_from_parts``), against ``log_softmax`` on the whole logits and
  its gradient.
* The layers on a process's blocks (``models/layers.py``): the heads,
  columns and rows that rank r of m holds, with a ``TensorParallel`` whose
  sum returns its input, summed by hand over the ranks, against the whole
  layer: attention where the KV heads divide, where two ranks share one
  (llama3-8b's 8 over 16), and where a rank's query heads read them
  unevenly; SwiGLU and the GELU MLP (its bias added once).
* Which leaves keep their "model" block under TP use
  (``sharding/gather.py``), at the published widths on model 16, and when
  rows take TP use.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import layers as L
from repro_torch.models.registry import family
from repro_torch.sharding import gather
from repro_torch.sharding.context import RowBlock
from repro_torch.sharding.specs import at_path, build_param_specs, leaf_paths
from repro_torch.sharding.tp import (TensorParallel, block_max, block_parts,
                                     nll_from_parts)

pytestmark = pytest.mark.torch_port


class _Local(TensorParallel):
    """Rank ``rank`` of ``size`` in this one process: its sum is its partial."""

    def sum(self, y):
        return y


def _logits(seed, shape, vocab):
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.normal(size=(*shape, vocab)) * 4, dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, vocab, shape))
    return z, labels


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_vocab_block_nll_equals_log_softmax(m):
    """The blocks' parts summed by hand give ``-log_softmax`` at the target,
    its value within 1e-6 and its gradient within 1e-6 of the largest."""
    z, labels = _logits(m, (3, 5), 64)
    whole = z.clone().requires_grad_(True)
    want = -torch.gather(torch.log_softmax(whole, -1), -1, labels[..., None])[..., 0]
    (gw,) = torch.autograd.grad(want.sum(), whole)
    blocks = [b.clone().requires_grad_(True) for b in z.chunk(m, -1)]
    v = 64 // m
    mx = torch.stack([block_max(b) for b in blocks]).amax(0)
    parts = sum(block_parts(b, labels, r * v, mx) for r, b in enumerate(blocks))
    got = nll_from_parts(parts, mx)
    grads = torch.autograd.grad(got.sum(), blocks)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    assert (torch.cat(grads, -1) - gw).abs().max() <= 1e-6 * gw.abs().max()
    assert not mx.requires_grad


def test_block_parts_take_the_target_only_from_its_block():
    z, labels = _logits(0, (2, 7), 16)
    labels[0, :] = 3
    mx = block_max(z)
    lo, hi = block_parts(z[..., :8], labels, 0, mx), block_parts(z[..., 8:], labels, 8, mx)
    assert torch.equal(hi[1][0], torch.zeros(7))
    assert torch.equal(lo[1][0], z[0, :, 3])
    assert torch.equal((lo + hi)[1], torch.gather(z, -1, labels[..., None])[..., 0])


@pytest.mark.parametrize("heads,kv,m,want", [
    (8, 4, 2, [(0, 2, None), (2, 2, None)]),
    (32, 8, 16, [(r // 2, 1, None) for r in range(16)]),
    (8, 2, 4, [(0, 1, None), (0, 1, None), (1, 1, None), (1, 1, None)]),
    (12, 3, 2, [(0, 2, [0, 0, 0, 0, 1, 1]), (1, 2, [0, 0, 1, 1, 1, 1])]),
])
def test_kv_heads_a_rank_reads(heads, kv, m, want):
    assert [_Local(None, m, r).kv_heads(heads, kv) for r in range(m)] == want


def _attention_params(seed, d, heads, kv, dh, bias):
    g = torch.Generator().manual_seed(seed)
    p = L.init_attention(g, d, heads, kv, dh, torch.float32, "cpu", qkv_bias=bias)
    if bias:
        for k in ("bq", "bk", "bv"):
            p[k] = torch.randn(p[k].shape, generator=g) * 0.1
    return p


def _attention_block(p, r, m, heads, kv, dh):
    """Rank r's blocks: ``wq``/``bq`` columns and ``wo`` rows of its heads;
    ``wk``/``wv``/``bk``/``bv`` its columns where the KV heads divide, else
    whole."""
    q = slice(r * heads // m * dh, (r + 1) * heads // m * dh)
    k = slice(r * kv // m * dh, (r + 1) * kv // m * dh) if kv % m == 0 else slice(None)
    out = {"wq": p["wq"][:, q], "wo": p["wo"][q], "wk": p["wk"][:, k], "wv": p["wv"][:, k]}
    if "bq" in p:
        out.update(bq=p["bq"][q], bk=p["bk"][k], bv=p["bv"][k])
    return out


@pytest.mark.parametrize("heads,kv,m,bias", [(8, 4, 2, True), (8, 4, 4, False),
                                             (8, 2, 4, True), (32, 8, 16, False),
                                             (12, 3, 2, True)])
def test_attention_on_the_ranks_heads_sums_to_the_whole(heads, kv, m, bias):
    """Each rank's query heads and the KV heads they read, RoPE per head,
    ``wo``'s rows of them: the ranks' partial outputs sum to the whole
    attention's output."""
    dh, d = 8, 48
    p = _attention_params(heads * 10 + m, d, heads, kv, dh, bias)
    x = torch.randn(2, 6, d, generator=torch.Generator().manual_seed(1))
    kw = dict(n_heads=heads, n_kv=kv, head_dim=dh, rope_theta=10000.0)
    want = L.attention_forward(p, x, **kw)
    got = sum(L.attention_forward(_attention_block(p, r, m, heads, kv, dh), x,
                                  tp=_Local(None, m, r), **kw) for r in range(m))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("m", [2, 4])
def test_swiglu_and_mlp_on_the_ranks_d_ff_blocks_sum_to_the_whole(m):
    g = torch.Generator().manual_seed(m)
    d, f = 16, 32
    sw = L.init_swiglu(g, d, f, torch.float32, "cpu")
    mp = L.init_mlp(g, d, f, torch.float32, "cpu")
    mp["b1"], mp["b2"] = torch.randn(f, generator=g), torch.randn(d, generator=g)
    x = torch.randn(3, 5, d, generator=g)
    cols = [slice(r * f // m, (r + 1) * f // m) for r in range(m)]
    got = sum(L.swiglu({"wg": sw["wg"][:, c], "wu": sw["wu"][:, c], "wd": sw["wd"][c]}, x,
                       _Local(None, m, r)) for r, c in enumerate(cols))
    want = L.swiglu(sw, x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    zero = torch.zeros(d)
    got = sum(L.mlp({"w1": mp["w1"][:, c], "b1": mp["b1"][c], "w2": mp["w2"][c], "b2": zero},
                    x, _Local(None, m, r)) for r, c in enumerate(cols)) + mp["b2"]
    want = L.mlp(mp, x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _kept(arch, model=16):
    """The leaves ("a/b/c") that keep their "model" block under TP use of
    ``arch`` at its published widths on (data 16, model ``model``)."""
    cfg = get_config(arch)
    shapes_of = family(cfg).param_shapes
    sizes = (("data", 16), ("model", model))
    shapes, full, _ = gather._trees(shapes_of, cfg, sizes)
    use = gather._tp_use(shapes_of, cfg, sizes)
    return {"/".join(map(str, p)) for p, _ in leaf_paths(shapes)
            if "model" in at_path(full, p) and "model" not in at_path(use, p)}


def test_tp_use_keeps_whole_heads_d_ff_and_vocab_blocks():
    """llama3-8b on model 16: 32 query heads split, its 8 KV heads read whole;
    smollm-135m: 9 heads over 3 divide by neither (the attention whole), the
    MLP and the vocab split; whisper's 12 heads stay whole, its MLP splits,
    its tied vocab (51865) does not; granite's 16 query heads split (its 8
    KV heads are read whole), its experts keep their block as always, its
    vocab (49155) does not split; xlstm-125m keeps only ``lm_head``."""
    mlp = {"blocks/mlp/wg", "blocks/mlp/wu", "blocks/mlp/wd"}
    assert _kept("llama3-8b") == {"blocks/attn/wq", "blocks/attn/wo", "lm_head"} | mlp
    assert _kept("llama3-8b", model=4) == {"blocks/attn/wq", "blocks/attn/wo",
                                           "blocks/attn/wk", "blocks/attn/wv",
                                           "lm_head"} | mlp
    assert _kept("smollm-135m") == {"lm_head"} | mlp
    assert _kept("whisper-small") == {f"{s}/mlp/{k}" for s in ("enc", "dec")
                                      for k in ("w1", "b1", "w2")}
    assert _kept("granite-moe-1b-a400m") == {"blocks/attn/wq", "blocks/attn/wo",
                                             "blocks/wg", "blocks/wu", "blocks/wd"}
    assert _kept("xlstm-125m") == {"lm_head"}


def test_rows_take_tp_use_only_replicated_over_a_model_axis():
    shared, split = RowBlock(0, 2, 2, False), RowBlock(0, 4, 1, True)
    assert gather.tp_rows(shared, {"data": 2, "model": 2})
    assert not gather.tp_rows(split, {"data": 2, "model": 2})
    assert not gather.tp_rows(shared, {"data": 2, "model": 1})
    assert not gather.tp_rows(None, {"data": 2, "model": 2})


def test_a_block_under_tp_use_is_the_block_held():
    """TP use changes what is gathered, not what is held: the specs, and so
    each process's blocks, moments and checkpoints, are the full specs."""
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    shapes_of = family(cfg).param_shapes
    sizes = (("data", 16), ("model", 16))
    shapes, full, use = gather._trees(shapes_of, cfg, sizes)
    assert full == build_param_specs(shapes, dict(sizes))
    tp_use = gather._tp_use(shapes_of, cfg, sizes)
    for p, _ in leaf_paths(shapes):
        u, t = at_path(use, p), at_path(tp_use, p)
        assert t == u or t == tuple(None if a == "model" else a for a in u)
