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
* The decode step on the ranks' blocks (m threads of this process as the
  model group), the cache split by KV heads, by slots (past the ring's
  wrap) or whole, against the whole step; and the cache's blocks
  (``KVLayout``, ``shard_cache``) against ``build_cache_specs``.
* Which leaves keep their "model" block under TP use
  (``sharding/gather.py``), at the published widths on model 16, and when
  rows take TP use.
* Uneven whole heads: ``TensorParallel.heads`` covers every head once,
  rank 0 the most; attention on the ranks' uneven heads cut from the
  whole leaves sums to the whole, forward and gradients (a rank of no
  head included); the decode over a ``seq`` cache on uneven heads past
  the ring's wrap.
* zamba2's Mamba layer on the ranks' SSM heads (m threads), with and
  without ``gate_norm``'s sum over the group (the latter must differ), and
  its decode on the conv and SSM caches' blocks for 4 steps.
"""

import dataclasses
import threading

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


class _Threads:
    """m threads of this process as a model group: each collective hands its
    tensor in and every thread reads all m of them, in rank order."""

    def __init__(self, m):
        self.barrier, self.slots = threading.Barrier(m), [None] * m

    def exchange(self, rank, t):
        self.slots[rank] = t
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _Thread(TensorParallel):
    """Rank ``rank`` of ``size`` threads sharing ``group`` (a :class:`_Threads`)."""

    def sum(self, y):
        return torch.stack(self.group.exchange(self.rank, y)).sum(0)

    def max(self, t):
        return torch.stack(self.group.exchange(self.rank, t)).amax(0)

    def gather(self, t):
        return torch.stack(self.group.exchange(self.rank, t))


def _cache_block(cache, kv, r):
    """Rank r's block of one layer's whole cache under ``kv`` (``None``: whole)."""
    k, v = cache["k"], cache["v"]
    if kv is not None and kv.kind == "heads":
        h = k.shape[1] // kv.size
        k, v = k[:, r * h:(r + 1) * h], v[:, r * h:(r + 1) * h]
    elif kv is not None:
        k, v = k[:, :, r * kv.slots:(r + 1) * kv.slots], v[:, :, r * kv.slots:(r + 1) * kv.slots]
    return {"k": k.clone(), "v": v.clone(), "slot_pos": cache["slot_pos"].clone()}


@pytest.mark.parametrize("heads,kv,width,m,steps", [
    (8, 4, 16, 2, 6),        # "heads"
    (8, 2, 16, 4, 6),        # 2 KV heads over 4: "seq", two ranks reading one head
    (12, 3, 16, 2, 6),       # "seq", the query heads reading their KV heads unevenly
    (9, 3, 16, 2, 6),        # "seq", 9 heads over 2: 5 and 4, the gather padded
    (12, 3, 9, 2, 6),        # "whole", the query heads split
    (32, 8, 4, 4, 11),       # "seq" of one slot a rank, past the ring's wrap twice
    (9, 3, 4, 4, 11),        # "seq", 3, 2, 2 and 2 heads, past the ring's wrap twice
    (3, 3, 16, 4, 6),        # "seq", one rank of no head
    (6, 3, 9, 4, 6),         # "whole", 2, 1, 2 and 1 heads
])
def test_decode_on_the_ranks_blocks_equals_the_whole(heads, kv, width, m, steps):
    """``attention_decode`` on m ranks (threads exchanging through
    :class:`_Threads`), each on its query heads (``TensorParallel.heads``:
    the weights' blocks where the heads divide, else cut from the whole
    leaves) and its block of the cache (``KVLayout``), at positions
    0 ... steps-1: each step's output within 1e-5 of the whole step's
    largest value on every rank, and each rank's cache the block of the
    whole cache."""
    from repro_torch.sharding.specs import kv_layout

    dh, d, B = 8, 48, 2
    p = _attention_params(heads + width, d, heads, kv, dh, True)
    xs = torch.randn(steps, B, 1, d, generator=torch.Generator().manual_seed(2))
    kw = dict(n_heads=heads, n_kv=kv, head_dim=dh, rope_theta=10000.0)
    whole = L.init_kv_cache(1, B, kv, width, dh, torch.float32, "cpu")
    whole = {k: t[0] for k, t in whole.items()}
    split = heads % m == 0
    group = _Threads(m)
    tps = [_Thread(group, m, r) for r in range(m)]
    lays = [kv_layout(kv, width, m, r, tps[r]) for r in range(m)]
    lays = [None if lay.kind == "whole" else lay for lay in lays]
    caches = [_cache_block(whole, lays[r], r) for r in range(m)]
    blocks = [_attention_block(p, r, m, heads, kv, dh) if split else p for r in range(m)]
    outs = [[None] * steps for _ in range(m)]

    def rank(r):
        for i in range(steps):
            outs[r][i] = L.attention_decode(blocks[r], xs[i], caches[r], i, kv=lays[r],
                                            tp=tps[r], **kw)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(steps):
        want = L.attention_decode(p, xs[i], whole, i, **kw)
        for r in range(m):
            assert (outs[r][i] - want).abs().max() <= 1e-5 * want.abs().max(), (i, r)
    for r in range(m):
        blk = _cache_block(whole, lays[r], r)
        assert torch.equal(caches[r]["slot_pos"], whole["slot_pos"])
        for k in ("k", "v"):
            assert (caches[r][k] - blk[k]).abs().max() <= 1e-6 * whole[k].abs().max()


@pytest.mark.parametrize("n_kv,width,m,kind", [(8, 32, 4, "heads"), (3, 32, 4, "seq"),
                                               (3, 9, 4, "whole")])
def test_kv_layout_and_shard_cache_follow_the_cache_specs(n_kv, width, m, kind):
    """``kv_layout`` takes ``cache_spec_rules``' split of a ``[L, B, Hkv, W,
    dh]`` cache; ``shard_cache`` cuts each process's block of it by
    ``serve_cache_specs`` (the rows over every data axis that divides them,
    "pod" too; ``slot_pos`` whole), the shape that ``KVLayout`` gives, and
    the blocks put back together are the whole cache."""
    from repro_torch.sharding.specs import (build_cache_specs, kv_layout,
                                            serve_cache_specs, shard_cache, unshard)

    sizes = {"pod": 2, "data": 2, "model": m}
    g = torch.Generator().manual_seed(0)
    cache = {"k": torch.randn(2, 8, n_kv, width, 4, generator=g),
             "v": torch.randn(2, 8, n_kv, width, 4, generator=g),
             "slot_pos": torch.arange(2 * width).reshape(2, width)}
    lay = kv_layout(n_kv, width, m)
    assert lay.kind == kind
    rule = build_cache_specs(cache, sizes)["k"]
    assert rule[2:4] == {"heads": ("model", None), "seq": (None, "model"),
                         "whole": (None, None)}[kind]
    specs = serve_cache_specs(cache, sizes, ("pod", "data"))
    assert specs["k"] == (None, ("pod", "data")) + rule[2:] and specs["slot_pos"] == ()
    for coord in ({"pod": 1, "data": 0, "model": m - 1}, {"pod": 0, "data": 1, "model": 0}):
        blk = shard_cache(cache, sizes, ("pod", "data"), coord)
        assert blk["k"].shape == (2, 2, lay.heads(n_kv), lay.slots, 4)
        assert blk["slot_pos"] is cache["slot_pos"]
    for key in ("k", "v"):
        back = unshard(lambda c: shard_cache(cache, sizes, ("pod", "data"), c)[key],
                       specs[key], sizes)
        assert torch.equal(back, cache[key])


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
    vocab (49155) does not split; xlstm-125m keeps ``lm_head``, each mLSTM
    layer's value-column leaves (48 columns of one of its 4 heads a
    process: ``wq``/``wk``/``wi``/``wf`` read whole) and each sLSTM layer's
    channel leaves (``up`` read whole); on model 4, whole heads: the
    mLSTM's head leaves too."""
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
    mlstm = {f"blocks/{i}/{k}" for i in range(0, 12, 2) for k in ("wv", "wg", "gate_norm", "wo")}
    slstm = {f"blocks/{i}/{k}" for i in range(1, 12, 2)
             for k in ("wz", "wi", "wf", "wo_gate", "down")}
    assert _kept("xlstm-125m") == {"lm_head"} | mlstm | slstm
    heads = {f"blocks/{i}/{k}" for i in range(0, 12, 2) for k in ("wq", "wk", "wi", "wf")}
    assert _kept("xlstm-125m", model=4) == {"lm_head"} | mlstm | slstm | heads


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


# -- uneven whole heads and Mamba by SSM heads ----------------------------------


@pytest.mark.parametrize("heads,m", [(9, 2), (9, 4), (40, 16), (12, 16), (3, 4)])
def test_heads_cover_every_head_once_rank_0_the_most(heads, m):
    """``TensorParallel.heads``: contiguous ranges that cover ``[0, H)`` once
    in rank order, counts within one of each other, rank 0 holding
    ``ceil(H / m)``; where ``H < m`` some ranks hold none."""
    got = [_Local(None, m, r).heads(heads) for r in range(m)]
    assert [h for first, n in got for h in range(first, first + n)] == list(range(heads))
    counts = [n for _, n in got]
    assert counts[0] == -(-heads // m) == max(counts) and max(counts) - min(counts) <= 1
    assert (min(counts) == 0) == (heads < m)


@pytest.mark.parametrize("heads,kv,m", [(9, 3, 2), (9, 3, 4), (6, 6, 4), (3, 3, 4)])
def test_attention_on_uneven_heads_sums_to_the_whole(heads, kv, m):
    """Each rank on its heads of ``TensorParallel.heads``, cut out of the
    whole leaves (``layers.local_heads``): the partial outputs sum to the
    whole attention's, and the ranks' gradients of the whole leaves (each
    nonzero only on its heads' share; a rank of no head launches nothing
    and still reaches every leaf) sum to the whole's."""
    dh, d = 8, 48
    p = _attention_params(heads * 10 + m, d, heads, kv, dh, True)
    x = torch.randn(2, 6, d, generator=torch.Generator().manual_seed(1))
    cot = torch.randn(2, 6, d, generator=torch.Generator().manual_seed(2))
    kw = dict(n_heads=heads, n_kv=kv, head_dim=dh, rope_theta=10000.0)

    def run(tp):
        live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y = L.attention_forward(live, x, tp=tp, **kw)
        grads = torch.autograd.grad((y * cot).sum(), [live[k] for k in sorted(live)])
        return y.detach(), grads

    want, gw = run(None)
    outs = [run(_Local(None, m, r)) for r in range(m)]
    got = sum(y for y, _ in outs)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    for i, w in enumerate(gw):
        g = sum(o[1][i] for o in outs)
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), sorted(p)[i]


def _mamba_cfg(heads=4):
    return dataclasses.replace(get_config("zamba2-1.2b").reduced(), ssm_heads=heads)


def _mamba_params(cfg, seed=0):
    """A whole Mamba layer with every leaf random (norms, biases, decays)."""
    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(seed)
    p = ssm.init_mamba_block(g, cfg, torch.float32, "cpu")
    for k in ("norm", "gate_norm", "conv_b", "D", "dt_bias"):
        p[k] = p[k] + 0.3 * torch.randn(p[k].shape, generator=g)
    return p


def _mamba_block(p, cfg, r, m):
    """Rank r's blocks: the "model" blocks of ``conv_w``, ``conv_b``,
    ``gate_norm`` and ``out_proj`` (its heads' channels); the rest whole."""
    from repro_torch.models.ssm import _dims

    d_inner = _dims(cfg)[0]
    c = slice(r * d_inner // m, (r + 1) * d_inner // m)
    return dict(p, conv_w=p["conv_w"][:, c], conv_b=p["conv_b"][c],
                gate_norm=p["gate_norm"][c], out_proj=p["out_proj"][c])


class _NoNormSum(_Thread):
    """:class:`_Thread` that leaves ``gate_norm``'s sum of squares ([B, S, 1])
    unsummed: the norm then scales by each rank's own channels."""

    def sum(self, y):
        return y if y.shape[-1] == 1 else super().sum(y)


def _on_threads(m, fn):
    outs = [None] * m
    threads = [threading.Thread(target=lambda r=r: outs.__setitem__(r, fn(r)))
               for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


@pytest.mark.parametrize("m", [2, 4])
def test_mamba_on_the_ranks_ssm_heads_equals_the_whole(m):
    """``mamba_forward`` on m ranks (threads), each on its SSM heads: its
    blocks of the channel leaves, its columns of the whole ``in_proj``'s
    five groups, its heads of ``A_log``/``D``/``dt_bias``; ``gate_norm``'s
    sum of squares and the ``out_proj`` output summed over the group.
    Every rank's output is the whole layer's within 1e-5; without the
    norm's group sum it is not."""
    from repro_torch.models import ssm

    cfg = _mamba_cfg()
    p = _mamba_params(cfg, m)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(3))
    want = ssm.mamba_forward(p, x, cfg)
    for kind, close in ((_Thread, True), (_NoNormSum, False)):
        group = _Threads(m)
        outs = _on_threads(m, lambda r: ssm.mamba_forward(
            _mamba_block(p, cfg, r, m), x, cfg, kind(group, m, r)))
        for y in outs:
            err = (y - want).abs().max() / want.abs().max()
            assert (err <= 1e-5) == close, (kind.__name__, float(err))


@pytest.mark.parametrize("m", [2, 4])
def test_mamba_decode_on_the_cache_blocks_equals_the_whole(m):
    """``mamba_decode`` on m ranks, each on its SSM heads against its blocks
    of the conv and SSM caches (``init_mamba_cache(tp=)``: its channels, its
    heads), for 4 steps: each step's output within 1e-5 of the whole step's
    largest value on every rank, and each rank's caches the blocks of the
    whole caches."""
    from repro_torch.models import ssm

    cfg = _mamba_cfg()
    p = _mamba_params(cfg, 7)
    steps = 4
    xs = torch.randn(steps, 2, 1, cfg.d_model, generator=torch.Generator().manual_seed(4))
    whole = ssm.init_mamba_cache(cfg, 2, torch.float32, "cpu")
    want = []
    for i in range(steps):
        y, whole = ssm.mamba_decode(p, xs[i], whole, cfg)
        want.append(y)
    group = _Threads(m)

    def rank(r):
        tp = _Thread(group, m, r)
        cache, ys = ssm.init_mamba_cache(cfg, 2, torch.float32, "cpu", tp=tp), []
        for i in range(steps):
            y, cache = ssm.mamba_decode(_mamba_block(p, cfg, r, m), xs[i], cache, cfg, tp)
            ys.append(y)
        return ys, cache

    d_inner, H = whole["conv"].shape[-1], whole["ssm"].shape[1]
    for r, (ys, cache) in enumerate(_on_threads(m, rank)):
        for y, w in zip(ys, want):
            assert (y - w).abs().max() <= 1e-5 * w.abs().max()
        c, h = slice(r * d_inner // m, (r + 1) * d_inner // m), slice(r * H // m, (r + 1) * H // m)
        assert torch.allclose(cache["conv"], whole["conv"][..., c], rtol=0, atol=1e-6)
        assert torch.allclose(cache["ssm"], whole["ssm"][:, h], rtol=1e-5, atol=1e-6)
