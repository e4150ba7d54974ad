"""Port kernels' plain versions against the JAX package's kernels.

On the CPU each port wrapper runs its kernel's plain version, so these tests
hold that plain version against the reference's ``ref.py`` oracle and its
Pallas kernel in interpret mode, as the reference's own tests run them.
The CUDA kernels themselves are held against the same plain versions on
the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash import flash_attention as j_flash
from repro.kernels.flash_attention.ref import mha_ref as j_mha_ref
from repro.kernels.grouped_ffn import ops as j_ffn_ops
from repro.kernels.grouped_ffn.ffn import grouped_ffn_blocked as j_blocked
from repro.kernels.grouped_ffn.ref import grouped_ffn_ref as j_ffn_ref
from repro.kernels.relay_copy.relay import parity_slot_map as j_parity_slot_map
from repro.kernels.relay_copy.relay import relay_copy as j_relay
from repro.kernels.token_scatter.ops import token_gather as j_gather
from repro.kernels.token_scatter.ref import token_gather_ref as j_gather_ref
from repro_torch.kernels.flash_attention.ops import attention, flash_attention, mha_ref
from repro_torch.kernels.grouped_ffn import ops as t_ffn_ops
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.kernels.relay_copy.ops import SLOT_BYTES as RELAY_SLOT_BYTES
from repro_torch.kernels.relay_copy.ops import WORD_SLOT_BYTES as RELAY_WORD_SLOT_BYTES
from repro_torch.kernels.relay_copy.ops import geometry as relay_geometry
from repro_torch.kernels.relay_copy.ops import parity_slot_map, relay_copy, relay_copy_ref
from repro_torch.kernels.token_scatter.ops import (
    SEG_BYTES,
    THREADS,
    UNROLL,
    geometry,
    token_gather,
)

pytestmark = pytest.mark.torch_port

_DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _both(a: np.ndarray, dt: str):
    """The same values in both frameworks (bf16 rounds alike: nearest even)."""
    tdt, jdt = _DT[dt]
    return torch.as_tensor(a).to(tdt), jnp.asarray(a, dtype=jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --------------------------------------------------------------------------- #
# token_gather
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,m,d", [(64, 100, 32), (16, 16, 128), (128, 7, 8)])
def test_token_gather_matches_reference(n, m, d, dt):
    rng = np.random.default_rng(n + m)
    xt, xj = _both(rng.normal(size=(n, d)).astype(np.float32), dt)
    idx = rng.integers(-1, n, size=(m,)).astype(np.int32)
    idx[::3] = -1                                      # zero rows
    got = token_gather(xt, torch.as_tensor(idx))
    assert got.dtype == xt.dtype
    # a copy: bit-exact against the oracle and the interpret-mode kernel
    np.testing.assert_array_equal(_np(got), _np(j_gather_ref(xj, jnp.asarray(idx))))
    np.testing.assert_array_equal(_np(got), _np(j_gather(xj, jnp.asarray(idx))))


def _copies_of_each_word(g, m):
    """How often the kernel's threads copy each word of each row: its loops
    (csrc/token_gather.cu, gather_rows) run over the launch geometry ``g``."""
    count = np.zeros((m, g.row_words), dtype=np.int64)
    units = THREADS // g.group
    t = np.arange(THREADS)
    unit, lane = t // g.group, t % g.group
    for bx in range(g.grid[0]):
        row = bx * units + unit
        for by in range(g.grid[1]):
            w0 = by * g.seg_words
            w1 = min(w0 + g.seg_words, g.row_words)
            for th in np.flatnonzero(row < m):
                starts = np.arange(w0 + lane[th], w1, g.group * UNROLL)
                w = (starts[:, None] + np.arange(UNROLL)[None, :] * g.group).ravel()
                np.add.at(count[row[th]], w[w < w1], 1)
    return count


# row widths: narrow rows of 2 to 256 bytes (the 64-byte sideband among
# them), 8 KiB FFN rows, widths on both sides of a segment and of two, a
# 128 KiB dispatch chunk and widths that are not a multiple of the segment;
# addresses aligned to 16, 4 or 2 bytes
@pytest.mark.parametrize("row_bytes,m", [
    (2, 300), (4, 300), (6, 40), (8, 70), (12, 33), (16, 300), (24, 65), (32, 129),
    (48, 20), (64, 300), (96, 11), (100, 9), (128, 64), (250, 7), (256, 40),
    (1000, 5), (1024, 17), (4096, 9), (8192, 9), (8194, 3), (SEG_BYTES - 2, 3),
    (SEG_BYTES, 4), (SEG_BYTES + 2, 3), (SEG_BYTES + 16, 5), (2 * SEG_BYTES, 2),
    (3 * SEG_BYTES + 6, 2), (65536 + 24, 2), (131072, 3), (131072 + 48, 2),
    (131072 + 2, 1)])
@pytest.mark.parametrize("align", [0, 4, 2])
def test_token_gather_geometry_covers_every_byte_once(row_bytes, m, align):
    g = geometry(row_bytes, m, align)
    want_word = next(w for w in (16, 4, 2) if row_bytes % w == 0 and align % w == 0)
    assert g.word == want_word and g.row_words * g.word == row_bytes
    assert g.group & (g.group - 1) == 0 and 1 <= g.group <= THREADS
    assert g.seg_words * g.word <= max(SEG_BYTES, g.word)
    assert 1 <= g.grid[1] <= 65535 and g.grid[0] * (THREADS // g.group) >= m
    assert (_copies_of_each_word(g, m) == 1).all()


def test_token_gather_geometry_fills_the_card_at_the_path_shapes():
    # a relay round of 1024 rows of 128 KiB: several segments a row, one
    # batch of 16-byte loads a thread
    g = geometry(131072, 1024, 0)
    assert g.word == 16 and g.grid[1] == 131072 // SEG_BYTES and g.group == THREADS
    assert g.grid[0] * g.grid[1] >= 8 * 132
    # 8704 rows of 8 KiB (the FFN's sort): two rows a block
    g = geometry(8192, 8704, 0)
    assert (g.group, g.grid) == (128, (4352, 1))
    # the sideband's 64-byte rows: four lanes a row, 64 rows a block
    assert geometry(64, 1024, 0)[3:] == (4, (16, 1))
    with pytest.raises(ValueError):
        geometry(7, 4, 0)


# --------------------------------------------------------------------------- #
# grouped FFN
# --------------------------------------------------------------------------- #


def _ffn_inputs(N, D, F, E, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, D)) * 0.5).astype(np.float32)
    eid = rng.integers(-1, E, size=(N,)).astype(np.int32)
    w = [(rng.normal(size=s) * 0.05).astype(np.float32)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, eid, w


@pytest.mark.parametrize("N,E,bt", [(200, 4, 64), (64, 3, 32), (7, 2, 32)])
def test_arrange_equals_reference(N, E, bt):
    _, eid, _ = _ffn_inputs(N, 8, 8, E, seed=N)
    jo, jp, jb, jm = j_ffn_ops._arrange(jnp.asarray(eid), E, bt)
    to, tp, tb, tm = t_ffn_ops._arrange(torch.as_tensor(eid), E, bt)
    assert tm == jm
    for a, b in ((to, jo), (tp, jp), (tb, jb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("N,E", [(200, 4), (100, 2)])
def test_grouped_ffn_matches_reference(N, E):
    # N <= 4 * block_tokens, so the reference takes its blocked Pallas kernel
    # (interpret mode); f32 sums in another order: 1e-5 relative
    D, F, bt = 32, 64, 64
    x, eid, (wg, wu, wd) = _ffn_inputs(N, D, F, E, seed=E)
    want = j_ffn_ops.grouped_ffn(*map(jnp.asarray, (x, eid, wg, wu, wd)),
                                 block_tokens=bt, block_ffn=32)
    got = t_ffn_ops.grouped_ffn(*map(torch.as_tensor, (x, eid, wg, wu, wd)),
                                block_tokens=bt)
    oracle = j_ffn_ref(*map(jnp.asarray, (x, eid, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-6)
    assert (got.numpy()[eid < 0] == 0).all()


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_blocked_plain_matches_pallas_kernel(dt, tol):
    # per-block expert ids, zero blocks past the last segment included;
    # bf16: inputs and output round to bf16 alike, sums differ in order
    D, F, E, bt = 32, 64, 3, 32
    x, _, (wg, wu, wd) = _ffn_inputs(4 * bt, D, F, E, seed=11)
    x[3 * bt:] = 0.0                                   # an all-zero block
    be = np.array([2, 0, 1, 2], np.int32)
    xt, xj = _both(x, dt)
    ws = [_both(w, dt) for w in (wg, wu, wd)]
    want = j_blocked(xj, jnp.asarray(be), *(w[1] for w in ws), block_tokens=bt,
                     block_ffn=32, interpret=True)
    got = t_ffn_ops.grouped_ffn_blocked(xt, torch.as_tensor(be), *(w[0] for w in ws),
                                        block_tokens=bt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 0.1)
    assert (_np(got)[3 * bt:] == 0).all()


@pytest.mark.parametrize("N,E,bt", [(200, 4, 64), (64, 3, 32), (7, 2, 32), (300, 8, 128)])
def test_block_rows_counts_token_rows_of_reference_arrange(N, E, bt):
    # the token rows of each block, read off the reference's own layout: the
    # padded positions of the valid tokens, counted per block
    _, eid, _ = _ffn_inputs(N, 8, 8, E, seed=N + E)
    jo, jp, _, jm = j_ffn_ops._arrange(jnp.asarray(eid), E, bt)
    valid = eid[np.asarray(jo)] >= 0
    want = np.bincount(np.asarray(jp)[valid] // bt, minlength=jm // bt)
    got = t_ffn_ops._block_rows(torch.as_tensor(eid), E, bt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N,E,bt", [(200, 4, 64), (100, 2, 64), (200, 4, 32)])
def test_grouped_ffn_through_block_rows_matches_reference(N, E, bt, monkeypatch):
    # up to 4 x block_tokens rows grouped_ffn hands the blocked kernel its
    # per-block token counts, and still equals the reference (Pallas kernel,
    # interpret mode, and oracle); above that (200 rows in blocks of 32) the
    # CPU takes the reference's scan on both sides and the blocked kernel is
    # not called.  f32 sums in another order: 1e-5 relative
    D, F = 32, 64
    x, eid, (wg, wu, wd) = _ffn_inputs(N, D, F, E, seed=E + bt)
    seen = []
    blocked = t_ffn_ops.grouped_ffn_blocked

    def spy(*args, **kw):
        seen.append(kw["block_rows"])
        return blocked(*args, **kw)

    monkeypatch.setattr(t_ffn_ops, "grouped_ffn_blocked", spy)
    got = t_ffn_ops.grouped_ffn(*map(torch.as_tensor, (x, eid, wg, wu, wd)), block_tokens=bt)
    want = j_ffn_ops.grouped_ffn(*map(jnp.asarray, (x, eid, wg, wu, wd)),
                                 block_tokens=bt, block_ffn=32)
    oracle = j_ffn_ref(*map(jnp.asarray, (x, eid, wg, wu, wd)))
    if N > 4 * bt:
        assert seen == []
    else:
        assert len(seen) == 1 and torch.equal(
            seen[0], t_ffn_ops._block_rows(torch.as_tensor(eid), E, bt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_blocked_plain_block_rows_zeroes_padding(dt, tol):
    # rows at or past a block's count come out exactly 0, whatever x holds
    # there; the rest equal the Pallas kernel (interpret mode) as before
    D, F, E, bt = 32, 64, 3, 32
    x, _, (wg, wu, wd) = _ffn_inputs(4 * bt, D, F, E, seed=12)
    be = np.array([2, 0, 1, 2], np.int32)
    rows = np.array([bt, 5, 0, bt - 1], np.int32)
    xt, xj = _both(x, dt)
    ws = [_both(w, dt) for w in (wg, wu, wd)]
    want = _np(j_blocked(xj, jnp.asarray(be), *(w[1] for w in ws), block_tokens=bt,
                         block_ffn=32, interpret=True))
    got = _np(t_ffn_ops.grouped_ffn_blocked(xt, torch.as_tensor(be), *(w[0] for w in ws),
                                            block_tokens=bt, block_rows=torch.as_tensor(rows)))
    live = np.arange(4 * bt) % bt < np.repeat(rows, bt)
    assert (got[~live] == 0).all()
    np.testing.assert_allclose(got[live], want[live], rtol=tol, atol=tol * 0.1)


def _pairs_case(seed, n_blocks, per):
    rng = np.random.default_rng(seed)
    be = np.sort(rng.integers(0, 4, size=n_blocks)).astype(np.int32)
    bt = 64 * per
    rows = rng.integers(0, bt + 1, size=n_blocks).astype(np.int32)
    rows[rng.random(n_blocks) < 0.3] = bt
    return be, rows, bt


@pytest.mark.parametrize("with_rows", [True, False])
@pytest.mark.parametrize("seed,n_blocks,per", [(0, 9, 1), (1, 24, 1), (2, 7, 2), (3, 16, 2),
                                               (4, 1, 1), (5, 5, 2)])
def test_tile_pairs_cover_each_token_tile_once(seed, n_blocks, per, with_rows):
    # every 64-row tile that holds a token is in exactly one pair, a pair's
    # two tiles are adjacent and of one expert, and the entries past the
    # pairs are -1
    be, rows, bt = _pairs_case(seed, n_blocks, per)
    m = n_blocks * bt
    got = t_ffn_ops._tile_pairs(torch.as_tensor(be), torch.as_tensor(rows) if with_rows
                                else None, bt, m).numpy()
    assert got.shape == (m // 64,) and got.dtype == np.int32
    tile_e = np.repeat(be, per)
    t = np.arange(m // 64)
    tile_rows = np.repeat(rows, per) - (t % per) * 64 if with_rows else np.full(t.shape, 64)
    live = tile_rows > 0
    n = int((got >= 0).sum())
    assert (got[:n] >= 0).all() and (got[n:] == -1).all()
    covered = []
    for code in got[:n]:
        t0, two = code >> 1, code & 1
        covered.append(t0)
        if two:
            covered.append(t0 + 1)
            assert tile_e[t0 + 1] == tile_e[t0]
    assert sorted(covered) == list(t[live])
    assert len(set(covered)) == len(covered)
    # pairs follow each run of adjacent token tiles of one expert from its
    # first tile: a run of L tiles gives L // 2 pairs, then its last tile alone
    want, i = [], 0
    while i < len(t):
        if not live[i]:
            i += 1
            continue
        j = i
        while j + 1 < len(t) and live[j + 1] and tile_e[j + 1] == tile_e[i]:
            j += 1
        want += [2 * a + 1 for a in range(i, j, 2)] + ([2 * j] if (j - i) % 2 == 0 else [])
        i = j + 1
    assert got[:n].tolist() == want


def test_build_digest_covers_every_shared_header(tmp_path, monkeypatch):
    # an edited or added csrc/*.cuh changes every kernel's library name, so a
    # stale library is never loaded
    from repro_torch.kernels import _build

    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build._library_path(name) for name in _build.KERNELS}
    hopper = tmp_path / "hopper.cuh"
    hopper.write_bytes(hopper.read_bytes() + b"\n// edited\n")
    edited = {name: _build._library_path(name) for name in _build.KERNELS}
    assert all(edited[n] != before[n] for n in _build.KERNELS)
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    added = {name: _build._library_path(name) for name in _build.KERNELS}
    assert all(added[n] != edited[n] for n in _build.KERNELS)
    hopper.write_bytes(hopper.read_bytes()[: -len(b"\n// edited\n")])
    (tmp_path / "extra.cuh").unlink()
    assert {name: _build._library_path(name) for name in _build.KERNELS} == before


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #

_FLASH_CASES = {
    "causal": dict(causal=True, window=None, q_offset=0, sq=64, sk=64),
    "window": dict(causal=True, window=24, q_offset=0, sq=64, sk=64),
    "q_offset": dict(causal=True, window=None, q_offset=32, sq=32, sk=64),
    "window_offset": dict(causal=True, window=16, q_offset=32, sq=32, sk=64),
    "noncausal": dict(causal=False, window=None, q_offset=0, sq=64, sk=64),
}


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_attention_matches_reference(case, dt, tol):
    # GQA: 4 query heads over 2 kv heads.  f32: softmax sums in another
    # order, 1e-5; bf16: output rounding, 2e-2 absolute on O(1) values
    c = dict(_FLASH_CASES[case])
    sq, sk = c.pop("sq"), c.pop("sk")
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(1, 4, sq, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, sk, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, sk, 16)).astype(np.float32)
    (qt, qj), (kt, kj), (vt, vj) = _both(q, dt), _both(k, dt), _both(v, dt)
    got = flash_attention(qt, kt, vt, **c)             # CPU: the plain version
    assert got.dtype == qt.dtype
    want = j_flash(qj, kj, vj, bq=32, bk=32, interpret=True, **c)
    oracle = j_mha_ref(qj, kj, vj, **c)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=0)
    np.testing.assert_array_equal(_np(mha_ref(qt, kt, vt, **c)), _np(got))
    np.testing.assert_array_equal(_np(attention(qt, kt, vt, **c)), _np(got))


# --------------------------------------------------------------------------- #
# relay copy
# --------------------------------------------------------------------------- #

_RELAY_DT = {"f32": (torch.float32, np.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
             "i32": (torch.int32, np.int32)}
_SLOT_MAPS = {"parity": lambda n: np.arange(n) % 2, "swapped": lambda n: 1 - np.arange(n) % 2,
              "zeros": lambda n: np.zeros(n)}


@pytest.mark.parametrize("slots", sorted(_SLOT_MAPS))
@pytest.mark.parametrize("dt", sorted(_RELAY_DT))
@pytest.mark.parametrize("n,d,bc", [(1024, 64, 256), (512, 128, 64), (256, 32, 256)])
def test_relay_copy_bit_exact_against_reference(n, d, bc, dt, slots):
    # the reference's grid (tests/test_kernels.py:150-171) under every slot
    # map; a copy is exact
    rng = np.random.default_rng(n + d)
    a = (rng.integers(-100, 100, size=(n, d)) if dt == "i32"
         else rng.normal(size=(n, d))).astype(np.float32)
    tdt, jdt = _RELAY_DT[dt]
    x, xj = torch.as_tensor(a).to(tdt), jnp.asarray(a, dtype=jdt)
    smap = _SLOT_MAPS[slots](n // bc).astype(np.int32)
    got = relay_copy(x, torch.as_tensor(smap), block_chunk=bc)
    want = j_relay(xj, jnp.asarray(smap), block_chunk=bc, interpret=True)
    assert got.dtype == x.dtype and got.data_ptr() != x.data_ptr()
    assert torch.equal(got, x)
    np.testing.assert_array_equal(_np(got) if dt != "i32" else got.numpy(),
                                  _np(want) if dt != "i32" else np.asarray(want))
    np.testing.assert_array_equal(parity_slot_map(n // bc).numpy(),
                                  np.asarray(j_parity_slot_map(n // bc)))


@pytest.mark.parametrize("n_chunks,chunk_bytes,align", [
    (32, 2 << 20, 0), (32, 4 << 20, 0), (1, 1 << 26, 0), (4, 65536, 0), (31, 98320, 0),
    (3, 48, 0), (3, 420, 0), (3, 210, 0), (8, 65536, 4), (8, 65536, 2), (5, 300000, 0)])
@pytest.mark.parametrize("sms", [132, 7])
def test_relay_geometry_covers_every_byte_once(n_chunks, chunk_bytes, align, sms):
    g = relay_geometry(n_chunks, chunk_bytes, align, sms)
    word = next(w for w in (16, 4, 2) if chunk_bytes % w == 0 and align % w == 0)
    assert g.word == word and g.tile_bytes % word == 0
    assert g.tile_bytes <= (RELAY_SLOT_BYTES if word == 16 else RELAY_WORD_SLOT_BYTES)
    assert (g.tiles_per_chunk - 1) * g.tile_bytes < chunk_bytes
    assert g.tiles_per_chunk * g.tile_bytes >= chunk_bytes
    assert 1 <= g.blocks <= n_chunks * g.tiles_per_chunk
    if word == 16:
        assert g.blocks <= sms


def test_relay_geometry_balances_blocks_and_alternates_slots():
    # phase 13's shape: 32 chunks of 2 MiB on 132 SMs; 132 blocks, each
    # within 2% of the average's bytes, and under the parity map at least
    # 0.9 of each block's consecutive tiles (gridDim.x tiles apart, tile s
    # in chunk s // tiles_per_chunk) take different slots, so its next load
    # overlaps its store
    g = relay_geometry(32, 2 << 20, 0, 132)
    assert g.word == 16 and g.blocks == 132
    tiles = 32 * g.tiles_per_chunk
    busiest = -(-tiles // g.blocks) * g.tile_bytes
    assert busiest <= 1.02 * 32 * (2 << 20) / g.blocks
    s = np.arange(tiles)
    flips = [np.diff((s[b::g.blocks] // g.tiles_per_chunk) % 2) != 0 for b in range(g.blocks)]
    assert np.concatenate(flips).mean() >= 0.9


def test_relay_copy_checks_shapes_like_the_reference():
    x = torch.zeros((512, 16))
    assert torch.equal(relay_copy(x), relay_copy_ref(x))      # one chunk of 512
    with pytest.raises(ValueError):                           # 512 rows, chunks of 96
        relay_copy(x, block_chunk=96)
    with pytest.raises(ValueError):                           # 2 chunks, map of 3
        relay_copy(x, torch.zeros(3, dtype=torch.int32), block_chunk=256)
    with pytest.raises(TypeError):
        relay_copy(x.double())


def test_cuda_wrappers_refuse_a_foreign_device():
    # the kernels run only on the card; off it, outside the CPU, they raise
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        token_gather(x, torch.zeros(2, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        relay_copy(x)
    with pytest.raises(ValueError):
        mlstm_scan(*(torch.zeros((1, 1, 4, 8), device="meta") for _ in range(3)),
                   *(torch.zeros((1, 1, 4), device="meta") for _ in range(2)))
