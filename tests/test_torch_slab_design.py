"""The redesigned slot-sharded slab kernels (row 11c) emulated in numpy on
the CPU, on ``chip_smoke.py``'s phase-14 slot maps (numpy only).  The
kernels run on the card only: ``chip_smoke.py`` holds them against their
plain versions bit for bit (``slab_phases``, ``slab_edges``); here the
design's addressing and order are held against the JAX package.

The design: a warp a row, lane l copying words l, l + 32, ... of every
row from a lane map formed once (the word's leaf and column as a byte
base, and the leaf's row stride: 4K bytes for scores / edge / offset, 4
for x, y, t, committed, 1 for the active byte, 0 past the row's end);
blocks of 8 warps, warp b taking row b, its slot read by one lane and
ownership tested once for the warp.  The gather writes
every word of every row exactly once (zeros for a row the rank does not
own); the scatter reads and writes only owned rows.  Held against
``reporter_tpu.ops.viterbi._arena_gather_mesh`` / ``_arena_scatter_mesh``
(jitted under ``shard_map`` on the conftest's virtual CPU devices).

Tolerance: exact (bit patterns; -0.0 and NaN payloads included)."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import chip_smoke as CS
from reporter_tpu.ops.viterbi import TraceCarry as RefCarry
from reporter_tpu.ops.viterbi import _arena_gather_mesh, _arena_scatter_mesh
from reporter_tpu.parallel.rules import shard_map
from reporter_tpu_torch.ops import viterbi as V

WARPS = 8  # a block's warps (csrc/slab_shard.cu kWarps)
LEAVES = V.TraceCarry._fields


def words_a_lane(k):
    return (3 * k + 5 + 31) // 32


def lane_map(k, lane):
    """The kernel's ``lane_map``: for each j < NW, (leaf, byte base, row
    stride in bytes) of word lane + 32 j, or None past the row's end."""
    out = []
    for j in range(words_a_lane(k)):
        w = lane + 32 * j
        if w < 3 * k:
            out.append((LEAVES[w // k], 4 * (w % k), 4 * k))
        elif w < 3 * k + 5:
            leaf = ("x", "y", "t", "active", "committed")[w - 3 * k]
            out.append((leaf, 0, 1 if leaf == "active" else 4))
        else:
            out.append(None)
    return out


def _bytes(shard):
    """{leaf: its flat bytes} (views: writes land in the shard)."""
    return {f: np.asarray(getattr(shard, f)).view(np.uint8).reshape(-1) for f in LEAVES}


def _load(buf, a, stride):
    return int(buf[a]) if stride == 1 else int(buf[a:a + 4].view(np.int32)[0])


def _store(buf, a, stride, v):
    if stride == 1:
        buf[a] = v != 0
    else:
        buf[a:a + 4] = np.array([v], np.int32).view(np.uint8)


def _rows(B):
    """The launch's warps in order, each its row (past B: nothing)."""
    return range(-(-B // WARPS) * WARPS)


def gather_emulated(shard, slots, lo, k):
    """The warp-a-row gather over numpy leaves: [B, 3K + 5] int32, and
    how often each word was written."""
    B, W = len(slots), 3 * k + 5
    s_local = shard.scores.shape[0]
    buf = _bytes(shard)
    out = np.zeros((B, W), np.int32)
    writes = np.zeros((B, W), np.int64)
    maps = [lane_map(k, lane) for lane in range(32)]
    for b in _rows(B):
        if b >= B:
            continue
        loc = int(slots[b]) - lo
        own = 0 <= loc < s_local
        vals = [[0 if m is None or not own else _load(buf[m[0]], m[1] + loc * m[2], m[2])
                 for m in maps[lane]] for lane in range(32)]
        for lane in range(32):  # every load of the row before any store
            for j, x in enumerate(vals[lane]):
                if lane + 32 * j < W:
                    out[b, lane + 32 * j] = x
                    writes[b, lane + 32 * j] += 1
    return out, writes


def scatter_emulated(shard, words, slots, lo, k):
    """The warp-a-row scatter into numpy leaves in place; returns the rows
    of ``words`` it read."""
    B, W = len(slots), 3 * k + 5
    s_local = shard.scores.shape[0]
    buf = _bytes(shard)
    read = set()
    maps = [lane_map(k, lane) for lane in range(32)]
    for b in _rows(B):
        if b >= B:
            continue
        loc = int(slots[b]) - lo
        if not 0 <= loc < s_local:
            continue  # nothing read
        read.add(b)
        vals = [[int(words[b, lane + 32 * j]) if lane + 32 * j < W else 0
                 for j in range(words_a_lane(k))] for lane in range(32)]
        for lane in range(32):
            for j, m in enumerate(maps[lane]):
                if m is not None:
                    _store(buf[m[0]], m[1] + loc * m[2], m[2], vals[lane][j])
    return read


def _np_carry(words, k):
    return V.TraceCarry(*(t.numpy().copy() for t in V.carry_from_words(torch.from_numpy(words),
                                                                         k)))


@pytest.mark.parametrize("k", range(1, 33))
def test_lane_map_copies_every_word_once(k):
    """Every word of a row is copied exactly once, from the leaf and column
    ``carry_words`` puts it in, at the lane map's base + row x stride."""
    W = 3 * k + 5
    assert words_a_lane(k) == -(-W // 32) <= 4
    rng = np.random.default_rng(k)
    raw = rng.integers(-2 ** 31, 2 ** 31, (5, W), dtype=np.int64).astype(np.int32)
    raw[:, 3 * k + 3] &= 1
    carry = _np_carry(raw, k)
    want = V.carry_words(V.TraceCarry(*(torch.from_numpy(t) for t in carry))).numpy()
    assert want.tobytes() == raw.tobytes()
    buf = _bytes(carry)
    seen = np.zeros(W, np.int64)
    for lane in range(32):
        for j, m in enumerate(lane_map(k, lane)):
            w = lane + 32 * j
            assert (m is None) == (w >= W)
            if m is None:
                continue
            seen[w] += 1
            for r in range(5):
                assert _load(buf[m[0]], m[1] + r * m[2], m[2]) == want[r, w]
    assert (seen == 1).all()


@functools.lru_cache(maxsize=None)
def _ref(dp):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:dp]), ("dp",))
    gather = jax.jit(shard_map(lambda s, sl: _arena_gather_mesh(s, sl, "dp"), mesh=mesh,
                               in_specs=(P("dp"), P()), out_specs=P()))
    scatter = jax.jit(shard_map(lambda s, c, sl: _arena_scatter_mesh(s, c, sl, "dp"),
                                mesh=mesh, in_specs=(P("dp"), P("dp"), P()),
                                out_specs=P("dp")))
    return gather, scatter


S, B = 64, 40  # B a multiple of every dp: the reference shards the carry-out rows


@pytest.mark.parametrize("kind", CS.SLAB_MAPS)
@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_warp_rows_equal_reference(dp, kind):
    """The emulated gather (every rank's, summed) and scatter (every rank's
    shard) in the design's order, at K of one, two and four words a lane,
    against the reference under shard_map on the edge phase's slot maps
    and slab words (-0.0 and NaN payloads in every float leaf), exactly."""
    gather, scatter = _ref(dp)
    s_local = S // dp
    slots = CS.slab_edge_slots(S, dp, B, kind, seed=dp)
    for k in (1, 10, 32):
        W = 3 * k + 5
        slab = _np_carry(CS.slab_edge_words(S, k, seed=k), k)
        new = CS.slab_edge_words(B, k, seed=50 + k)
        want_g = gather(RefCarry(*map(jnp.asarray, slab)), jnp.asarray(slots))
        want_s = scatter(RefCarry(*map(jnp.asarray, slab)),
                         RefCarry(*map(jnp.asarray, _np_carry(new, k))), jnp.asarray(slots))
        total = np.zeros((B, W), np.int32)
        shards = []
        for r in range(dp):
            shard = V.TraceCarry(*(t[r * s_local:(r + 1) * s_local].copy() for t in slab))
            g, writes = gather_emulated(shard, slots, r * s_local, k)
            assert (writes == 1).all()
            owned = (slots >= r * s_local) & (slots < (r + 1) * s_local)
            assert not g[~owned].any()
            total += g
            read = scatter_emulated(shard, new, slots, r * s_local, k)
            assert read == set(np.flatnonzero(owned).tolist())
            shards.append(shard)
        for got, want in zip(_np_carry(total, k), want_g):
            assert got.tobytes() == np.asarray(want).tobytes()
        for leaf, want in zip(zip(*shards), want_s):
            assert np.concatenate(leaf).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("kind", CS.SLAB_MAPS)
@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_edge_slot_maps(dp, kind):
    """The edge phase's slot maps: live slots distinct and in [0, S), S the
    padding row, and each map's rows where its name puts them."""
    s_local = S // dp
    for b in CS.SLAB_BS:
        slots = CS.slab_edge_slots(S, dp, b, kind, seed=b)
        assert slots.shape == (b,) and slots.dtype == np.int32
        live = slots[slots < S]
        assert len(np.unique(live)) == len(live) and (live >= 0).all() and (slots <= S).all()
        if kind == "rank 0":
            assert len(live) == min(b, s_local) and (live < s_local).all()
        elif kind == "none owned":
            assert len(live) == min(b, S - s_local) and (live >= s_local).all()
        elif kind == "padding":
            assert len(live) == 0
        elif kind == "shuffled":
            assert len(live) == min(b - b // 8, S)
        else:
            edges = {lo + d for lo in range(0, S, s_local) for d in (-1, 0, s_local - 1, s_local)}
            assert set(live.tolist()) <= edges
            assert len(live) == min(b, len([e for e in edges if 0 <= e < S]))


def test_launch_a_row_a_warp():
    """The launch the emulation mirrors: every K of 1-32 at most four words
    a lane, blocks of the kernel's kWarps warps, a warp a row (the grid's
    last block idle past B)."""
    assert max(words_a_lane(k) for k in range(1, 33)) == 4
    src = (pathlib.Path(V.__file__).parents[1] / "csrc" / "slab_shard.cu").read_text()
    assert "constexpr int kWarps = %d;" % WARPS in src
    for b in CS.SLAB_BS:
        rows = list(_rows(b))
        assert rows[:b] == list(range(b)) and len(rows) - b < WARPS


@pytest.mark.parametrize("name", ["slab_gather_owned", "slab_scatter_owned"])
@pytest.mark.parametrize("k", [0, 33])
def test_slab_launch_rejects_k_outside_1_to_32(name, k):
    """A shard whose K has no kernel instantiation is refused by name
    before any library is loaded."""
    shard = V.initial_carry_batch(4, k, torch.device("cpu"))
    slots = torch.zeros(2, dtype=torch.int32)
    words = torch.zeros((2, 3 * k + 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="%s: k=%d outside 1..32" % (name, k)):
        V._slab_launch(name, shard, slots, 0, words)
