"""The redesigned dedup scatter (row 8b's) and probe-outcome counters (row
12) emulated in numpy on the CPU.  The kernels run on the card only:
``chip_smoke.py`` holds them against their plain versions bit for bit
(``scatter_edges``, ``stats_edges``, ``redesign_shapes``); here the
designs' index maps are held against what they must cover, and the
counters' per-lane arithmetic against the JAX package.

The scatter (``csrc/ubodt_dedup.cu``): a persistent grid of 256-thread
blocks (kernel 2's); thread t takes the runs of 4 consecutive keys q = t,
t + threads, ... below n // 4 (one 16-byte slot load, the next run's
slots loaded before this run's reads), then key 4 (n // 4) + t of the
tail.  ``probe_stats`` (``csrc/probe_stats.cu``): a persistent grid of
512-thread blocks over the B (T - 1) steps, each step's b = r / (T - 1)
by fast divmod and p = r + b.  Where K % 4 == 0 (the quad kernel) lane l
takes quad g = l % per (+ 32, 64, ...) of step (warp) rows + l // per,
per = min(K * K / 4, 32) lanes a step: pairs 4g .. 4g + 3, which share i
and have j .. j + 3, and writes their need bytes as one word.  Else (the
row kernel) warp w takes the steps w, w + warps, ...; lane l takes pair
q0 + 32 s + l (s < 4) of each 128 pairs of the step; where K * K % 4 ==
0 it writes the need bytes of pairs q0 + 4l .. q0 + 4l + 3 from the
passes' ballots as one word, else its own bytes.  A lane's (i, j) steps
on in registers.

Tolerance: exact (integer counts, bytes, index maps)."""

import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from reporter_tpu.ops import diagnostics as ref_diag
from reporter_tpu.ops.hashtable import count_distinct_pairs as ref_count_distinct
from reporter_tpu.ops.viterbi import MatchParams as RefParams
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.ops.candidates import hypot_like_jax

CSRC = pathlib.Path(H.__file__).parents[1] / "csrc"
SCATTER_THREADS = 256  # rtt::kProbeThreads
STATS_THREADS = 512  # probe_stats.cu kThreads
M32 = (1 << 32) - 1


def test_launch_constants():
    """The block sizes the emulations below use are the kernels'."""
    assert "constexpr int kProbeThreads = %d;" % SCATTER_THREADS in (
        CSRC / "ubodt.cuh").read_text()
    assert "constexpr int kThreads = %d;" % STATS_THREADS in (
        CSRC / "probe_stats.cu").read_text()


def _grid(units, per_block, resident):
    """A persistent grid's block count: the units' blocks, at most the
    resident ones."""
    return max(1, min(resident, -(-units // per_block)))


def scatter_emulated(slot_of, sidx, c, resident):
    """The scatter's chunk map over numpy arrays: (out, how often each key
    was written).  The grid is sized for the fallback's one key a thread."""
    n = len(slot_of)
    threads = _grid(n, SCATTER_THREADS, resident) * SCATTER_THREADS
    nq = n // 4
    slot4 = slot_of[:4 * nq].reshape(nq, 4)
    out = np.zeros(n, c.dtype)
    writes = np.zeros(n, np.int64)
    for t0 in range(threads):
        so = slot4[t0] if t0 < nq else None  # loaded before the count test
        for q in range(t0, nq, threads):
            nxt = slot4[q + threads] if q + threads < nq else so
            out[4 * q:4 * q + 4] = c[sidx[so]]
            writes[4 * q:4 * q + 4] += 1
            so = nxt
        i = 4 * nq + t0
        if i < n:
            out[i] = c[sidx[slot_of[i]]]
            writes[i] += 1
    return out, writes


@pytest.mark.parametrize("resident", [1, 3, 528])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024, 1025, 4097])
def test_scatter_chunk_map_covers_each_key_once(n, resident):
    """4 keys a thread a pass, a persistent stride and a scalar tail write
    every key exactly once, and the gather through any slot_of / sidx is
    c[sidx[slot_of]]."""
    rng = np.random.default_rng(n + resident)
    nslots, m = 2 * n + 1, max(1, n // 3)
    slot_of = rng.integers(0, nslots, n).astype(np.int32)
    sidx = rng.integers(0, m, nslots).astype(np.int32)
    c = rng.standard_normal(m).astype(np.float32)
    out, writes = scatter_emulated(slot_of, sidx, c, resident)
    assert (writes == 1).all()
    assert out.tobytes() == c[sidx[slot_of]].tobytes()


def umulhi(a, b):
    return (a * b) >> 32


@pytest.mark.parametrize("d", [1, 2, 3, 7, 63, 64, 65, 255, 1000, (1 << 16) + 1, 1 << 30,
                               (1 << 31) - 1])
def test_step_decode_exact_at_the_ends(d):
    """b = r / (T-1) by (umulhi(r, mul) + r) >> shr with the multiplier and
    shift of ``fast_divmod`` (``rtt::step_decode`` on the host) is exact at
    both ends of r's range and around every multiple of d met there, and
    p = r + b is point t of trace b."""
    mul, shr = H.fast_divmod(d)
    l = 0
    while (1 << l) < d:  # step_decode's loop
        l += 1
    assert shr == l and mul == (((1 << (32 + l)) + d - 1) // d) - (1 << 32)
    top = (1 << 31) - 1
    rs = {0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, top, top - 1, top - d,
          top - top % d, top - top % d - 1}
    for r in sorted(x for x in rs if 0 <= x <= top):
        s = umulhi(r, mul) + r
        assert s <= M32  # the 32-bit add does not wrap
        b = s >> shr
        assert b == r // d
        t = r - b * d
        assert r + b == b * (d + 1) + t


def _gaps(px, py):
    with np.errstate(invalid="ignore"):  # inf - inf
        return hypot_like_jax(torch.from_numpy(px[:, 1:] - px[:, :-1]),
                              torch.from_numpy(py[:, 1:] - py[:, :-1])).numpy().reshape(-1)


def _misses(counts, m_row, g, brk, delta):
    """costly and beyond from a step's misses, gc read only then."""
    if m_row:
        counts[1] += m_row
        if np.float32(g) <= np.float32(brk):
            counts[2] += m_row
            if np.float32(g) > np.float32(delta):
                counts[3] += m_row


def stats_quad_emulated(dist, edge, valid, px, py, brk, delta, resident):
    """The quad kernel (K % 4 == 0) over numpy inputs, lane by lane: as
    ``stats_row_emulated``."""
    B, T, K = edge.shape
    assert K % 4 == 0
    KK, steps = K * K, B * max(T - 1, 0)
    quads = KK // 4
    per = min(quads, 32)
    rows = 32 // per
    gc, flat_d, flat_e, vflat = _gaps(px, py), dist.reshape(-1), edge.reshape(-1), valid.reshape(-1)
    need_out = np.full(steps * KK, 255, np.uint8)
    visits = np.zeros(steps * KK, np.int64)
    counts = np.zeros(4, np.int64)
    if steps == 0:
        return counts, need_out, visits
    warps = _grid(steps, STATS_THREADS // 32 * rows, resident) * (STATS_THREADS // 32)
    mul, shr = H.fast_divmod(T - 1)
    di, dj = divmod(128, K)
    for w in range(warps):
        for lane in range(32):
            sub, g0 = divmod(lane, per)
            i0 = 4 * g0 // K
            j0 = 4 * g0 - i0 * K
            for r in range(w * rows + sub, steps, warps * rows):
                p = r + ((umulhi(r, mul) + r) >> shr)
                both = vflat[p] != 0 and vflat[p + 1] != 0
                m_row, i, j = 0, i0, j0
                for g in range(g0, quads, 32):
                    assert (i, j) == divmod(4 * g, K) and j + 4 <= K
                    ea = flat_e[p * K + i]
                    at = r * KK + 4 * g
                    for c in range(4):
                        eb = flat_e[(p + 1) * K + j + c]
                        need = both and ea >= 0 and eb >= 0 and ea != eb
                        counts[0] += need
                        m_row += need and not np.isfinite(flat_d[at + c])
                        need_out[at + c] = need
                        visits[at + c] += 1
                    i, j = i + di, j + dj
                    if j >= K:
                        i, j = i + 1, j - K
                _misses(counts, m_row, gc[r], brk, delta)
    return counts, need_out, visits


def stats_emulated(*args):
    """The kernel the launcher takes for these inputs (16-byte aligned)."""
    return (stats_quad_emulated if args[1].shape[-1] % 4 == 0 else stats_row_emulated)(*args)


def stats_row_emulated(dist, edge, valid, px, py, brk, delta, resident):
    """The row kernel over numpy inputs in the design's order: (counts [4]
    summed from each lane's registers, need bytes (255 where never
    written), how often each pair was visited)."""
    B, T, K = edge.shape
    KK, steps = K * K, B * max(T - 1, 0)
    gc = _gaps(px, py)
    flat_d, flat_e = dist.reshape(-1), edge.reshape(-1)
    vflat = valid.reshape(-1)
    need_out = np.full(steps * KK, 255, np.uint8)
    visits = np.zeros(steps * KK, np.int64)
    counts = np.zeros(4, np.int64)
    if steps == 0:
        return counts, need_out, visits
    warps = _grid(steps, STATS_THREADS // 32, resident) * (STATS_THREADS // 32)
    mul, shr = H.fast_divmod(T - 1)
    lane = np.arange(32)
    i0, j0 = lane // K, lane % K
    di, dj = 32 // K, 32 % K
    for w in range(warps):
        for r in range(w, steps, warps):
            p = r + ((umulhi(r, mul) + r) >> shr)
            ea_l = np.where(lane < K, flat_e[np.minimum(p * K + lane, len(flat_e) - 1)], -1)
            eb_l = np.where(lane < K, flat_e[np.minimum((p + 1) * K + lane, len(flat_e) - 1)],
                            -1)
            both = vflat[p] != 0 and vflat[p + 1] != 0
            row = flat_d[r * KK:(r + 1) * KK]
            m_row = 0
            i, j = i0.copy(), j0.copy()
            for q0 in range(0, KK, 128):
                ball = []
                for s in range(4):
                    q = q0 + 32 * s + lane
                    inn = q < KK
                    assert (i[inn] == q[inn] // K).all() and (j[inn] == q[inn] % K).all()
                    d = np.where(inn, row[np.minimum(q, KK - 1)], 0)
                    ea, eb = ea_l[i & 31], eb_l[j & 31]
                    need = inn & both & (ea >= 0) & (eb >= 0) & (ea != eb)
                    visits[r * KK + q[inn]] += 1
                    counts[0] += need.sum()
                    m_row += (need & ~np.isfinite(d)).sum()
                    ball.append(int((need.astype(np.int64) << lane).sum()))
                    i, j = i + di, j + dj
                    carry = j >= K
                    j, i = np.where(carry, j - K, j), np.where(carry, i + 1, i)
                for ln in range(32):
                    if KK % 4 == 0:
                        q = q0 + 4 * ln
                        if q < KK:
                            bits = (ball[ln >> 3] >> (4 * (ln & 7))) & 0xF
                            word = ((bits * 0x00204081) & 0x01010101) & M32
                            need_out[r * KK + q:r * KK + q + 4] = np.frombuffer(
                                np.uint32(word).tobytes(), np.uint8)
                    else:
                        for s in range(4):
                            q = q0 + 32 * s + ln
                            if q < KK:
                                need_out[r * KK + q] = (ball[s] >> ln) & 1
            _misses(counts, m_row, gc[r], brk, delta)
    return counts, need_out, visits


@pytest.mark.parametrize("T", [2, 3, 65])
@pytest.mark.parametrize("K", range(1, 33))
def test_step_maps_visit_each_pair_once(K, T):
    """Every (b, t, i, j) of the [B, T-1, K, K] grid is visited exactly once
    and every need byte written, on a grid that strides (one resident
    block) and one that does not fill (fewer steps than warps): by the row
    kernel at every K, and by the quad kernel where K % 4 == 0; both give
    the same counts and bytes."""
    for B, resident in ((2, 1), (3, 528)):
        inp = list(CS.stats_edge_inputs(B, T, K, seed=K).values())
        row = stats_row_emulated(*inp, CS.STATS_BRK, CS.STATS_DELTA, resident)
        assert (row[2] == 1).all() and (row[1] != 255).all()
        if K % 4 == 0:
            quad = stats_quad_emulated(*inp, CS.STATS_BRK, CS.STATS_DELTA, resident)
            assert (quad[2] == 1).all() and quad[0].tolist() == row[0].tolist()
            assert quad[1].tobytes() == row[1].tobytes()


def _ref_stats(inp, K):
    """``reporter_tpu.ops.diagnostics.ubodt_probe_stats`` on the given
    candidates and probe results, jitted: its candidate search and probe
    are replaced by the inputs (trace by trace, its vmap unrolled), and its
    need mask is captured where it hands it to ``count_distinct_pairs``.
    Returns (int32 [5], need bool [B, T-1, K, K])."""
    B, T, _ = inp["cand_edge"].shape
    xin = np.stack([inp["px"], inp["py"], np.zeros_like(inp["px"]), inp["valid"]])
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 1000, (8, 2)).astype(np.int32).view(np.float32)
    dg = SimpleNamespace(edge_rows=jnp.asarray(rows))
    p = RefParams(*(jnp.float32(x) for x in (4.07, 3.0, 50.0, CS.STATS_BRK, 5.0, 5.0, 0.0)))

    def run(xin, dist, edge):
        cur, box = {}, []

        def vmap(f):
            def each(*xs):
                outs = []
                for b in range(B):
                    cur["b"] = b
                    outs.append(f(*(x[b] for x in xs)))
                return jax.tree_util.tree_map(lambda *ys: jnp.stack(ys), *outs)
            return each

        def count(a, b, need):
            box.append(need)
            return ref_count_distinct(a, b, need)
        saved = (ref_diag.jax, ref_diag.find_candidates_batch, ref_diag.ubodt_lookup,
                 ref_diag.count_distinct_pairs)
        ref_diag.jax = SimpleNamespace(vmap=vmap, lax=jax.lax)
        ref_diag.find_candidates_batch = lambda *_a: SimpleNamespace(edge=edge[cur["b"]])
        ref_diag.ubodt_lookup = lambda *_a: (dist[cur["b"]], None, None)
        ref_diag.count_distinct_pairs = count
        try:
            out = ref_diag.ubodt_probe_stats(dg, None, xin, p, K, CS.STATS_DELTA)
        finally:
            (ref_diag.jax, ref_diag.find_candidates_batch, ref_diag.ubodt_lookup,
             ref_diag.count_distinct_pairs) = saved
        return out, box[0]
    out, need = jax.jit(run)(jnp.asarray(xin), jnp.asarray(inp["dist"]),
                             jnp.asarray(inp["cand_edge"]))
    return np.asarray(out), np.asarray(need)


@pytest.mark.parametrize("K,T,B", [(1, 2, 3), (3, 9, 4), (4, 9, 3), (8, 17, 4), (8, 2, 1),
                                   (12, 4, 3), (16, 5, 3), (32, 3, 2)])
def test_counts_and_need_equal_reference(K, T, B):
    """The emulated rows' counts and need mask equal the JAX package's
    ``ubodt_probe_stats`` (slots 0-3, and the mask it counts distinct pairs
    over) on the edge phase's inputs: dist +-inf and NaN, same-edge and
    negative candidates, invalid points, gaps exactly at the breakage
    distance and delta."""
    inp = CS.stats_edge_inputs(B, T, K, seed=100 + K)
    want, want_need = _ref_stats(inp, K)
    for emulated in (stats_emulated, stats_row_emulated):
        got, need, _v = emulated(*inp.values(), CS.STATS_BRK, CS.STATS_DELTA, 2)
        assert got.tolist() == want[:4].tolist()
        assert need.tobytes() == want_need.astype(np.uint8).tobytes()
    assert want[0] > 0 and want[1] > 0


def test_edge_inputs_reach_every_case():
    """The edge inputs hold what the tests above must meet: non-finite
    dist of each kind, same-edge and negative candidate pairs, invalid
    points, and gaps exactly at the breakage distance and at delta (both
    leg shapes), NaN and inf."""
    inp = CS.stats_edge_inputs(512, 65, 8, seed=0)
    d = inp["dist"]
    assert np.isposinf(d).any() and np.isneginf(d).any() and np.isnan(d).any()
    e = inp["cand_edge"]
    assert (e[:, :-1, :, None] == e[:, 1:, None, :]).any() and (e == -2).any()
    assert (inp["valid"] == 0).any() and (inp["valid"] == 0.5).any()
    gc = _gaps(inp["px"], inp["py"])
    for x in (CS.STATS_BRK, CS.STATS_DELTA):
        assert (gc == np.float32(x)).sum() >= 2
    assert np.isnan(gc).any() and np.isinf(gc).any()
