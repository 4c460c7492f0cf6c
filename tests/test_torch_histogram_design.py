"""The redesigned segment histogram (row 11b) emulated in numpy on the CPU,
and the kernels' ``rtt::hypot_like_jax`` on a NaN leg.  The kernels run on
the card only: ``chip_smoke.py`` holds them against their plain versions
(``histogram_edges``, ``histogram_phases``; the NaN legs in
``stats_edges``, ``build_edges``, ``recursion_edges``, ``assoc_edges`` and
``sweep_edges``); here the design is held against the JAX package.

The histogram (``csrc/segment_histogram.cu``): at T <= 256 a persistent
grid of blocks of 4 warps over groups of rows; a row takes wpr =
ceil(T / 64) warps (4 // wpr rows a group), warp w of the block takes
chunk w % wpr of row w // wpr of its group: points base + l and base +
32 + l in lane l.  Each point forms its segment key (unmatched:
0xffffffff) and the dt and route metres of the step into it where t - 1
(a shuffle, or the warp before's last point) is on the same segment with
no break between; a segmented scan in t order sums each run of one
segment; the run's last point in the chunk adds its point count, time
and metres.  A row's one trace a segment: in one warp (T <= 64) the run
starts that no earlier run start in the warp has, found by
``__match_any_sync`` and shuffles; over several warps the run start whose
insert into the row's hash set finds its slot empty.  Past 256 points a
block takes a row and each point adds its own values.

Tolerance: counts exact; the time and distance sums within rtol 1e-5
(the reference's own bound between its sharded and unsharded
histograms; the emulation sums in the kernel's order, the reference in
its own).  ``hypot_like_jax``: bit for bit, a NaN result as any NaN."""

import pathlib
from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import reporter_tpu.parallel.mesh as ref_mesh
from reporter_tpu.ops.candidates import Candidates as RefCandidates
from reporter_tpu.ops.viterbi import MatchResult as RefResult
from reporter_tpu_torch.ops import histogram as Hg
from reporter_tpu_torch.ops.candidates import hypot_like_jax

CSRC = pathlib.Path(Hg.__file__).parents[1] / "csrc"
WARPS = 4  # segment_histogram.cu kWarps
CHUNK = 64  # kChunk
MAX_T = WARPS * CHUNK  # kMaxT
NONE = np.uint32(0xFFFFFFFF)  # kNone
F32 = np.float32


def test_launch_constants():
    """The constants the emulation below uses are the kernel's."""
    src = (CSRC / "segment_histogram.cu").read_text()
    for line in ("constexpr int kWarps = %d;" % WARPS, "constexpr int kChunk = %d;" % CHUNK,
                 "constexpr int kMaxT = kWarps * kChunk;", "constexpr int kSlots = 2 * kMaxT;",
                 "constexpr uint32_t kNone = 0xffffffffu;",
                 "const int wpr = (T + kChunk - 1) / kChunk;",
                 "const int rpg = kWarps / wpr;", "const int size = kSlots / rpg;"):
        assert line in src, line


# -- the reference's reduction on decoded inputs -------------------------------


def chosen_route(a):
    """[B, T] route metres into each point's chosen slot, +inf where
    unmatched, broken off or at t = 0 (the reference's route_dist)."""
    idx, src = a["choice"]
    B, T = idx.shape
    out = np.full((B, T), np.inf, F32)
    bb, tt = np.nonzero((idx >= 0) & (src >= 0))
    keep = tt > 0
    bb, tt = bb[keep], tt[keep]
    out[bb, tt] = a["route"][bb, tt - 1, src[bb, tt], idx[bb, tt]]
    return out


def reference(a, S, monkeypatch):
    """``reporter_tpu.parallel.mesh.match_and_histogram``'s reduction
    (:85-138) on the decoded inputs ``a``: its match replaced by them."""
    idx = a["choice"][0]
    B, T = idx.shape
    res = RefResult(cand=RefCandidates(jnp.asarray(a["cand_edge"]), None, None, None, None),
                    idx=jnp.asarray(idx), breaks=jnp.asarray(a["breaks"] != 0),
                    route_dist=jnp.asarray(chosen_route(a)), score=None, aux=None)
    monkeypatch.setattr(ref_mesh, "match_batch", lambda *_a: res)
    dg = SimpleNamespace(edge_seg=jnp.asarray(a["edge_seg"]))
    zero = jnp.zeros((B, T), jnp.float32)
    _res, hist = ref_mesh.match_and_histogram(dg, None, zero, zero, jnp.asarray(a["times"]),
                                              None, None, a["cand_edge"].shape[2], S)
    return np.stack([np.asarray(h) for h in hist])


def plain(a, S):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return np.stack([h.numpy() for h in Hg.segment_histogram_plain(
        t["choice"], t["route"], t["cand_edge"], t["breaks"], t["times"], t["edge_seg"], S)])


def same(got, want, what):
    np.testing.assert_array_equal(got[:2], want[:2], err_msg=what + " counts")
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-5, atol=0, err_msg=what + " sums")


# -- the kernel's design, emulated ---------------------------------------------


def lane_map(B, T, resident):
    """{(block, warp, lane): [(b, t), ...]} of the chunked design: the grid's
    min(groups, resident) blocks stride over the groups of 4 // wpr rows;
    warp w takes chunk w % wpr of the group's row w // wpr, lane l its
    points base + l and base + 32 + l below T."""
    wpr = -(-T // CHUNK)
    rpg = WARPS // wpr
    groups = -(-B // rpg)
    blocks = max(1, min(groups, resident))
    out = {}
    for blk in range(blocks):
        for w in range(WARPS):
            local, chunk = divmod(w, wpr)
            for lane in range(32):
                out[blk, w, lane] = [
                    (g * rpg + local, t) for g in range(blk, groups, blocks)
                    for t in (chunk * CHUNK + lane, chunk * CHUNK + 32 + lane)
                    if local < rpg and g * rpg + local < B and t < T]
    return out


def shfl_up(v, d):
    """``__shfl_up_sync`` over [..., 32] lane values: lane l reads l - d,
    lanes below d their own."""
    return np.concatenate([v[..., :d], v[..., :-d]], -1)


def chunk_emulated(a, b, base, S, before):
    """One warp's chunk of 64 points of row b from ``base``: the keys
    [2, 32] (slot r, lane l: t = base + 32 r + l), the tails' adds
    [(segment, count, time, metres)] and the heads' segments in the order
    the lanes make them."""
    idx_a, src_a = a["choice"][0, b], a["choice"][1, b]
    T, K = len(idx_a), a["cand_edge"].shape[2]
    lane = np.arange(32)
    t = base + 32 * np.arange(2)[:, None] + lane  # [2, 32]
    tc = np.minimum(t, T - 1)
    inn, step = t < T, (t < T) & (t > 0)
    idx = np.where(inn, idx_a[tc], -1)
    src = np.where(step, src_a[tc], -1)
    brk = np.where(step, a["breaks"][b, tc], 1)
    t1 = np.where(step, a["times"][b, tc], F32(0))
    t0 = np.where(step, a["times"][b, np.maximum(tc - 1, 0)], F32(0))
    e = np.where(idx >= 0, a["cand_edge"][b, tc, np.clip(idx, 0, K - 1)], -1)
    rd = np.full((2, 32), np.inf, F32)
    if T > 1:
        rd = np.where((idx >= 0) & (src >= 0),
                      a["route"][b, np.maximum(tc - 1, 0), np.maximum(src, 0),
                                 np.maximum(idx, 0)], rd)
    sg = np.where(idx >= 0, a["edge_seg"][np.maximum(e, 0)], -1)
    key = np.where((sg >= 0) & (sg < S), sg, NONE).astype(np.uint32)
    prev = shfl_up(key, 1)
    prev[:, 0] = [before, key[0, 31]]
    same = (key != NONE) & (key == prev) & (brk == 0)
    dt = np.where(same, (t1 - t0).astype(F32), F32(0)).astype(F32)
    dd = np.where(same & np.isfinite(rd), rd, F32(0)).astype(F32)
    cnt = (key != NONE).astype(np.int64)
    head = key != prev
    opened = ~head
    for d in (1, 2, 4, 8, 16):
        uc, ut, ud, uo = (shfl_up(v, d) for v in (cnt, dt, dd, opened))
        upd = (lane >= d) & opened
        cnt = np.where(upd, cnt + uc, cnt)
        dt = np.where(upd, ut + dt, dt).astype(F32)
        dd = np.where(upd, ud + dd, dd).astype(F32)
        opened = np.where(upd, uo, opened)
    cnt[1] += np.where(opened[1], cnt[0, 31], 0)
    dt[1] = np.where(opened[1], dt[0, 31] + dt[1], dt[1]).astype(F32)
    dd[1] = np.where(opened[1], dd[0, 31] + dd[1], dd[1]).astype(F32)
    nxt = np.roll(key, -1, axis=1)
    nxt[:, 31] = [key[1, 0], NONE]  # the chunk's end
    tails, heads = [], []
    for ln in range(32):
        for r in range(2):
            if key[r, ln] == NONE:
                continue
            if nxt[r, ln] != key[r, ln]:
                tails.append((int(key[r, ln]), int(cnt[r, ln]), dt[r, ln], dd[r, ln]))
            if head[r, ln]:
                heads.append(int(key[r, ln]))
    return key, tails, heads, first_in_warp(key, head)


def first_in_warp(key, head):
    """The segments whose trace a row in one warp adds: run starts that
    no run start of a lower lane in their slot (``__match_any_sync``),
    nor for slot 1 any of slot 0's (32 shuffles), has; the other lanes
    hold 0x80000000 | lane and 0x80000020 | lane."""
    lane = np.arange(32, dtype=np.uint32)
    v0 = np.where(head[0] & (key[0] != NONE), key[0], 0x80000000 | lane)
    v1 = np.where(head[1] & (key[1] != NONE), key[1], 0x80000020 | lane)
    out = []
    for ln in range(32):
        if v0[ln] == key[0, ln] and not (v0[:ln] == v0[ln]).any():
            out.append(int(v0[ln]))
        if v1[ln] == key[1, ln] and not (v1[:ln] == v1[ln]).any() and not (v0 == v1[ln]).any():
            out.append(int(v1[ln]))
    return out


def block_emulated(a, b, S):
    """One row of the block branch (T > 256): each point's own adds."""
    idx, src = a["choice"][0, b], a["choice"][1, b]
    T = len(idx)
    e = np.where(idx >= 0, a["cand_edge"][b, np.arange(T), np.maximum(idx, 0)], -1)
    sg = np.where(idx >= 0, a["edge_seg"][np.maximum(e, 0)], -1)
    seg = np.where((sg >= 0) & (sg < S), sg, -1)
    out, seen = [], set()
    for t in range(T):
        if seg[t] < 0:
            continue
        s = int(seg[t])
        first = s not in seen
        seen.add(s)
        dt = dd = F32(0)
        if t > 0 and seg[t - 1] == s and a["breaks"][b, t] == 0:
            dt = F32(a["times"][b, t] - a["times"][b, t - 1])
            if src[t] >= 0:
                r = a["route"][b, t - 1, src[t], idx[t]]
                dd = r if np.isfinite(r) else F32(0)
        out.append((s, 1, dt, dd, first))
    return out


def emulated(a, S):
    """The kernel's [4, S] output over numpy, with (row, segment) -> trace
    adds, the number of global adds made and the number of runs (a run
    cut at a chunk's end counted in each chunk)."""
    _, B, T = a["choice"].shape
    out = np.zeros((4, S), F32)
    traced, n_adds, n_runs = Counter(), 0, 0
    if B == 0 or T == 0:
        return out, traced, n_adds, n_runs
    if T <= MAX_T:
        for b in range(B):
            table, before = set(), NONE
            for base in range(0, T, CHUNK):
                key, tails, heads, firsts = chunk_emulated(a, b, base, S, before)
                if T <= CHUNK:  # one warp: each of firsts adds, no hash set
                    heads, table = firsts, None
                before = key[1, 31]
                for s, c, dt, dd in tails:
                    out[0, s] += F32(c)
                    n_adds, n_runs = n_adds + 1, n_runs + 1
                    for f, v in ((2, dt), (3, dd)):
                        if v != 0:
                            out[f, s] += v
                            n_adds += 1
                for s in heads:  # the insert that finds its slot empty adds the trace
                    if table is None or s not in table:
                        if table is not None:
                            table.add(s)
                        out[1, s] += F32(1)
                        traced[b, s] += 1
                        n_adds += 1
        return out, traced, n_adds, n_runs
    for b in range(B):
        for s, c, dt, dd, first in block_emulated(a, b, S):
            out[0, s] += F32(c)
            out[1, s] += F32(first)
            traced[b, s] += first
            n_adds += 1 + first + (dt != 0) + (dd != 0)
            n_runs += 1
            for f, v in ((2, dt), (3, dd)):
                if v != 0:
                    out[f, s] += v
    return out, traced, n_adds, n_runs


def distinct_pairs(a, S):
    """{(row, segment)} of the matched points on a segment in [0, S)."""
    idx = a["choice"][0]
    e = np.take_along_axis(a["cand_edge"], np.maximum(idx, 0)[..., None], 2)[..., 0]
    sg = np.where(idx >= 0, a["edge_seg"][np.maximum(e, 0)], -1)
    bb, tt = np.nonzero((sg >= 0) & (sg < S))
    return set(zip(bb.tolist(), sg[bb, tt].tolist())), len(bb)


def check_case(a, S, monkeypatch, what):
    want = reference(a, S, monkeypatch)
    got, traced, n_adds, n_runs = emulated(a, S)
    same(got, want, what + " emulated")
    same(plain(a, S), want, what + " plain")
    pairs, n_points = distinct_pairs(a, S)
    assert set(traced) == pairs and all(v == 1 for v in traced.values()), what
    if a["choice"].shape[2] <= MAX_T:  # three adds a run at most, one a (row, segment)
        assert n_adds <= 3 * n_runs + len(pairs) and n_runs <= n_points, what
    return want, n_adds, n_points


# -- cases ---------------------------------------------------------------------


@pytest.mark.parametrize("B", CS.HIST_BS)
@pytest.mark.parametrize("T", CS.HIST_TS)
def test_design_equals_reference(T, B, monkeypatch):
    """Every row kind at once (row b of kind b % 7), K = 4, S = 64: the
    emulated design and the plain version equal the reference's
    reduction; each (row, segment) is added once (PT = 1, 2, 4, 8 and the
    block branch at 257)."""
    a = CS.histogram_edge_inputs(B, T, 4, 64, seed=T * 7 + B)
    want, _n, _p = check_case(a, 64, monkeypatch, "T=%d B=%d" % (T, B))
    if B == 0:
        assert not want.any()


@pytest.mark.parametrize("T", [64, 257])
@pytest.mark.parametrize("kind", CS.HIST_KINDS)
def test_row_kinds(kind, T, monkeypatch):
    """16 rows of one kind: unmatched rows add nothing, a one-segment row
    one trace, re-entering rows one trace a segment, rows broken at every
    step no dwell, +-inf and NaN route entries no metres, segments -1 and
    outside [0, S) nothing."""
    S = 64
    a = CS.histogram_edge_inputs(16, T, 4, S, kind, seed=len(kind) + T)
    want, n_adds, n_points = check_case(a, S, monkeypatch, "%s T=%d" % (kind, T))
    if kind == "unmatched":
        assert not want.any() and n_adds == 0
    if kind == "one segment":
        assert want[1].sum() == 16 and want[0].sum() == n_points
    if kind == "re-entry":
        assert (want[1] <= 16).all() and want[0].sum() > 3 * want[1].sum()
    if kind == "every step broken":
        assert not want[2:].any() and want[0].any()
    if kind == "segment outside":
        assert want[0].sum() < (a["choice"][0] >= 0).sum()


def test_contention(monkeypatch):
    """S = 4: each row's runs land on four bins; a run's adds are fewer than
    its points'."""
    for T in (64, 256):
        a = CS.histogram_edge_inputs(32, T, 8, 4, seed=T)
        want, n_adds, n_points = check_case(a, 4, monkeypatch, "S=4 T=%d" % T)
        assert n_adds < 2 * n_points


def test_edge_inputs_take_every_branch():
    """The edge inputs reach what the card's phase relies on: chosen slots
    of -1, chosen candidate edges of -1 (read as edge 0), segments -1 and
    outside [0, S), +-inf, NaN, 0 and -0.0 route entries, backpointers of
    -1, re-entered segments and breaks."""
    S = 64
    a = CS.histogram_edge_inputs(7 * 8, 64, 4, S, seed=5)
    idx, src = a["choice"]
    e = np.take_along_axis(a["cand_edge"], np.maximum(idx, 0)[..., None], 2)[..., 0]
    chosen = idx >= 0
    assert (~chosen).any() and (chosen & (e == -1)).any() and (src == -1).any()
    sg = a["edge_seg"][np.maximum(e, 0)]
    assert (chosen & (sg == -1)).any() and (chosen & (sg >= S)).any()
    rd = chosen_route(a)
    assert np.isposinf(rd).any() and np.isnan(rd).any() and (rd == 0).any()
    assert (np.signbit(rd) & (rd == 0)).any() and np.isneginf(rd[:, 1:]).any()
    assert a["breaks"].all(1).any() and not a["breaks"].all()
    row = sg[3][chosen[3]]  # a re-entry row: a segment left and entered again
    runs = row[np.r_[True, row[1:] != row[:-1]]]
    assert len(set(runs.tolist())) < len(runs)


@pytest.mark.parametrize("B,resident", [(1, 1), (7, 3), (100, 3), (100, 100)])
def test_lane_map_covers_every_point(B, resident):
    """The persistent grid's blocks, warps and lanes take each (row, point)
    once, whether the rows fill the grid or not, at every warps-a-row
    count."""
    for T in (1, 33, 64, 65, 128, 129, 192, 193, 256):
        seen = Counter(p for pts in lane_map(B, T, resident).values() for p in pts)
        assert set(seen) == {(b, t) for b in range(B) for t in range(T)}
        assert set(seen.values()) == {1}


# -- rtt::hypot_like_jax on a NaN leg and on subnormal legs ------------------

LEGS = {"+0": 0.0, "-0": -0.0, "subnormal": 1e-40, "-subnormal": -3e-42,
        "3e-39": 3e-39, "2^-126": 2.0 ** -126, "2^-125": 2.0 ** -125, "2^-120": 2.0 ** -120,
        "finite": 3.5, "-finite": -1234.5678, "+inf": np.inf, "-inf": -np.inf, "nan": np.nan}
# the classes beside which some other class gives an exact result that
# XLA's flushed arithmetic does not: a leg of 0 or below 2^-126, or a
# normal leg small enough that such a leg still moves the result
SMALL = ("+0", "-0", "subnormal", "-subnormal", "3e-39", "2^-126", "2^-125", "2^-120")
TINY = F32(2.0 ** -126)


def _fma32(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(F32)


def hypot_mirror(u, v, fixed=True, flush=True):
    """``rtt::hypot_like_jax`` (csrc/common.cuh) in numpy float32: legs
    below 2^-126 read as 0 (``flush``; without it the expression before the
    repair); the larger leg, a NaN leg where there is one (``fixed``) or the
    old select's ``a > b`` alone; 0 where it is 0; inf where a leg is inf;
    1 + r r fused."""
    a, b = np.abs(u).astype(F32), np.abs(v).astype(F32)
    if flush:
        a, b = np.where(a < TINY, F32(0), a), np.where(b < TINY, F32(0), b)
    inf = np.isinf(a) | np.isinf(b)
    big = (a > b) | (a != a) if fixed else a > b
    m, n = np.where(big, a, b), np.where(big, b, a)
    safe = np.where(m == 0, F32(1), m)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore", under="ignore"):
        r = (n / safe).astype(F32)
        x = np.where(m == 0, m, (m * np.sqrt(_fma32(r, r, 1.0))).astype(F32))
    return np.where(inf, F32(np.inf), x).astype(F32)


def _same_or_nan(got, want):
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    nan = np.isnan(want)
    return (np.isnan(got) == nan) & ((got.view(np.uint32) == want.view(np.uint32)) | nan)


def test_device_expression_pinned():
    """The mirror below is the helper's expression: legs flushed below
    2^-126, a NaN leg the larger, the result unflushed."""
    src = (CSRC / "common.cuh").read_text()
    assert "constexpr float kMinNormal = 1.17549435082228750797e-38f;" in src
    assert np.float32(1.17549435082228750797e-38) == TINY
    assert "const float a = a0 < kMinNormal ? 0.f : a0;" in src
    assert "const float b = b0 < kMinNormal ? 0.f : b0;" in src
    assert "const bool big = a > b || a != a;" in src
    assert "const float m = big ? a : b;" in src and "const float n = big ? b : a;" in src
    assert "return inf ? INFINITY : x;" in src


@pytest.mark.parametrize("x", list(LEGS))
def test_hypot_nan_leg(x):
    """For an x leg of class ``x`` beside every class of y leg, in both
    orders: the device expression and the port's plain ``hypot_like_jax``
    equal ``jnp.hypot`` as XLA compiles it, bit for bit, on every class:
    XLA's CPU backend flushes a subnormal leg to 0, and so do both (with
    both legs flushed no result is subnormal).  The select before PR 13 gives 0 for an x leg of NaN
    beside a y leg that reads as 0, where ``jnp.hypot`` gives NaN, and
    equals the repaired one everywhere else; the expression before the flush gives
    an exact subnormal or a result moved by a subnormal leg where
    ``jnp.hypot`` does not, and only beside the small classes."""
    ys = np.array(list(LEGS.values()), F32)
    xs = np.full_like(ys, F32(LEGS[x]))
    u, v = np.concatenate([xs, ys]), np.concatenate([ys, xs])
    want = np.asarray(jax.jit(jnp.hypot)(jnp.asarray(u), jnp.asarray(v)))
    new = hypot_mirror(u, v)
    port = hypot_like_jax(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    for got in (new, port):
        assert _same_or_nan(got, want).all()
    old = hypot_mirror(u, v, fixed=False)
    fault = np.isnan(u) & (np.abs(v) < TINY)  # a NaN beside a leg that reads as 0
    assert (old[fault] == 0).all() and np.isnan(want[fault]).all() and np.isnan(new[fault]).all()
    assert _same_or_nan(old[~fault], new[~fault]).all()
    assert fault.any() == (x in ("nan", "+0", "-0", "subnormal", "-subnormal", "3e-39"))
    unflushed = hypot_mirror(u, v, flush=False)
    parted = ~_same_or_nan(unflushed, want)
    sub = lambda w: (w != 0) & (np.abs(w) < TINY)  # noqa: E731
    assert (sub(u) | sub(v))[parted].all()
    assert parted.any() == (x in SMALL)
