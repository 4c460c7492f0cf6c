"""The redesigned candidate sweep (kernel 1) and transition build (kernel
3, dense and sparse) on the CPU.  Their plain versions against the JAX
package's jitted reference on the inputs that take the new designs'
branches (``chip_smoke.py``'s phase-12 input makers, numpy only), and the
host half of the designs: the sweep's warp selection emulated in numpy
(the bitonic sort of (distance bits, flat index) keys, the chunked merge,
the dedup and the slots by ballot counts) against a stable sort, the
transition build's angle difference (fmodf only outside [-2 pi, 4 pi))
against ``jnp.mod``, and its step decode.  The kernels themselves run on
the card only: ``chip_smoke.py`` holds them against these plain versions
bit for bit (phase 12).

Tolerance: every output exact, bit for bit (edge and node ids, offset,
dist, cx, cy and the emission; logp, route and gc)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.ops import viterbi as RV
from reporter_tpu.ops.candidates import Candidates as RefCandidates
from reporter_tpu.ops.candidates import find_candidates_batch as ref_find
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu_torch import convert
from reporter_tpu_torch.matching import MatcherConfig
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.ops import viterbi as V
from reporter_tpu_torch.ops.candidates import BIG, NEG_INF, Candidates, candidate_sweep_plain
from test_torch_sparse import FAMILY

RADIUS, SIGMA = 50.0, 4.07

_ref_find = jax.jit(ref_find, static_argnums=(3,))


@jax.jit
def _ref_emission(dist, valid, sigma):
    """The reference's emission (``precompute_batch``, stage "emission");
    sigma is traced there, as here (XLA turns a division by a constant
    into a product with its reciprocal)."""
    emis = -0.5 * jnp.square(dist / sigma)
    emis = jnp.where(jnp.isfinite(dist), emis, RV.NEG_INF)
    return jnp.where(valid[..., None], emis, RV.NEG_INF)


def _ref_build(edge_rows, edge, offset, px, py, times, sp_dist, sp_time, p, sp=None):
    """The reference's transition build as ``precompute_batch`` runs it
    (gc, dt, the hoisted edge rows, ``transition_matrix`` vmapped over
    steps and traces with ``pre``), on given candidates and probe
    results."""
    cand = RefCandidates(edge, offset, offset, offset, offset)  # dist, cx, cy unread
    gc = jnp.hypot(px[:, 1:] - px[:, :-1], py[:, 1:] - py[:, :-1])
    dts = times[:, 1:] - times[:, :-1]
    er = edge_rows[jnp.where(edge >= 0, edge, 0)]
    src = jax.tree_util.tree_map(lambda a: a[:, :-1], cand)
    dst = jax.tree_util.tree_map(lambda a: a[:, 1:], cand)
    axes = (None, None, 0, 0, 0, 0, None, 0) + ((None,) if sp is not None else ())
    tm = jax.vmap(jax.vmap(RV.transition_matrix, in_axes=axes), in_axes=axes)
    extra = (sp,) if sp is not None else ()
    logp, route = tm(None, None, src, dst, gc, dts, p, (er[:, :-1], er[:, 1:], sp_dist, sp_time),
                     *extra)
    return logp, route, gc


_ref_build_jit = jax.jit(_ref_build)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _same_bits(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(_bits(got), _bits(want)), what


_GRAPHS = {}


def graph(cap):
    """(reference GraphArrays, the port's DeviceGraph) of an 8 x 8 grid city
    of 150 m blocks whose cells hold ``cap`` items: 100 m cells cut to 2
    (``bucket_cap=2``), 100 m (8), 200 m (24) and 450 m (56)."""
    if cap not in _GRAPHS:
        cell, bc = {2: (100.0, 2), 8: (100.0, None), 24: (200.0, None), 56: (450.0, None)}[cap]
        ra = ref_build_graph_arrays(ref_grid_city(8, 8, 150.0), cell_size=cell, bucket_cap=bc)
        dg = convert.graph_from_numpy(ra._edge_rows(), ra._cell_rows(), [ra.grid_x0, ra.grid_y0],
                                      [ra.grid_nx, ra.grid_ny], ra.cell_size)
        assert dg.cap == cap
        _GRAPHS[cap] = ra, dg
    return _GRAPHS[cap]


def sweep_both(cap, k, B=4, T=256):
    """The plain sweep and the reference (candidates and emission) on
    ``CS.sweep_edge_points`` of the cap's city; also the points' kinds."""
    ra, dg = graph(cap)
    px, py, valid, kind = CS.sweep_edge_points(ra, B, T, seed=cap)
    got = candidate_sweep_plain(dg, torch.from_numpy(px), torch.from_numpy(py),
                                torch.from_numpy(valid), k, RADIUS, SIGMA)
    ref = _ref_find(ra.to_device(), jnp.asarray(px), jnp.asarray(py), k, jnp.float32(RADIUS))
    emis = _ref_emission(ref.dist, jnp.asarray(valid != 0), jnp.float32(SIGMA))
    return ra, got, ref, np.asarray(emis), (px, valid, kind)


@pytest.mark.parametrize("k", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("cap", [2, 8, 24, 56])
def test_sweep_plain_equals_reference(cap, k):
    """Every output of the plain sweep equals the reference bit for bit at
    every cap class of the redesign (4 cap < K: pads; 4 cap <= 32: one
    warp sort; 4 cap > 32: the chunked merge, with m > 32 at K > 8)."""
    ra, got, ref, emis, _pts = sweep_both(cap, k)
    for f in ("edge", "offset", "dist", "cx", "cy"):
        _same_bits(getattr(got.cand, f).numpy(), getattr(ref, f), "cap %d K=%d %s" % (cap, k, f))
    _same_bits(got.emis.numpy(), emis, "emission")
    e = np.maximum(np.asarray(ref.edge), 0)
    assert np.array_equal(got.to_node.numpy(), ra.edge_to[e].astype(np.int32))
    assert np.array_equal(got.from_node.numpy(), ra.edge_from[e].astype(np.int32))


@pytest.mark.parametrize("cap", [2, 8, 24, 56])
def test_sweep_edge_points_take_every_branch(cap):
    """The edge points do what the card's phase relies on: block centres
    and points past the grid miss every item, nodes tie (cap >= 8), the
    border points clamp to the edge cells, invalid points emit NEG_INF
    only, and at cap 2 a 16-beam pads its last 8 slots."""
    ra, got, _ref, _emis, (px, valid, kind) = sweep_both(cap, 16)
    edge, dist = got.cand.edge.numpy(), got.cand.dist.numpy()
    kinds = {name: kind == i for i, name in enumerate(CS.SWEEP_KINDS)}
    assert all(m.any() for m in kinds.values())
    assert (edge[kinds["block centre"]] == -1).all()
    fx = (px - np.float32(ra.grid_x0)) / np.float32(ra.cell_size)
    assert ((fx < 0) | (fx >= ra.grid_nx))[kinds["border"]].any()
    if cap >= 8:
        tie = (edge[..., 1] >= 0) & (dist[..., 0] == dist[..., 1])
        assert tie[kinds["node"]].mean() > 0.5
    assert (got.emis.numpy()[valid == 0] == np.float32(NEG_INF)).all()
    assert ((edge >= 0) & (valid[..., None] != 0)).any()
    if cap == 2:
        assert (edge[..., 8:] == -1).all() and (got.cand.offset.numpy()[..., 8:] == 0).all()
        assert np.isinf(dist[..., 8:]).all()


# -- the sweep's warp selection, emulated: lanes on the last axis ----------

NO_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _warp_sort(keys, n):
    """The kernel's ``warp_sort``: the bitonic network over blocks of n
    lanes by ``__shfl_xor_sync``, on [P, 32] uint64 keys."""
    lane = np.arange(32)
    k = 2
    while k <= n:
        j = k >> 1
        while j:
            other = keys[:, lane ^ j]
            keep_min = ((lane & j) == 0) == ((lane & k) == 0)
            keys = np.where(keep_min == (other < keys), other, keys)
            j >>= 1
        k <<= 1
    return keys


def _warp_pool(keys, m):
    """The kernel's pool of the m smallest of [P, n] keys (item q's key in
    column q): one warp sort where n <= 32, else the chunked merge, each
    key's place its rank in its own sorted sequence plus its count of
    smaller keys in the other."""
    P, n = keys.shape
    lane = np.arange(32)

    def chunk(base):
        c = np.full((P, 32), NO_KEY)
        c[:, :min(32, n - base)] = keys[:, base:base + 32]
        return c
    if n <= 32:
        return _warp_sort(chunk(0), 1 << max(1, (n - 1).bit_length()))[:, :m]
    pool = np.zeros((P, 0), np.uint64)
    for base in range(0, n, 32):
        c = _warp_sort(chunk(base), 32)
        nvalid, psize = min(32, n - base), pool.shape[1]
        nxt = min(psize + nvalid, m)
        at_c = lane + (pool[:, None, :] < c[:, :, None]).sum(-1)
        at_p = np.arange(psize) + (c[:, None, :] < pool[:, :, None]).sum(-1)
        out = np.full((P, nxt), NO_KEY)
        for at, src, ok in ((at_c, c, (at_c < nxt) & (lane < nvalid)), (at_p, pool, at_p < nxt)):
            r, i = np.nonzero(ok)
            out[r, at[r, i]] = src[r, i]
        assert (out != NO_KEY).all()
        pool = out
    return pool


def _warp_slots(pool, item_edge, k):
    """The kernel's dedup and slots: pool entry i is kept when live and no
    earlier entry holds its edge (``__match_any_sync`` within its row of
    32, the staged edges of the earlier rows); a kept entry's slot counts
    the kept entries before it, any other entry's follows all kept ones.
    Returns [P, kk] (flat index, kept) of slots 0 .. kk-1."""
    P, m = pool.shape
    d = (pool >> np.uint64(32)).astype(np.uint32).view(np.float32)
    q = (pool & np.uint64(0xFFFFFFFF)).astype(np.int64)
    live = d < np.float32(BIG / 2)
    e = np.where(live, np.take_along_axis(item_edge, q, 1), -1)
    i = np.arange(m)
    row_lane = (i[:, None] // 32 == i[None, :] // 32)
    earlier = i[None, :] < i[:, None]
    same = (e[:, :, None] == e[:, None, :]) & (e[:, None, :] >= 0)
    in_row = (same & earlier & row_lane).any(-1)  # the match's lower lanes
    before = (same & earlier & ~row_lane).any(-1)  # the earlier rows' scan
    kept = live & ~in_row & ~before
    n_kept = kept.sum(1, keepdims=True)
    slot = np.where(kept, np.cumsum(kept, 1) - kept, n_kept + np.cumsum(~kept, 1) - ~kept)
    kk = min(k, m)
    out_q = np.zeros((P, kk), np.int64)
    out_kept = np.zeros((P, kk), bool)
    r, c = np.nonzero(slot < kk)
    out_q[r, slot[r, c]] = q[r, c]
    out_kept[r, slot[r, c]] = kept[r, c]
    return out_q, out_kept


@pytest.mark.parametrize("k", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("n_items", [8, 32, 96, 120, 224])
def test_warp_selection_equals_stable_sort(n_items, k):
    """The emulated warp selection equals the reference's rule on items
    with many ties, misses (kBig) and repeated edges: the pool is the
    first m of a stable sort by distance, and the slots are a second
    stable sort with later duplicates of an edge pushed to kBig.  The
    uint64 key (float bits << 32 | index) orders as (distance, index)
    because a distance is +0.0 or more (never -0.0 or NaN) or kBig."""
    rng = np.random.default_rng(n_items * 100 + k)
    P = 2048
    d = rng.choice(np.float32([0.0, 0.5, 1.0, 3.25, 7.0, 12.5, 49.9, 50.0]), (P, n_items))
    d = np.where(rng.uniform(size=d.shape) < 0.3, np.float32(BIG), d).astype(np.float32)
    d[:8] = np.float32(BIG)  # points with every item missing
    edge = rng.integers(0, max(2, n_items // 3), (P, n_items))
    q = np.arange(n_items, dtype=np.uint64)
    keys = (d.view(np.uint32).astype(np.uint64) << np.uint64(32)) | q
    m = min(4 * k, n_items)
    pool = _warp_pool(keys, m)
    order = np.argsort(d, 1, kind="stable")[:, :m]
    assert np.array_equal((pool & np.uint64(0xFFFFFFFF)).astype(np.int64), order)
    got_q, got_kept = _warp_slots(pool, edge, k)
    # the plain version's rule (ops/candidates.py candidate_sweep_plain)
    pd = np.take_along_axis(d, order, 1)
    pe = np.where(pd < BIG / 2, np.take_along_axis(edge, order, 1), -1)
    dup = ((pe[:, None, :] == pe[:, :, None]) & (pe[:, None, :] >= 0)
           & np.triu(np.ones((m, m), bool), 1)).any(1)
    pd = np.where(dup, np.float32(BIG), pd)
    sel = np.argsort(pd, 1, kind="stable")[:, :min(k, m)]
    assert np.array_equal(got_q, np.take_along_axis(order, sel, 1))
    assert np.array_equal(got_kept, np.take_along_axis(pd, sel, 1) < BIG / 2)


# -- the transition build ----------------------------------------------------

def _params():
    return (RV.MatchParams.from_config(RefConfig()), V.MatchParams.from_config(MatcherConfig()))


def build_both(K, sparse, B=16, T=16):
    """The plain transition build and the reference on
    ``CS.build_edge_inputs``."""
    rp, pp = _params()
    back_tol = 2.0 * float(pp.sigma_z) + 5.0
    a = CS.build_edge_inputs(B, T, K, back_tol, seed=K + (100 if sparse else 0))
    rsp = RV.SparseParams.from_values(*FAMILY) if sparse else None
    psp = V.SparseParams.from_values(*FAMILY) if sparse else None
    want = _ref_build_jit(*(jnp.asarray(a[n]) for n in (
        "edge_rows", "edge", "offset", "px", "py", "times", "sp_dist", "sp_time")), rp, rsp)
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    dg = type("Graph", (), {"edge_rows": t["edge_rows"]})
    got = V.transition_build_plain(dg, Candidates(t["edge"], t["offset"], None, None, None),
                                   t["px"], t["py"], t["times"], t["sp_dist"], t["sp_time"], pp,
                                   sp=psp)
    return a, got, want, back_tol


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("K", [1, 2, 4, 8, 16, 32])
def test_transition_build_plain_equals_reference(K, sparse):
    """logp, route and gc of the plain build equal the reference bit for
    bit on the edge inputs, dense and sparse, at every K the kernel is
    templated on."""
    _a, got, want, _tol = build_both(K, sparse)
    for name, g, w in zip(("logp", "route", "gc"), got, want):
        _same_bits(g.numpy(), w, "K=%d sparse=%s %s" % (K, sparse, name))


@pytest.mark.parametrize("K", [1, 8, 32])
def test_build_edge_inputs_take_every_branch(K):
    """The edge inputs reach every rule of the transition: same-edge
    forward, jitter within and exactly at the back tolerance and loops,
    empty slots on either side, dt <= 0 and > 0, repeated points (gc 0),
    probe results 0 and +inf, headings at +-pi and outside [-pi, pi], and
    both feasible and infeasible pairs."""
    a, got, _want, back_tol = build_both(K, False)
    ea, eb = a["edge"][:, :-1, :, None], a["edge"][:, 1:, None, :]
    delta = a["offset"][:, 1:, None, :] - a["offset"][:, :-1, :, None]
    same = (ea == eb) & (ea >= 0)
    tol = np.float32(back_tol)
    assert (same & (delta >= 0)).any() and (same & (delta < 0) & (-delta < tol)).any()
    assert (same & (-delta == tol)).any() and (same & (-delta > tol)).any()
    assert (ea == -1).any() and (eb == -1).any()
    dt = np.diff(a["times"], axis=1)
    assert (dt <= 0).any() and (dt > 0).any()
    assert (np.diff(a["px"], axis=1) == 0).any()
    assert np.isinf(a["sp_dist"]).any() and (a["sp_dist"] == 0).any()
    heads = a["edge_rows"][:, 4:6]
    assert (np.abs(heads) == np.float32(CS.PI32)).any() and (np.abs(heads) > 4).any()
    logp = got[0].numpy()
    assert (logp == np.float32(NEG_INF)).any() and (logp > NEG_INF).any()


def _angle_diff_fast(a, b):
    """The build's angle difference (``transition.cuh`` angle_diff_fast) in
    numpy float32: fmod(d, 2 pi) by a compare where d lies in [-2 pi, 4
    pi), fmodf elsewhere."""
    f = np.float32
    pi, two_pi = f(CS.PI32), f(2 * CS.PI32)
    d = (b - a) + pi
    r = np.where((d >= 0) & (d < two_pi), d,
                 np.where((d >= two_pi) & (d < 2 * two_pi), d - two_pi,
                          np.where((d < 0) & (d > -two_pi), d + two_pi, f(0))))
    slow = ~(((d >= 0) & (d < 2 * two_pi)) | ((d < 0) & (d > -two_pi)))
    rs = np.fmod(d, two_pi)
    rs = np.where((rs != 0) & (rs < 0), rs + two_pi, rs)
    return np.where(slow, rs, r) - pi


def test_fast_angle_diff_equals_jnp_mod():
    """angle_diff_fast equals the reference's jnp.mod form bit for bit on
    every pair of the edge headings, on uniform headings, and where the
    argument lands on 0, 2 pi and 4 pi exactly or next to them, and next
    to -2 pi."""
    rng = np.random.default_rng(5)
    f = np.float32
    h = np.asarray(CS.EDGE_HEADINGS, f)
    a = np.concatenate([np.repeat(h, len(h)), rng.uniform(-4, 4, 50000),
                        rng.uniform(-20, 20, 5000)]).astype(f)
    b = np.concatenate([np.tile(h, len(h)), rng.uniform(-4, 4, 50000),
                        rng.uniform(-20, 20, 5000)]).astype(f)
    pi, two_pi = f(CS.PI32), f(2 * CS.PI32)
    for target in (f(0), two_pi, 2 * two_pi, -two_pi):
        bs = [f(target - pi)]
        for _ in range(4):
            bs = [np.nextafter(bs[0], f(-np.inf))] + bs + [np.nextafter(bs[-1], f(np.inf))]
        bs = np.asarray(bs, f)
        if target >= 0:  # -2 pi lies off the grid of (b - 0) + pi
            assert ((bs - f(0)) + pi == target).any()  # some land on the boundary exactly
        a, b = np.append(a, np.zeros_like(bs)), np.append(b, bs)
    want = np.asarray(jax.jit(RV.angle_diff)(a, b))
    _same_bits(_angle_diff_fast(a, b), want)


@pytest.mark.parametrize("T", [2, 3, 64, 2048, 65537])
def test_build_step_decode(T):
    """The build's step decode: the launcher's multiplier and shift for T-1
    (transcribed: l = ceil(log2(T-1)), mul = ceil(2^(32+l) / (T-1)) -
    2^32) are ``fast_divmod``'s, and (umulhi(r, mul) + r) >> l + r is
    point t of trace b for r = b (T-1) + t below 2^31."""
    d = T - 1
    shr = 0
    while (1 << shr) < d:
        shr += 1
    mul = ((1 << (32 + shr)) + d - 1) // d - (1 << 32)
    assert (mul, shr) == H.fast_divmod(d)
    rng = np.random.default_rng(T)
    r = np.concatenate([np.arange(0, 4 * d + 3), rng.integers(0, (1 << 31) - 1, 20000),
                        [(1 << 31) - 2]]).astype(np.uint64)
    hi = (r * np.uint64(mul)) >> np.uint64(32)
    b = ((hi + r) & np.uint64(0xFFFFFFFF)) >> np.uint64(shr)
    assert np.array_equal(b + r, r + r // np.uint64(d))


def test_plain_build_takes_any_k():
    """The run-time-K instantiation's K (neither a power of two nor at most
    32) runs the plain version as it does K = 8: equal to the reference."""
    _a, got, want, _tol = build_both(3, True, B=4, T=8)
    for g, w in zip(got, want):
        _same_bits(g.numpy(), w)
