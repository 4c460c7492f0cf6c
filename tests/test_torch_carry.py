"""Carried Viterbi state (kernel 5's plain version on the CPU) against the
reference's jitted ``precompute_batch_packed`` + ``chain_batch_carry_packed_aux``,
``session_step_packed`` and ``session_step_arena``.

Carries are converted with ``convert.carry_from_numpy``.  Tolerances: the
packed [3, B, W] output and every carry / slab leaf equal bit for bit
(-inf scores included); the [B, 4] confidence aux rtol 1e-4, the one
output whose float summation order may differ (reference
ops/viterbi.py:550-552)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reporter_tpu.ops import viterbi as RV
from reporter_tpu_torch import convert
from reporter_tpu_torch.matching import MatcherConfig
from reporter_tpu_torch.ops import viterbi as V
from test_fuzz_differential import _seam_break_trace, random_traces
from test_torch_builders import device_views, scenario

K = 8
_ref_pre = jax.jit(RV.precompute_batch_packed, static_argnums=(4,))
_ref_chain = jax.jit(RV.chain_batch_carry_packed_aux, static_argnums=(5,))
_ref_session = jax.jit(RV.session_step_packed, static_argnums=(4,))
_ref_arena = jax.jit(RV.session_step_arena, static_argnums=(4,))


def _params():
    from reporter_tpu.matching import MatcherConfig as RefConfig
    return (RV.MatchParams.from_config(RefConfig()),
            V.MatchParams.from_config(MatcherConfig()))


def _rows(arrays, traces, T, n_pad_rows=1):
    """[4, B, T] packed rows of ``traces`` (times rebased to each trace's
    start, cut at T), plus all-padding rows."""
    B = len(traces) + n_pad_rows
    px, py, tm = (np.zeros((B, T), np.float32) for _ in range(3))
    valid = np.zeros((B, T), bool)
    for b, tr in enumerate(traces):
        pts = tr["trace"][:T]
        n = len(pts)
        x, y = arrays.proj.to_xy([p["lat"] for p in pts], [p["lon"] for p in pts])
        px[b, :n], py[b, :n] = x, y
        tm[b, :n] = np.asarray([p["time"] for p in pts], np.float64) - pts[0]["time"]
        valid[b, :n] = True
    return RV.pack_inputs(px, py, tm, valid)


def _long_batch(net, arrays, seed, n_chunks, W):
    """Fuzz traces of mixed lengths over n_chunks windows, the seam-break
    trace (a teleport exactly at point W) and an all-padding row."""
    rng = np.random.default_rng(seed)
    T = n_chunks * W
    traces = random_traces(rng, net, arrays, 4, n_pts=T)
    for tr, n in zip(traces, (T, T - W // 2, W + 1, T - 1)):
        tr["trace"] = tr["trace"][:n]
    traces.append(_seam_break_trace(net, W=W, n_pts=T))
    return _rows(arrays, traces, T)


def _same(port: V.TraceCarry, ref, what):
    ref = convert.carry_from_numpy(ref)
    for name, a, b in zip(V.TraceCarry._fields, port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert a.numpy().tobytes() == b.numpy().tobytes(), (what, name)


def _check(got, want, what):
    packed, aux, carry = got
    rpacked, raux, rcarry = want
    assert np.array_equal(packed.numpy(), np.asarray(rpacked)), what
    np.testing.assert_allclose(aux.numpy(), np.asarray(raux), rtol=1e-4, atol=0,
                               err_msg=what)
    _same(carry, rcarry, what)


def _chain_both(dgs, xin, c, W, carry_ref, carry_port, p0, p1, plain):
    (rg, ru), (dg, du) = dgs
    seg = np.ascontiguousarray(xin[:, :, c * W:(c + 1) * W])
    rpre = _ref_pre(rg, ru, jnp.asarray(seg), p0, K)
    want = _ref_chain(rg, ru, rpre, jnp.asarray(seg), p0, K, carry_ref)
    st = torch.from_numpy(seg)
    if plain:
        pre = V.precompute_batch_packed_plain(dg, du, st, p1, K)
        got = V.chain_batch_carry_packed_aux_plain(dg, du, pre, st, p1, K, carry_port)
    else:
        pre = V.precompute_batch_packed(dg, du, st, p1, K)
        got = V.chain_batch_carry_packed_aux(dg, du, pre, st, p1, K, carry_port)
    return got, want


@pytest.mark.parametrize("seed,W,plain", [(7, 16, True), (19, 16, False), (43, 1, False)])
def test_chain_matches_reference_window_by_window(seed, W, plain):
    """A long batch through 3 windows (W=16) or 8 one-point windows (W=1,
    an empty [B, 0, K, K] transition tensor), each side chaining its own
    carry from the inactive one; the seam-break trace teleports exactly
    at the first seam."""
    net, ra, ru, _pa, _pu = scenario(seed)
    n_chunks = 3 if W > 1 else 8
    xin = _long_batch(net, ra, seed, n_chunks, W)
    B = xin.shape[1]
    p0, p1 = _params()
    dgs = ((ra.to_device(), ru.to_device()), device_views(ra, ru))
    rc = RV.initial_carry_batch(B, K)
    pc = V.initial_carry_batch(B, K)
    _same(pc, jax.tree_util.tree_map(np.asarray, rc), "inactive")
    seam_breaks = 0
    for c in range(n_chunks):
        got, want = _chain_both(dgs, xin, c, W, rc, pc, p0, p1, plain)
        _check(got, want, "chunk %d" % c)
        if c:
            seam_breaks += int(got[0][2, :, 0].sum())
        rc, pc = want[2], got[2]
    assert seam_breaks  # restarts at a seam: the teleport, a padded tail
    assert not got[2].active[B - 1] and int(got[2].committed[B - 1]) == -1


def test_seam_check_breaks_an_unreachable_committed_slot():
    """A carry whose committed slot cannot reach the window's first choice
    (its edge made invalid): the seam check raises a break the recursion
    alone would not."""
    net, ra, ru, _pa, _pu = scenario(11)
    W = 16
    xin = _long_batch(net, ra, 11, 2, W)
    p0, p1 = _params()
    dgs = ((ra.to_device(), ru.to_device()), device_views(ra, ru))
    B = xin.shape[1]
    (_p, _a, pc), (_rp, _ra, rc) = _chain_both(
        dgs, xin, 0, W, RV.initial_carry_batch(B, K), V.initial_carry_batch(B, K),
        p0, p1, True)
    live = np.asarray(rc.active) & (np.asarray(rc.committed) >= 0)
    assert live.any()
    cut = {f: np.array(np.asarray(getattr(rc, f))) for f in RV.TraceCarry._fields}
    rows = np.nonzero(live)[0]
    cut["edge"][rows, cut["committed"][rows]] = -1
    rcut = RV.TraceCarry(**{f: jnp.asarray(v) for f, v in cut.items()})
    got, want = _chain_both(dgs, xin, 1, W, rcut, convert.carry_from_numpy(cut),
                            p0, p1, True)
    _check(got, want, "unreachable committed slot")
    base, _w = _chain_both(dgs, xin, 1, W, rc, pc, p0, p1, True)
    assert (got[0][2, rows, 0] > base[0][2, rows, 0]).any()


@pytest.mark.parametrize("Wn", [4, 1])
def test_session_step_and_arena_match_reference(Wn):
    """Three steps of [B, Wn] session windows, host carry and slab alike:
    distinct live slots, padding rows (slot == S) and rows that start
    fresh (use_carry false) although their slot holds an old beam."""
    net, ra, ru, _pa, _pu = scenario(29)
    traces = random_traces(np.random.default_rng(29), net, ra, 5, n_pts=3 * Wn)
    xin = _rows(ra, traces, 3 * Wn, n_pad_rows=2)
    B = xin.shape[1]
    p0, p1 = _params()
    (rg, ru_), (dg, du) = (ra.to_device(), ru.to_device()), device_views(ra, ru)
    S = 12
    slots = np.array([3, 0, 11, 7, 5, S, S], np.int32)
    rc, pc = RV.initial_carry_batch(B, K), V.initial_carry_batch(B, K)
    rslab, pslab = RV.initial_carry_batch(S, K), V.initial_carry_batch(S, K)
    for c in range(3):
        seg = np.ascontiguousarray(xin[:, :, c * Wn:(c + 1) * Wn])
        want = _ref_session(rg, ru_, jnp.asarray(seg), p0, K, rc)
        got = V.session_step_packed_plain(dg, du, torch.from_numpy(seg), p1, K, pc)
        _check(got, want, "session step %d" % c)
        rc, pc = want[2], got[2]
        use = np.array([c > 0, c > 0, c > 0, c == 1, c > 0, False, False])
        want = _ref_arena(rg, ru_, jnp.asarray(seg), p0, K, rslab,
                          jnp.asarray(slots), jnp.asarray(use))
        got = V.session_step_arena_plain(dg, du, torch.from_numpy(seg), p1, K,
                                         pslab, slots, use)
        assert got[2] is pslab  # updated in place
        _check(got, want, "arena step %d" % c)
        rslab = want[2]
    # the slab rows of the rows that always continued equal the host carry
    for row in (0, 1, 2, 4):
        for a, b in zip(pslab, pc):
            assert a[slots[row]].numpy().tobytes() == b[row].numpy().tobytes()


def test_slab_rows_are_checked():
    net, ra, ru, _pa, _pu = scenario(7)
    dg, du = device_views(ra, ru)
    _p0, p1 = _params()
    xin = torch.from_numpy(_rows(ra, random_traces(np.random.default_rng(1), net, ra,
                                                   2, n_pts=4), 4, n_pad_rows=1))
    slab = V.initial_carry_batch(4, K)
    with pytest.raises(ValueError, match="at most once"):
        V.session_step_arena(dg, du, xin, p1, K, slab, np.array([1, 1, 4]),
                             np.array([True, True, False]))
    with pytest.raises(ValueError, match="padding row"):
        V.session_step_arena(dg, du, xin, p1, K, slab, np.array([0, 1, 4]),
                             np.array([True, True, True]))
