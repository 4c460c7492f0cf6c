"""The sparse-gap model's device arithmetic in the port (kernels 3-5's plain
versions with ``sp``, on the CPU) against the reference's jitted
``sparse_beta`` / ``sparse_breakage``, ``precompute_batch`` with ``sp`` and
the five ``*_packed_sparse`` programs (the port's packed entry points
with ``sp``), on the reference's sparse test
world (``dryrun_scenario(rows=6, cols=6, spacing_m=200)``) with traces at
45-120 s gaps from the reference's ``TraceSynthesizer``.

Tolerances as tests/test_torch_viterbi.py: emis, logp, route and gc rtol
1e-6 (expected exact); the packed [3, B, T] output exactly equal; carries
and the slab bit for bit (-inf scores included); the [B, 4] confidence aux
rtol 1e-4, the one output whose float summation order may differ
(reference ops/viterbi.py:550-552)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.ops import viterbi as RV
from reporter_tpu.synth import TraceSynthesizer
from reporter_tpu.synth.generator import dryrun_scenario
from reporter_tpu_torch import convert
from reporter_tpu_torch.matching import MatcherConfig
from reporter_tpu_torch.ops import viterbi as V
from test_torch_builders import device_views
from test_torch_carry import _check, _same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(REPO, "CALIBRATION.json")) as _f:
    _GE60 = json.load(_f)["cohorts"]["ge60"]

# (beta_ref, beta_scale, beta_max, break_speed, vmax, plaus_weight)
FAMILY = (15.0, 1.0, 8.0, 34.0, 45.0, 3.0)  # the config's sparse family
CALIBRATED = tuple(float(_GE60[k]) for k in (
    "beta_ref_s", "beta_scale", "beta_max", "break_speed_mps", "vmax_mps",
    "plaus_weight"))
PLAUS0 = (15.0, 0.0, 8.0, 34.0, 45.0, 0.0)  # 0 * inf on infeasible pairs
VALUES = {"family": FAMILY, "calibrated": CALIBRATED, "plaus0": PLAUS0}

_ref_beta = jax.jit(RV.sparse_beta)
_ref_brk = jax.jit(RV.sparse_breakage)
_ref_pre = jax.jit(RV.precompute_batch, static_argnums=(7, 8))
_ref_match = jax.jit(RV.match_batch_compact_packed_sparse, static_argnums=(5,))
_ref_spre = jax.jit(RV.precompute_batch_packed_sparse, static_argnums=(5,))
_ref_chain = jax.jit(RV.chain_batch_carry_packed_sparse, static_argnums=(6,))
_ref_session = jax.jit(RV.session_step_packed_sparse, static_argnums=(5,))
_ref_arena = jax.jit(RV.session_step_arena_sparse, static_argnums=(5,))


@pytest.fixture(scope="module")
def world():
    cfg, ra, ru = dryrun_scenario(rows=6, cols=6, spacing_m=200.0, delta=3000.0)
    return cfg, ra, ru, (ra.to_device(), ru.to_device()), device_views(ra, ru)


def params(values, **cfg_kw):
    """(reference (MatchParams, SparseParams), port's) for one value set."""
    return ((RV.MatchParams.from_config(dataclasses.replace(RefConfig(), **cfg_kw)),
             RV.SparseParams.from_values(*values)),
            (V.MatchParams.from_config(dataclasses.replace(MatcherConfig(), **cfg_kw)),
             V.SparseParams.from_values(*values)))


def sparse_rows(arrays, seed, B, T, n_pad_rows=1):
    """A packed [4, B, T] batch of street-following traces at gaps of 45 to
    120 s (one row at 5 s), cut to lengths drawn from ``seed``, plus
    all-padding rows."""
    rng = np.random.default_rng(seed)
    synth = TraceSynthesizer(arrays, seed=seed)
    px, py, tm = (np.zeros((B, T), np.float32) for _ in range(3))
    valid = np.zeros((B, T), bool)
    for b in range(B - n_pad_rows):
        dt = 5.0 if b == 1 else float(rng.choice([45.0, 60.0, 90.0, 120.0]))
        n = T if b == 0 else int(rng.integers(2, T + 1))
        pts = synth.synthesize(n, dt=dt, uuid="s%d" % b, max_tries=400).trace["trace"]
        x, y = arrays.proj.to_xy([p["lat"] for p in pts], [p["lon"] for p in pts])
        px[b, :n], py[b, :n] = x, y
        tm[b, :n] = np.asarray([p["time"] for p in pts], np.float64) - pts[0]["time"]
        valid[b, :n] = True
    return RV.pack_inputs(px, py, tm, valid)


@pytest.mark.parametrize("name", ["family", "calibrated"])
def test_sparse_scalars_equal_reference(name):
    """beta(dt) and the breakage threshold bit for bit at dt in {0, 5, 15,
    60, 600, -1}; the reference's SparseParams convert bit for bit."""
    (rp, rsp), (pp, psp) = params(VALUES[name])
    dts = np.array([0.0, 5.0, 15.0, 60.0, 600.0, -1.0], np.float32)
    want_b = np.asarray(_ref_beta(rp, rsp, jnp.asarray(dts)))
    want_k = np.asarray(_ref_brk(rp, rsp, jnp.asarray(dts)))
    got_b = V.sparse_beta(pp.beta, psp, torch.from_numpy(dts)).numpy()
    got_k = V.sparse_breakage(pp.breakage_distance, psp, torch.from_numpy(dts)).numpy()
    assert got_b.tobytes() == want_b.tobytes()
    assert got_k.tobytes() == want_k.tobytes()
    assert float(V.sparse_breakage(pp.breakage_distance, None, torch.tensor(90.0))) == \
        float(pp.breakage_distance)
    conv = convert.sparse_params_from_numpy(jax.tree_util.tree_map(np.asarray, rsp))
    assert [t.numpy().tobytes() for t in conv] == [t.numpy().tobytes() for t in psp]


@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("name", ["family", "calibrated", "plaus0"])
def test_sparse_transition_build_equals_reference(world, K, name):
    """The sparse precompute (candidates, emissions, kernel 3 with ``sp``)
    against the reference's ``precompute_batch(..., sp)``.  The model moves
    logp away from the dense build's, except with beta_scale and
    plaus_weight 0 (plaus0), where it equals it; no NaN survives the
    mask."""
    _cfg, ra, _ru, (rg, ru), (dg, du) = world
    xin = sparse_rows(ra, 3 + K, 6, 24)
    (rp, rsp), (pp, psp) = params(VALUES[name], turn_penalty_factor=1.5)
    ref = _ref_pre(rg, ru, *RV.unpack_inputs(jnp.asarray(xin)), rp, K, False, rsp)
    got = V.precompute_batch(dg, du, *V.unpack_inputs(torch.from_numpy(xin)), pp, K, psp)
    for f in ("emis", "logp", "route", "gc"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=0, err_msg=f)
    assert np.array_equal(got.cand.edge.numpy(), np.asarray(ref.cand.edge))
    assert not torch.isnan(got.logp).any()
    dense = V.precompute_batch(dg, du, *V.unpack_inputs(torch.from_numpy(xin)), pp, K)
    assert torch.equal(dense.logp, got.logp) == (name == "plaus0")
    # the packed path's sparse precompute is the same build without routes
    lean = V.precompute_batch_packed(dg, du, torch.from_numpy(xin), pp, K, psp)
    assert lean.route is None and torch.equal(lean.logp, got.logp)


@pytest.mark.parametrize("seed,K,name", [(5, 16, "family"), (6, 16, "calibrated"),
                                         (7, 8, "plaus0")])
def test_match_compact_packed_sparse_equals_reference(world, seed, K, name):
    _cfg, ra, _ru, (rg, ru), (dg, du) = world
    xin = sparse_rows(ra, seed, 7, 32)
    (rp, rsp), (pp, psp) = params(VALUES[name])
    want_packed, want_aux = _ref_match(rg, ru, jnp.asarray(xin), rp, rsp, K)
    packed, aux = V.match_batch_compact_packed_aux_plain(
        dg, du, torch.from_numpy(xin), pp, K, psp)
    assert np.array_equal(packed.numpy(), np.asarray(want_packed))
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-4, atol=0)
    # on the CPU the wrapper entry point is the plain composition
    assert torch.equal(V.match_batch_compact_packed_aux(
        dg, du, torch.from_numpy(xin), pp, K, psp)[0], packed)


def test_gap_conditioned_breakage_connects():
    """The reference's case: a 2 x 16 grid (one straight 3 km road),
    breakage shrunk to 800 m, two points 1,200 m apart and 90 s apart.
    The dense model restarts the HMM there, the sparse one (breakage
    max(800, 34 * 90)) stays connected; both equal the reference."""
    cfg, ra, ru = dryrun_scenario(rows=2, cols=16, spacing_m=200.0, delta=3000.0)
    rg, rdu = ra.to_device(), ru.to_device()
    dg, du = device_views(ra, ru)
    (rp, rsp), (pp, psp) = params((15.0, 0.0, 8.0, 34.0, 45.0, 0.0),
                                  breakage_distance=800.0)
    n0 = float(ra.node_x[0]), float(ra.node_y[0])
    px = np.array([[n0[0] + 10.0, n0[0] + 1210.0]], np.float32)
    py = np.array([[n0[1], n0[1]]], np.float32)
    xin = RV.pack_inputs(px, py, np.array([[0.0, 90.0]], np.float32), np.ones((1, 2), bool))
    K = cfg.beam_k
    dense, _a = V.match_batch_compact_packed_aux_plain(dg, du, torch.from_numpy(xin), pp, K)
    sparse, _a = V.match_batch_compact_packed_aux_plain(
        dg, du, torch.from_numpy(xin), pp, K, psp)
    assert int(dense[2, 0, 1]) == 1  # dense: the hop restarts the HMM
    assert int(sparse[2, 0, 1]) == 0  # sparse: an honest drive, connected
    want = _ref_match(rg, rdu, jnp.asarray(xin), rp, rsp, K)[0]
    assert np.array_equal(sparse.numpy(), np.asarray(want))


@pytest.mark.parametrize("K,name", [(16, "family"), (8, "calibrated")])
def test_chain_sparse_equals_reference_window_by_window(world, K, name):
    """Three 16-point windows of a sparse batch, each side chaining its own
    carry from the inactive one: the seam transition and every step's
    breakage gap-conditioned."""
    _cfg, ra, _ru, (rg, ru), (dg, du) = world
    W = 16
    xin = sparse_rows(ra, 31, 6, 3 * W)
    B = xin.shape[1]
    (rp, rsp), (pp, psp) = params(VALUES[name])
    rc, pc = RV.initial_carry_batch(B, K), V.initial_carry_batch(B, K)
    seams = 0
    for c in range(3):
        seg = np.ascontiguousarray(xin[:, :, c * W:(c + 1) * W])
        want = _ref_chain(rg, ru, _ref_spre(rg, ru, jnp.asarray(seg), rp, rsp, K),
                          jnp.asarray(seg), rp, rsp, K, rc)
        st = torch.from_numpy(seg)
        got = V.chain_batch_carry_packed_aux_plain(
            dg, du, V.precompute_batch_packed_plain(dg, du, st, pp, K, psp), st,
            pp, K, pc, psp)
        _check(got, want, "window %d" % c)
        if c:
            seams += int((got[0][2, :, 0] == 0).sum())
        rc, pc = want[2], got[2]
    assert seams  # carried beams continued across a seam


@pytest.mark.parametrize("Wn", [4, 1])
def test_session_steps_sparse_equal_reference(world, Wn):
    """Three [B, Wn] sparse session steps, host carry and slab alike
    (continuing, fresh and padding rows), at the sessions' K = 8."""
    _cfg, ra, _ru, (rg, ru), (dg, du) = world
    K = 8
    xin = sparse_rows(ra, 41, 7, 3 * Wn, n_pad_rows=2)
    B = xin.shape[1]
    (rp, rsp), (pp, psp) = params(CALIBRATED)
    S = 12
    slots = np.array([3, 0, 11, 7, 5, S, S], np.int32)
    rc, pc = RV.initial_carry_batch(B, K), V.initial_carry_batch(B, K)
    rslab, pslab = RV.initial_carry_batch(S, K), V.initial_carry_batch(S, K)
    for c in range(3):
        seg = np.ascontiguousarray(xin[:, :, c * Wn:(c + 1) * Wn])
        want = _ref_session(rg, ru, jnp.asarray(seg), rp, rsp, K, rc)
        got = V.session_step_packed_plain(dg, du, torch.from_numpy(seg), pp, K, pc,
                                          psp)
        _check(got, want, "session step %d" % c)
        rc, pc = want[2], got[2]
        use = np.array([c > 0, c > 0, c > 0, c == 1, c > 0, False, False])
        want = _ref_arena(rg, ru, jnp.asarray(seg), rp, rsp, K, rslab,
                          jnp.asarray(slots), jnp.asarray(use))
        got = V.session_step_arena_plain(dg, du, torch.from_numpy(seg), pp, K, pslab,
                                         slots, use, psp)
        assert got[2] is pslab  # updated in place
        _check(got, want, "arena step %d" % c)
        rslab = want[2]
    _same(pslab, jax.tree_util.tree_map(np.asarray, rslab), "slab")
    for row in (0, 1, 2, 4):  # rows that always continued: slab == host carry
        for a, b in zip(pslab, pc):
            assert a[slots[row]].numpy().tobytes() == b[row].numpy().tobytes()


def test_plausibility_term_is_not_fused(world):
    """The compiled reference subtracts plaus_weight * excess from logp
    with the product rounded on its own, not as one fused multiply-add:
    the unfused form equals the reference's sparse logp bit for bit on
    every feasible pair, and the fused form differs on some (so the
    comparison can tell them apart).  vmax 5 m/s puts most pairs of these
    45-120 s traces above the knee."""
    from reporter_tpu_torch.ops.candidates import fma

    _cfg, ra, _ru, (rg, ru), (dg, du) = world
    xin = sparse_rows(ra, 3, 16, 48)
    values = (15.0, 0.7, 8.0, 34.0, 5.0, 3.3)
    (rp, rsp), (pp, psp) = params(values)
    K = 8
    ref = _ref_pre(rg, ru, *RV.unpack_inputs(jnp.asarray(xin)), rp, K, False, rsp)
    want = torch.from_numpy(np.array(ref.logp))
    px, py, tm, vd = V.unpack_inputs(torch.from_numpy(xin))
    got = V.precompute_batch(dg, du, px, py, tm, vd, pp, K, psp)
    # the same build without the plausibility term, and the term's parts
    base = V.precompute_batch(dg, du, px, py, tm, vd, pp, K,
                              V.SparseParams.from_values(*values[:5], 0.0)).logp
    dt = (tm[:, 1:] - tm[:, :-1])[:, :, None, None].expand_as(base)
    excess = (torch.clamp(got.route / torch.clamp(dt, min=1.0) - psp.vmax, min=0.0)
              / torch.clamp(psp.vmax, min=1.0))
    pen = (excess > 0) & (dt > 0) & torch.isfinite(got.route)
    w = psp.plaus_weight.expand_as(excess)
    unfused = base - w * excess
    fused = fma(-w, excess, base)
    assert pen.sum() > 1000
    assert torch.equal(got.logp[pen], want[pen]) and torch.equal(unfused[pen], want[pen])
    assert int((fused[pen] != want[pen]).sum()) > 0
