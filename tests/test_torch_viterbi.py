"""The port's match program (kernels 1-4's plain versions on the CPU)
against the reference's jitted ``precompute_batch`` and
``match_batch_compact_packed_aux``.

Tolerances: emis, logp, route and gc rtol 1e-6 (expected exact); the
packed [3, B, T] output exactly equal; the [B, 4] confidence aux rtol
1e-4, the one output whose float summation order may differ
(reference ops/viterbi.py:550-552)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.ops import viterbi as RV
from reporter_tpu_torch.matching import MatcherConfig
from reporter_tpu_torch.ops import viterbi as V
from test_fuzz_differential import random_traces
from test_torch_builders import device_views, scenario

_ref_pre = jax.jit(RV.precompute_batch, static_argnums=(7,))
_ref_match = jax.jit(RV.match_batch_compact_packed_aux, static_argnums=(4,))


def batch(net, arrays, seed, B, T, n_pad_rows=1):
    """A [4, B, T] packed batch: fuzz traces (road-following and random
    points: zero-candidate steps and breaks) cut to random lengths, plus
    all-padding rows."""
    rng = np.random.default_rng(seed)
    traces = random_traces(rng, net, arrays, B, n_pts=T)
    px = np.zeros((B, T), np.float32)
    py = np.zeros((B, T), np.float32)
    tm = np.zeros((B, T), np.float32)
    valid = np.zeros((B, T), bool)
    for b, tr in enumerate(traces[: B - n_pad_rows]):
        n = int(rng.integers(2, T + 1)) if b else T
        pts = tr["trace"][:n]
        x, y = arrays.proj.to_xy([p["lat"] for p in pts], [p["lon"] for p in pts])
        px[b, :n], py[b, :n] = x, y
        tm[b, :n] = np.asarray([p["time"] for p in pts], np.float64) - pts[0]["time"]
        valid[b, :n] = True
    return RV.pack_inputs(px, py, tm, valid)


def params(cfg_kw):
    return (RV.MatchParams.from_config(dataclasses.replace(RefConfig(), **cfg_kw)),
            V.MatchParams.from_config(dataclasses.replace(MatcherConfig(), **cfg_kw)))


@pytest.mark.parametrize("seed,T,cfg_kw", [
    (3, 16, {}),
    (11, 64, {}),
    (19, 64, {"turn_penalty_factor": 2.0, "max_route_time_factor": 1.2}),
])
def test_precompute_matches_reference(seed, T, cfg_kw):
    net, ra, ru, _pa, _pu = scenario(seed)
    xin = batch(net, ra, seed, 5, T)
    p0, p1 = params(cfg_kw)
    ref = _ref_pre(ra.to_device(), ru.to_device(), *RV.unpack_inputs(jnp.asarray(xin)), p0, 8)
    dg, du = device_views(ra, ru)
    got = V.precompute_batch(dg, du, *V.unpack_inputs(torch.from_numpy(xin)), p1, 8)
    for f in ("emis", "logp", "route", "gc"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=0, err_msg=f)
    assert np.array_equal(got.cand.edge.numpy(), np.asarray(ref.cand.edge))
    feasible = np.isfinite(got.route.numpy())
    assert feasible.any() and (~feasible).any()


@pytest.mark.parametrize("seed,B,T", [(3, 5, 16), (11, 7, 64), (43, 6, 256), (29, 3, 64)])
def test_packed_aux_matches_reference(seed, B, T):
    net, ra, ru, _pa, _pu = scenario(seed)
    xin = batch(net, ra, seed, B, T)
    p0, p1 = params({})
    ref_packed, ref_aux = _ref_match(ra.to_device(), ru.to_device(), jnp.asarray(xin), p0, 8)
    dg, du = device_views(ra, ru)
    packed, aux = V.match_batch_compact_packed_aux(dg, du, torch.from_numpy(xin), p1, 8)
    assert packed.dtype == torch.int32 and packed.shape == (3, B, T)
    assert np.array_equal(packed.numpy(), np.asarray(ref_packed))
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), rtol=1e-4, atol=0)
    brk = packed.numpy()[2]
    assert brk[:, 1:].any()  # restarts inside traces, not only at t = 0
    assert not brk[B - 1].any()  # the all-padding row


def test_plain_composition_equals_wrappers_on_cpu():
    net, ra, ru, _pa, _pu = scenario(7)
    xin = torch.from_numpy(batch(net, ra, 7, 4, 16))
    dg, du = device_views(ra, ru)
    p = V.MatchParams.from_config(MatcherConfig())
    a = V.match_batch_compact_packed_aux(dg, du, xin, p, 8)
    b = V.match_batch_compact_packed_aux_plain(dg, du, xin, p, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("stage", ["sweep", "probe", "build"])
def test_packed_path_outputs_equal_full_outputs(stage):
    """The packed path's wrappers skip the outputs the scan never reads
    (dist/cx/cy, first edge, route): those come back None and every output
    they do return equals the full call's."""
    from reporter_tpu_torch.ops.candidates import candidate_sweep
    from reporter_tpu_torch.ops.hashtable import ubodt_lookup

    net, ra, ru, _pa, _pu = scenario(11)
    px, py, tm, valid = V.unpack_inputs(torch.from_numpy(batch(net, ra, 11, 5, 32)))
    dg, du = device_views(ra, ru)
    p = V.MatchParams.from_config(MatcherConfig())
    sw = candidate_sweep(dg, px, py, valid, 8, p.search_radius, p.sigma_z)
    a_keys, b_keys = sw.to_node[:, :-1, :, None], sw.from_node[:, 1:, None, :]
    sp = ubodt_lookup(du, a_keys, b_keys)
    if stage == "sweep":
        full = [sw.cand.edge, sw.cand.offset, sw.emis, sw.to_node, sw.from_node]
        lean = candidate_sweep(dg, px, py, valid, 8, p.search_radius, p.sigma_z, False)
        got = [lean.cand.edge, lean.cand.offset, lean.emis, lean.to_node, lean.from_node]
        skipped = [lean.cand.dist, lean.cand.cx, lean.cand.cy]
    elif stage == "probe":
        full = list(sp[:2])
        lean = ubodt_lookup(du, a_keys, b_keys, with_first=False)
        got, skipped = list(lean[:2]), [lean[2]]
        assert torch.isfinite(sp[0]).any()
    else:
        args = (dg, sw.cand, px, py, tm, sp[0], sp[1], p)
        logp, _route, gc = V.transition_build(*args)
        lean = V.transition_build(*args, with_route=False)
        full, got, skipped = [logp, gc], [lean[0], lean[2]], [lean[1]]
    assert all(s is None for s in skipped)
    assert all(torch.equal(u, w) for u, w in zip(got, full))


def test_angle_diff_matches_jnp_mod():
    rng = np.random.default_rng(0)
    a = rng.uniform(-4, 4, 20000).astype(np.float32)
    b = rng.uniform(-4, 4, 20000).astype(np.float32)
    b[:100] = a[:100]  # zero difference
    b[100:200] = a[100:200] + np.float32(np.pi)  # half turns
    want = np.asarray(jax.jit(RV.angle_diff)(a, b))
    got = V.angle_diff(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.tobytes() == want.tobytes()
