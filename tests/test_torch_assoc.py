"""The log-depth (assoc) Viterbi forward of the port (the plain versions of
``viterbi_assoc`` and ``viterbi_chain_assoc``, on the CPU) against the JAX
package's ``kernel="assoc"`` programs: ``jax.lax.associative_scan``'s
pairing, ``_forward_assoc`` and ``backtrace_assoc``, the packed entry
points (windowed, the chain window by window, host-carry and slab session
steps; dense and sparse), and the matcher (``_canon(match_many)``, long
traces, ``SessionEngine`` streams), plus the forward's selection
(``viterbi_kernel``, ``$REPORTER_VITERBI``, ``viterbi_assoc_threshold``).

Tolerances: the packed [3, B, T] output, backpointers, break flags and
carries equal bit for bit; scores equal by value (a max over equal sums
may keep either sign of a zero); the [B, 4] confidence aux rtol 1e-4, the
one output whose float summation order may differ (reference
ops/viterbi.py:550-552)."""

import dataclasses
import json
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.ops import viterbi as RV
from reporter_tpu.synth.generator import dryrun_scenario
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import (
    MatcherConfig, SegmentMatcher, SessionEngine, SessionStore,
)
from reporter_tpu_torch.ops import viterbi as V
from reporter_tpu_torch.serve import ReporterService
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from test_fuzz_differential import _canon, _seam_break_trace, random_network, random_traces
from test_torch_builders import device_views, scenario
from test_torch_carry import _check, _long_batch, _same
from test_torch_session import _carry_bytes, _stream
from test_torch_sparse import CALIBRATED, FAMILY, sparse_rows
from test_torch_viterbi import batch

K = 8


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Both matchers read these when built; every test pins its forward
    through the config and starts from the library defaults."""
    for var in ("REPORTER_VITERBI", "REPORTER_SPARSE", "REPORTER_CALIBRATION",
                "REPORTER_SESSION_ARENA", "REPORTER_QUALITY_AUX"):
        monkeypatch.delenv(var, raising=False)


def _params(values=None, **cfg_kw):
    rp = RV.MatchParams.from_config(dataclasses.replace(RefConfig(), **cfg_kw))
    pp = V.MatchParams.from_config(dataclasses.replace(MatcherConfig(), **cfg_kw))
    if values is None:
        return (rp, None), (pp, None)
    return ((rp, RV.SparseParams.from_values(*values)),
            (pp, V.SparseParams.from_values(*values)))


# -- the pairing -------------------------------------------------------------

def _combine_jax(a, b):
    fa, ma, ca = a
    fb, mb, cb = b
    mab = jnp.max(ma[..., :, :, None] + mb[..., None, :, :], axis=-2)
    return fa | fb, mab, jnp.where(fb[..., None], cb,
                                   jnp.max(ca[..., :, None] + mb, axis=-2))


def _combine_torch(a, b):
    fa, ma, ca = a
    fb, mb, cb = b
    mab = (ma[..., :, :, None] + mb[..., None, :, :]).amax(-2)
    return fa | fb, mab, torch.where(fb[..., None], cb, (ca[..., :, None] + mb).amax(-2))


def _elems(n, seed=0, k=4):
    rng = np.random.default_rng(seed + n)
    return (rng.random(n) < 0.2,
            (rng.normal(size=(n, k, k)) * 100).astype(np.float32),
            (rng.normal(size=(n, k)) * 100).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 63, 255])
def test_assoc_scan_plain_pairs_like_jax(n, reverse):
    """The segmented tropical combine through ``_assoc_scan_plain`` and
    through ``jax.lax.associative_scan``: every element bit for bit."""
    f, m, c = _elems(n)
    want = jax.jit(lambda x: jax.lax.associative_scan(_combine_jax, x, reverse=reverse))(
        (jnp.asarray(f), jnp.asarray(m), jnp.asarray(c)))
    got = V._assoc_scan_plain(_combine_torch, tuple(map(torch.from_numpy, (f, m, c))),
                              reverse=reverse)
    for w, g in zip(want, got):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_a_left_fold_rounds_otherwise():
    """The pairing is not a detail: the left fold of the same maps (the
    scan's order) gives other bits, so the test above can tell trees
    apart."""
    f, m, c = map(torch.from_numpy, _elems(255))
    tree = V._assoc_scan_plain(_combine_torch, (f, m, c))[1]
    acc = (f[:1], m[:1], c[:1])
    fold = [acc[1]]
    for t in range(1, 255):
        acc = _combine_torch(acc, (f[t:t + 1], m[t:t + 1], c[t:t + 1]))
        fold.append(acc[1])
    fold = torch.cat(fold)
    assert torch.allclose(tree, fold, rtol=1e-5, atol=1e-2)
    assert not torch.equal(tree, fold)


# -- the forward and the backtrace -------------------------------------------

_ref_fwd = jax.jit(jax.vmap(RV._forward_assoc, in_axes=(0, 0, 0, 0, 0, 0, None)))
_ref_fwd_sp = jax.jit(jax.vmap(RV._forward_assoc, in_axes=(0, 0, 0, 0, 0, 0, None, 0)))
_ref_back = jax.jit(jax.vmap(RV.backtrace_assoc))
_ref_pre = jax.jit(RV.precompute_batch, static_argnums=(7, 8))


@pytest.mark.parametrize("seed,T,sparse", [(3, 16, False), (11, 64, False),
                                           (19, 33, True)])
def test_forward_and_backtrace_equal_reference(seed, T, sparse):
    """``_forward_assoc_plain`` and ``_backtrace_assoc_plain`` on the
    reference's own precompute of a fuzz batch (zero-candidate steps,
    breaks, padded tails, an all-padding row), the breakage distance cut
    to the 30th percentile of the steps so that hard breaks occur; sparse:
    per-step thresholds from each step's gap (they change which steps
    break)."""
    net, ra, ru, _pa, _pu = scenario(seed)
    xin = batch(net, ra, seed, 6, T)
    step = (xin[3, :, 1:] != 0)
    gc_np = np.hypot(np.diff(xin[0], axis=1), np.diff(xin[1], axis=1))[step]
    brk = float(np.quantile(gc_np, 0.3))
    values = (15.0, 1.0, 8.0, 3.0, 45.0, 3.0) if sparse else None
    (rp, rsp), (pp, psp) = _params(values, breakage_distance=brk)
    px, py, tm, valid = RV.unpack_inputs(jnp.asarray(xin))
    pre = _ref_pre(ra.to_device(), ru.to_device(), px, py, tm, valid, rp, K, False, rsp)
    args = (pre.emis[:, 0], pre.logp, pre.route, pre.emis, pre.gc, valid, rp)
    dt = np.diff(xin[2], axis=1)
    if sparse:
        thresh = RV.sparse_breakage(rp, rsp, jnp.asarray(dt))
        scores, bp, broke, _route = _ref_fwd_sp(*args, thresh)
    else:
        scores, bp, broke, _route = _ref_fwd(*args)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    emis, vb = t(pre.emis), t(valid)
    brk_t = V.sparse_breakage(pp.breakage_distance, psp, torch.from_numpy(dt))
    S, BP, BR = V._forward_assoc_plain(emis[:, 0], torch.ones(6, dtype=torch.bool), emis,
                                       t(pre.logp), t(pre.gc), vb, brk_t)
    assert np.array_equal(S[:, 1:].numpy(), np.asarray(scores))
    assert np.array_equal(BP[:, 1:].numpy(), np.asarray(bp))
    assert np.array_equal(BR[:, 1:].numpy(), np.asarray(broke) & np.asarray(valid)[:, 1:])
    hard = (t(pre.gc) > brk_t) & vb[:, 1:]
    assert hard.any() and BR[:, 1:].any()
    assert (~t(pre.emis > RV.NEG_INF / 2).any(2) & vb).any()  # zero-candidate points
    if sparse:  # the gap-conditioned thresholds decide some steps
        assert ((t(pre.gc) > float(pp.breakage_distance)) & ~hard & vb[:, 1:]).any()
    idx = V._backtrace_assoc_plain(S, BP, vb)
    want = _ref_back(t(S).numpy(), BP.to(torch.int32).numpy(), np.asarray(valid))
    assert np.array_equal(idx.numpy(), np.asarray(want))
    # the log-depth backtrace composes exactly: the serial walk agrees
    assert torch.equal(idx, V._backtrace_plain(S, BP, vb))


# -- the packed entry points -------------------------------------------------

_ref_match = jax.jit(RV.match_batch_compact_packed_aux, static_argnums=(4, 5))
_ref_match_sp = jax.jit(RV.match_batch_compact_packed_sparse, static_argnums=(5, 6))


@pytest.mark.parametrize("seed,T", [(3, 16), (43, 256), (29, 2), (7, 1)])
def test_packed_match_equals_reference(seed, T):
    """``match_batch_compact_packed_aux_plain(kernel="assoc")`` against the
    reference's jitted ``kernel="assoc"`` program; at T = 1 both run the
    scan."""
    net, ra, ru, _pa, _pu = scenario(seed)
    xin = batch(net, ra, seed, 5, T) if T > 1 else RV.pack_inputs(
        *(np.zeros((3, 1), np.float32),) * 3, np.array([[True], [True], [False]]))
    (rp, _), (pp, _) = _params()
    want = _ref_match(ra.to_device(), ru.to_device(), jnp.asarray(xin), rp, K, "assoc")
    dg, du = device_views(ra, ru)
    got = V.match_batch_compact_packed_aux_plain(dg, du, torch.from_numpy(xin), pp, K,
                                                 kernel="assoc")
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=0)
    assert torch.equal(V.match_batch_compact_packed_aux(
        dg, du, torch.from_numpy(xin), pp, K, kernel="assoc")[0], got[0])


@pytest.fixture(scope="module")
def sworld():
    cfg, ra, ru = dryrun_scenario(rows=6, cols=6, spacing_m=200.0, delta=3000.0)
    return cfg, ra, ru, (ra.to_device(), ru.to_device()), device_views(ra, ru)


@pytest.mark.parametrize("seed,Ks,values", [(5, 16, FAMILY), (6, 8, CALIBRATED)])
def test_packed_sparse_match_equals_reference(sworld, seed, Ks, values):
    _cfg, ra, _ru, (rg, ru), (dg, du) = sworld
    xin = sparse_rows(ra, seed, 7, 32)
    (rp, rsp), (pp, psp) = _params(values)
    want = _ref_match_sp(rg, ru, jnp.asarray(xin), rp, rsp, Ks, "assoc")
    got = V.match_batch_compact_packed_aux_plain(dg, du, torch.from_numpy(xin), pp, Ks,
                                                 psp, kernel="assoc")
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=0)


_ref_ppre = jax.jit(RV.precompute_batch_packed, static_argnums=(4,))
_ref_spre = jax.jit(RV.precompute_batch_packed_sparse, static_argnums=(5,))
_ref_chain = jax.jit(RV.chain_batch_carry_packed_aux, static_argnums=(5, 7))
_ref_chain_sp = jax.jit(RV.chain_batch_carry_packed_sparse, static_argnums=(6, 8))


@pytest.mark.parametrize("sparse", [False, True])
def test_chain_equals_reference_window_by_window(sworld, sparse):
    """Three 16-point windows, each side chaining its own carry from the
    inactive one, through ``chain_batch_carry_packed_aux_plain(kernel=
    "assoc")``: dense on a fuzz batch with the seam-break trace, sparse at
    K = 16 on a sparse batch."""
    W = 16
    if sparse:
        _cfg, ra, _ru, (rg, ru), (dg, du) = sworld
        xin, k = sparse_rows(ra, 31, 6, 3 * W), 16
        (rp, rsp), (pp, psp) = _params(FAMILY)
    else:
        net, ra, ru0, _pa, _pu = scenario(19)
        rg, ru = ra.to_device(), ru0.to_device()
        dg, du = device_views(ra, ru0)
        xin, k = _long_batch(net, ra, 19, 3, W), K
        (rp, rsp), (pp, psp) = _params()
    B = xin.shape[1]
    rc, pc = RV.initial_carry_batch(B, k), V.initial_carry_batch(B, k)
    seams = 0
    for c in range(3):
        seg = np.ascontiguousarray(xin[:, :, c * W:(c + 1) * W])
        js, st = jnp.asarray(seg), torch.from_numpy(seg)
        if sparse:
            want = _ref_chain_sp(rg, ru, _ref_spre(rg, ru, js, rp, rsp, k), js, rp, rsp,
                                 k, rc, "assoc")
        else:
            want = _ref_chain(rg, ru, _ref_ppre(rg, ru, js, rp, k), js, rp, k, rc, "assoc")
        got = V.chain_batch_carry_packed_aux_plain(
            dg, du, V.precompute_batch_packed_plain(dg, du, st, pp, k, psp), st, pp, k,
            pc, psp, kernel="assoc")
        _check(got, want, "window %d" % c)
        if c:
            seams += int((got[0][2, :, 0] == 0).sum())
        rc, pc = want[2], got[2]
    assert seams  # carried beams continued across a seam


_ref_session = jax.jit(RV.session_step_packed, static_argnums=(4, 6))
_ref_arena = jax.jit(RV.session_step_arena, static_argnums=(4, 8))
_ref_session_sp = jax.jit(RV.session_step_packed_sparse, static_argnums=(5, 7))
_ref_arena_sp = jax.jit(RV.session_step_arena_sparse, static_argnums=(5, 9))


@pytest.mark.parametrize("Wn,sparse", [(4, False), (1, False), (4, True)])
def test_session_steps_equal_reference(sworld, Wn, sparse):
    """Three [B, Wn] session steps, host carry and slab alike (continuing,
    fresh and padding rows) under ``kernel="assoc"``; at Wn = 1 both sides
    run the scan."""
    _cfg, ra, _ru, (rg, ru), (dg, du) = sworld
    xin = sparse_rows(ra, 41, 7, 3 * Wn, n_pad_rows=2)
    B = xin.shape[1]
    (rp, rsp), (pp, psp) = _params(CALIBRATED if sparse else None)
    S = 12
    slots = np.array([3, 0, 11, 7, 5, S, S], np.int32)
    rc, pc = RV.initial_carry_batch(B, K), V.initial_carry_batch(B, K)
    rslab, pslab = RV.initial_carry_batch(S, K), V.initial_carry_batch(S, K)
    for c in range(3):
        seg = np.ascontiguousarray(xin[:, :, c * Wn:(c + 1) * Wn])
        js, st = jnp.asarray(seg), torch.from_numpy(seg)
        use = np.array([c > 0, c > 0, c > 0, c == 1, c > 0, False, False])
        if sparse:
            want = _ref_session_sp(rg, ru, js, rp, rsp, K, rc, "assoc")
            want_a = _ref_arena_sp(rg, ru, js, rp, rsp, K, rslab, jnp.asarray(slots),
                                   jnp.asarray(use), "assoc")
        else:
            want = _ref_session(rg, ru, js, rp, K, rc, "assoc")
            want_a = _ref_arena(rg, ru, js, rp, K, rslab, jnp.asarray(slots),
                                jnp.asarray(use), "assoc")
        got = V.session_step_packed_plain(dg, du, st, pp, K, pc, psp, kernel="assoc")
        _check(got, want, "session step %d" % c)
        rc, pc = want[2], got[2]
        got = V.session_step_arena_plain(dg, du, st, pp, K, pslab, slots, use, psp,
                                         kernel="assoc")
        _check(got, want_a, "arena step %d" % c)
        rslab = want_a[2]
    _same(pslab, jax.tree_util.tree_map(np.asarray, rslab), "slab")


def test_unknown_kernel_raises():
    net, ra, ru, _pa, _pu = scenario(3)
    dg, du = device_views(ra, ru)
    xin = torch.from_numpy(batch(net, ra, 3, 3, 8))
    with pytest.raises(ValueError, match="unknown viterbi kernel"):
        V.match_batch_compact_packed_aux(dg, du, xin, _params()[1][0], K, kernel="auto")


@pytest.fixture
def launched(monkeypatch):
    """Every kernel replaced by a recorder of (name, arguments passed, the
    C function's arity), so that the wrappers' launch side runs here; the
    assoc kernels' workspace query (their library's) answers 0 floats a
    trace below T = 4 (the levels in shared memory), 5 T K above."""
    from reporter_tpu_torch.ops import _kernels

    monkeypatch.setattr(V, "_assoc_ws_floats", lambda T, K, carry: 0 if T < 4 else 5 * T * K)

    calls = []
    for name, k in list(_kernels.KERNELS.items()):
        def launch(dev, *args, _name=name, _arity=len(k.argtypes)):
            calls.append((_name, len(args), _arity))
        monkeypatch.setitem(_kernels.KERNELS, name, types.SimpleNamespace(launch=launch))
    return calls


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("T", [1, 2, 5])
def test_wrappers_launch_by_forward_and_length(launched, T, sparse):
    """On tensors off the CPU (``meta`` here: shapes without data or a card)
    the wrappers launch kernels: under "assoc" the assoc kernels at T >= 2
    and kernels 4 and 5 at T < 2, as the reference runs the scan there;
    under "scan" kernels 4 and 5; each with the C function's arity (the
    assoc ones take the workspace too)."""
    dev = torch.device("meta")
    B, S = 3, 6
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    i = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)  # noqa: E731
    sp = V.SparseParams.from_values(*FAMILY) if sparse else None
    p = V.MatchParams.from_config(MatcherConfig())
    dg = types.SimpleNamespace(edge_rows=f(10, 8))
    du = types.SimpleNamespace(packed=i(4, 128), bmask=3, wide=False)
    win = (f(B, T, K), f(B, T - 1, K, K), f(B, T - 1))
    tag = "[sparse]" if sparse else ""
    for kernel in ("scan", "assoc"):
        assoc = kernel == "assoc" and T >= 2
        del launched[:]
        V.viterbi_scan(*win, f(B, T), i(B, T, K), f(B, T, K), 2000.0, f(B, T), sp,
                       kernel=kernel)
        V.viterbi_chain(dg, du, *win, f(B, T), f(B, T), f(B, T), f(B, T), i(B, T, K),
                        f(B, T, K), p, V.initial_carry_batch(B, K, dev), sp=sp,
                        kernel=kernel)
        V.viterbi_chain(dg, du, *win, f(B, T), f(B, T), f(B, T), f(B, T), i(B, T, K),
                        f(B, T, K), p, V.initial_carry_batch(S, K, dev),
                        np.array([0, 5, S]), np.array([True, False, False]), sp,
                        kernel)
        names = [("viterbi_assoc" if assoc else "viterbi_scan") + tag] + \
            [("viterbi_chain_assoc" if assoc else "viterbi_chain") + tag] * 2
        assert [c[0] for c in launched] == names
        assert all(n == arity for _name, n, arity in launched)
    for carry in (False, True):
        ws = V._assoc_workspace(B, T, K, dev, carry)
        assert ws is None if T < 4 else ws.numel() == B * 5 * T * K


# -- the matcher ---------------------------------------------------------------

def _fuzz_world(seed):
    rng = np.random.default_rng(seed)
    net = random_network(rng)
    ra = ref_build_graph_arrays(net)
    pa = build_graph_arrays(net)
    traces = random_traces(rng, net, ra, n_traces=12)
    return net, ra, ref_build_ubodt(ra, delta=2000.0), pa, build_ubodt(pa, delta=2000.0), \
        traces


@pytest.mark.parametrize("seed", [0, 3])
def test_match_many_assoc_equals_reference(seed):
    """The fuzz corpus (half on-road, half random points) through both
    packages' assoc matchers, short and long traces (windows of 32): equal
    under ``_canon``; the port's assoc matcher also wire-identical to its
    scan matcher (the reference's ``test_scan_vs_assoc_kernel_wire_identical``
    on the port)."""
    net, ra, ru, pa, pu, traces = _fuzz_world(seed)
    traces.append(_seam_break_trace(net, W=32, n_pts=96))
    kw = dict(length_buckets=[16, 32])
    ref = RefMatcher(arrays=ra, ubodt=ru, backend="jax",
                     config=RefConfig(viterbi_kernel="assoc", **kw))
    port = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                          config=MatcherConfig(viterbi_kernel="assoc", **kw))
    scan = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu", config=MatcherConfig(**kw))
    assert (ref._kernel_mode, port._kernel_mode, scan._kernel_mode) == \
        ("assoc", "assoc", "scan")
    assert any(len(t["trace"]) > 32 for t in traces)
    got = port.match_many(traces)
    assert [_canon(r) for r in got] == [_canon(r) for r in ref.match_many(traces)]
    assert json.dumps(got) == json.dumps(scan.match_many(traces))


def test_match_many_sparse_assoc_equals_reference(sworld):
    """Sparse cohorts (45-90 s gaps) and dense traces through both
    packages' assoc matchers with the sparse model on, windowed and long."""
    from reporter_tpu_torch.tiles.network import grid_city
    from test_torch_sparse_paths import _corpus

    cfg, ra, ru, _dev, _pdev = sworld
    pa = build_graph_arrays(grid_city(rows=6, cols=6, spacing_m=200.0), cell_size=100.0)
    kw = dict(length_buckets=[16, 32], sparse=True, viterbi_kernel="assoc")
    ref = RefMatcher(arrays=ra, ubodt=ru, backend="jax",
                     config=dataclasses.replace(cfg, **kw))
    port = SegmentMatcher(arrays=pa, ubodt=build_ubodt(pa, delta=3000.0), device="cpu",
                          config=MatcherConfig(**kw))
    traces = _corpus(ra)
    traces.append(dict(traces[2], uuid="long", trace=traces[2]["trace"] * 4))
    t = 0.0
    for p in traces[-1]["trace"]:
        p["time"], t = t, t + 60.0
    got = port.match_many(traces)
    assert [_canon(r) for r in got] == [_canon(r) for r in ref.match_many(traces)]
    assert port.sparse.dispatch.get("ge60", 0) >= 4


def test_scan_and_assoc_part_only_on_ties(sworld):
    """The two forwards are not wire-identical in general: on the sparse
    corpus some traces decode differently, and every backpointer on which
    they part is a tie under the scan's own sums (the two totals within
    two ulps), which the assoc's other rounding order breaks the other
    way.  The reference does the same (ROADMAP.md section 3)."""
    from reporter_tpu_torch.tiles.network import grid_city
    from test_torch_sparse_paths import _corpus

    _cfg, ra, _ru, _dev, _pdev = sworld
    pa = build_graph_arrays(grid_city(rows=6, cols=6, spacing_m=200.0), cell_size=100.0)
    pu = build_ubodt(pa, delta=3000.0)
    ms = {k: SegmentMatcher(arrays=pa, ubodt=pu, device="cpu", config=MatcherConfig(
        length_buckets=[16, 32], sparse=True, viterbi_kernel=k)) for k in ("scan", "assoc")}
    traces = _corpus(ra)
    out = {k: m.match_many(traces) for k, m in ms.items()}
    parted = [i for i, (a, b) in enumerate(zip(out["scan"], out["assoc"])) if a != b]
    assert parted
    m = ms["scan"]
    ties = 0
    for i in parted:
        tr = traces[i]
        p, sp, k = m.sparse.params_for(m.sparse.label_for_trace(tr))
        px, py, tm, valid, _t = m._fill_rows([tr], [0], m._bucket_len(len(tr["trace"])))
        xin = torch.from_numpy(V.pack_inputs(px, py, tm, valid))
        pre = V.precompute_batch_packed(m._dg, m._du, xin, p, k, sp)
        _x, _y, t, v = V.unpack_inputs(xin)
        args = (pre.emis[:, 0], torch.ones(1, dtype=torch.bool), pre.emis, pre.logp,
                pre.gc, v != 0, V.sparse_breakage(p.breakage_distance, sp,
                                                  t[:, 1:] - t[:, :-1]))
        S, BP, _br = V._forward_plain(*args)
        _S, BPa, _bra = V._forward_assoc_plain(*args)
        for tt, j in (BP[0] != BPa[0]).nonzero().tolist():
            a, b = int(BP[0, tt, j]), int(BPa[0, tt, j])
            tot = S[0, tt - 1] + pre.logp[0, tt - 1, :, j]
            assert a >= 0 and b >= 0
            assert (tot[a] - tot[b]).abs() <= 2 * torch.finfo(torch.float32).eps * tot[a].abs()
            ties += 1
    assert ties


@pytest.fixture(scope="module")
def stream_world():
    from reporter_tpu.tiles.network import grid_city as ref_grid_city
    from reporter_tpu_torch.synth import TraceSynthesizer
    from reporter_tpu_torch.tiles.network import grid_city

    ra = ref_build_graph_arrays(ref_grid_city(8, 8, 150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(8, 8, 150.0), cell_size=100.0)
    traces = [s.trace for s in TraceSynthesizer(pa, seed=11).batch(3, 22, dt=5.0,
                                                                      sigma=3.0)]
    return ra, ref_build_ubodt(ra, delta=1500.0), pa, build_ubodt(pa, delta=1500.0), \
        traces


@pytest.mark.parametrize("arena", [False, True])
def test_session_engine_assoc_equals_reference(stream_world, arena):
    """Streams of 4- and 16-point submits (the 16-point ones chain through
    two 16-point session windows when a submit is longer) through both
    packages' ``SessionEngine`` over assoc matchers: answers, records and
    carried beams bit for bit, slab on and off."""
    ra, ru, pa, pu, traces = stream_world
    kw = dict(length_buckets=[16], session_buckets=[4, 16], viterbi_kernel="assoc")
    ref = RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(**kw), backend="jax")
    port = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                          config=MatcherConfig(session_arena=arena, **kw))
    for step in (4, 22):
        ref_eng = RefEngine(ref, RefStore(), tail_points=512)
        eng = SessionEngine(port, SessionStore(), tail_points=512)
        want, got = _stream(ref_eng, traces, step), _stream(eng, traces, step)
        assert [g["segments"] for g in got] == [w["segments"] for w in want]
        for t in traces:
            s, r = eng.store.peek(t["uuid"]), ref_eng.store.peek(t["uuid"])
            assert s.records == r.records
            assert _carry_bytes(s.carry) == _carry_bytes(r.carry)
        if arena:
            for t in traces:
                port.session_arena.free_uuid(t["uuid"])


# -- the selection ---------------------------------------------------------------

def _small():
    net, ra, ru, pa, pu = scenario(3)
    return pa, pu


def test_kernel_for_under_auto_and_env_precedence(monkeypatch):
    pa, pu = _small()
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(viterbi_kernel="auto",
                                            viterbi_assoc_threshold=64))
    assert m._kernel_mode == "auto"
    assert [m._kernel_for(T) for T in (4, 63, 64, 256)] == \
        ["scan", "scan", "assoc", "assoc"]
    assert SegmentMatcher(arrays=pa, ubodt=pu, device="cpu")._kernel_mode == "scan"
    assert MatcherConfig.from_dict({"viterbi_kernel": "assoc"}).viterbi_kernel == "assoc"
    monkeypatch.setenv("REPORTER_VITERBI", "Assoc")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(viterbi_kernel="scan"))
    assert m._kernel_mode == "assoc" and m._kernel_for(4) == "assoc"
    # the reference reads the variable the same way
    ref = RefMatcher(arrays=scenario(3)[1], ubodt=scenario(3)[2], backend="jax",
                     config=RefConfig(viterbi_kernel="scan"))
    assert ref._kernel_mode == m._kernel_mode


@pytest.mark.parametrize("where", ["env", "config"])
def test_bad_kernel_value_raises(monkeypatch, where):
    pa, pu = _small()
    cfg = MatcherConfig()
    if where == "env":
        monkeypatch.setenv("REPORTER_VITERBI", "pallas")
    else:
        cfg = MatcherConfig(viterbi_kernel="pallas")
    with pytest.raises(ValueError, match="scan\\|assoc\\|auto"):
        SegmentMatcher(arrays=pa, ubodt=pu, device="cpu", config=cfg)


def test_auto_dispatches_per_bucket(monkeypatch):
    """Under "auto" the bucketed dispatch passes each bucket's forward:
    below the threshold the scan, at it the assoc forward."""
    pa, pu = _small()
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(viterbi_kernel="auto", length_buckets=[8, 16],
                                            viterbi_assoc_threshold=16))
    seen = []

    def spy(*a):
        seen.append((a[0].shape[1], a[9]))  # (T, kernel)
        return V.viterbi_scan(*a)

    monkeypatch.setattr(V, "_KERNELS", V._KERNELS._replace(scan=spy))
    net, ra, ru, _pa, _pu = scenario(3)
    traces = random_traces(np.random.default_rng(3), net, ra, 4, n_pts=16)
    traces[0]["trace"] = traces[0]["trace"][:6]
    m.match_many(traces)
    assert sorted(seen) == [(8, "scan"), (16, "assoc")]


def test_health_reports_the_forward(monkeypatch):
    pa, pu = _small()
    monkeypatch.setenv("REPORTER_VITERBI", "auto")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu")
    service = ReporterService(m, max_batch=8, max_wait_ms=1)
    server = service.make_server("127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d/health"
                                    % server.server_address[1], timeout=30) as r:
            body = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        th.join(10)
    assert body["viterbi_kernel"] == "auto"
