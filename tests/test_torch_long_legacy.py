"""The legacy long-trace program on the port (``long_precompute=False``:
``match_batch_carry_packed``, kernels 1-3 and the chain kernel once a
window) on the CPU: wire-identical to the hoisted path under scan and
assoc over fuzzed networks and traces with a break exactly on a seam
(seeds 7, 19, 43, 61), the compact arrays equal at every column, the
seams included; equal to the JAX package's ``long_precompute=False``
matcher; ``$REPORTER_LONG_PRECOMPUTE=0`` dispatching only the per-window
program and ``warmup`` counting its shapes by the knob; and a dp 2 mesh
on CPU ranks."""

import json

import numpy as np
import pytest
import torch

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.matching import matcher as port_matcher
from reporter_tpu_torch.ops import viterbi as V
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from test_fuzz_differential import _canon, _seam_break_trace, random_network, random_traces
from test_torch_builders import to_port_network

LONG_BUCKETS = [16, 32]  # W = 32: 72-96-point traces stream 3 windows


@pytest.fixture(autouse=True)
def _no_ambient_knobs(monkeypatch):
    """The matchers read these when they are built; the two sides of each
    differential must differ only in long_precompute."""
    for var in ("REPORTER_VITERBI", "REPORTER_LONG_PRECOMPUTE", "REPORTER_HOST_PACK",
                "REPORTER_SPARSE", "REPORTER_QUALITY_AUX", "REPORTER_PROBE_DEDUP",
                "REPORTER_UBODT_LAYOUT", "REPORTER_DEVICES", "REPORTER_GRAPH_DEVICES"):
        monkeypatch.delenv(var, raising=False)


def _world(seed, n_traces=9):
    """(reference net, port arrays, port table, traces): the fuzz network of
    ``seed``, ``n_traces`` fuzzed long traces and the seam-break trace."""
    rng = np.random.default_rng(seed)
    net = random_network(rng)
    pa = build_graph_arrays(to_port_network(net))
    traces = random_traces(rng, net, None, n_traces=n_traces,
                           n_pts=int(rng.integers(72, 97)))
    traces.append(_seam_break_trace(net))
    return net, pa, build_ubodt(pa, delta=2000.0), traces


def _pair(pa, pu, kernel):
    """(hoisted, legacy) port matchers differing only in long_precompute."""
    hoisted, legacy = (SegmentMatcher(
        arrays=pa, ubodt=pu, device="cpu",
        config=MatcherConfig(viterbi_kernel=kernel, length_buckets=list(LONG_BUCKETS),
                             long_precompute=pre)) for pre in (True, False))
    assert hoisted._long_pre and not legacy._long_pre
    return hoisted, legacy


@pytest.mark.parametrize("seed,kernel", [(7, "scan"), (19, "assoc"), (43, "scan"),
                                         (61, "assoc")])
def test_legacy_wire_equals_hoisted(seed, kernel):
    _net, pa, pu, traces = _world(seed)
    hoisted, legacy = _pair(pa, pu, kernel)
    out_h, out_l = hoisted.match_many(traces), legacy.match_many(traces)
    for i, (h, l) in enumerate(zip(out_h, out_l)):
        assert h == l, "seed %d %s trace %d:\n%s\nvs\n%s" % (
            seed, kernel, i, json.dumps(h)[:400], json.dumps(l)[:400])
    kinds = {k[0] for k in hoisted._compiled_shapes}
    assert {"pre", "chain"} <= kinds and "carry" not in kinds
    kinds = {k[0] for k in legacy._compiled_shapes}
    assert "carry" in kinds and not kinds & {"pre", "chain"}


@pytest.mark.parametrize("kernel", ["scan", "assoc"])
def test_legacy_compact_equals_hoisted_at_every_seam(kernel):
    """The raw (edge, offset bits, breaks) of one long group equal between
    the two programs at every column, the seam columns included, and the
    seam-break trace breaks exactly at column W in both."""
    rng = np.random.default_rng(23)
    net = random_network(rng)
    pa = build_graph_arrays(to_port_network(net))
    pu = build_ubodt(pa, delta=2000.0)
    W = LONG_BUCKETS[-1]
    traces = random_traces(rng, net, None, n_traces=5, n_pts=80)
    traces.append(_seam_break_trace(net, W=W, n_pts=96))
    idxs = list(range(len(traces)))
    got = {}
    for name, m in zip(("hoisted", "legacy"), _pair(pa, pu, kernel)):
        (h,) = m._dispatch_long(traces, idxs)
        group, (edge, offset, breaks), _times, aux = m._fetch_long_aux(h)
        assert sorted(group) == idxs
        assert (aux is None) == (name == "legacy")
        got[name] = (group, edge, offset.view(np.int32), breaks)
    assert got["hoisted"][0] == got["legacy"][0]
    for f in (1, 2, 3):
        np.testing.assert_array_equal(got["hoisted"][f], got["legacy"][f])
    for c in range(W, got["legacy"][1].shape[1], W):  # each seam column
        for f in (1, 2, 3):
            np.testing.assert_array_equal(got["hoisted"][f][:, c], got["legacy"][f][:, c])
    group, _e, _o, breaks = got["legacy"]
    assert breaks[group.index(len(traces) - 1), W]


@pytest.mark.parametrize("seed,kernel", [(7, "scan"), (19, "assoc")])
def test_legacy_equals_reference_legacy(seed, kernel):
    """The port's per-window program answers as the JAX package's
    ``long_precompute=False`` matcher, the quality block included (no
    margins: the legacy program has no aux)."""
    net, pa, pu, traces = _world(seed, n_traces=5)
    ra = ref_build_graph_arrays(net)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=2000.0), backend="jax",
                     config=RefConfig(viterbi_kernel=kernel, quality_aux=True,
                                      length_buckets=list(LONG_BUCKETS),
                                      long_precompute=False))
    port = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                          config=MatcherConfig(viterbi_kernel=kernel, quality_aux=True,
                                               length_buckets=list(LONG_BUCKETS),
                                               long_precompute=False))
    want, got = ref.match_many(traces), port.match_many(traces)
    qw = [r.pop("_quality") for r in want]
    qg = [r.pop("_quality") for r in got]
    assert [_canon(r) for r in got] == [_canon(r) for r in want]
    assert qg == qw and all("margin_min" not in q for q in qg)


def test_env_knob_dispatches_only_the_window_program(monkeypatch):
    """$REPORTER_LONG_PRECOMPUTE=0 over the config: a long trace runs the
    per-window program once a window, counted as ("long", "carry"), and
    never the pre or chain dispatch; warmup counts one long shape, not
    two."""
    _net, pa, pu, traces = _world(7, n_traces=1)
    monkeypatch.setenv("REPORTER_LONG_PRECOMPUTE", "0")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(length_buckets=list(LONG_BUCKETS),
                                            long_precompute=True))
    assert not m._long_pre
    fam = port_matcher.C_DISPATCH_COHORT
    before = {k: fam.labels("long", k).value for k in ("carry", "pre", "chain")}
    tr = dict(traces[0], trace=traces[0]["trace"][:80])  # 3 windows of 32
    assert m.match_many([tr])[0]["segments"] is not None
    after = {k: fam.labels("long", k).value for k in ("carry", "pre", "chain")}
    assert {k: after[k] - before[k] for k in after} == {"carry": 3, "pre": 0, "chain": 0}
    assert {k[0] for k in m._compiled_shapes} == {"carry"}
    warm = port_matcher.C_WARM_SHAPES
    w0 = {k: warm.labels(k).value for k in ("scan", "none")}
    m.warmup(lengths=[], carry_chain=True)
    assert {k: warm.labels(k).value - w0[k] for k in w0} == {"scan": 1, "none": 0}
    monkeypatch.setenv("REPORTER_LONG_PRECOMPUTE", "1")
    h = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(length_buckets=list(LONG_BUCKETS),
                                            long_precompute=False))
    assert h._long_pre
    w0 = {k: warm.labels(k).value for k in ("scan", "none")}
    h.warmup(lengths=[], carry_chain=True)
    assert {k: warm.labels(k).value - w0[k] for k in w0} == {"scan": 1, "none": 1}


def test_carry_program_equals_its_plain_version():
    """``match_batch_carry_packed`` (the wrappers: plain versions on CPU
    tensors) and its ``_plain`` twin over two chained windows: packed and
    carry bit for bit."""
    _net, pa, pu, traces = _world(43, n_traces=3)
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(length_buckets=list(LONG_BUCKETS)))
    W = LONG_BUCKETS[-1]
    traces = [dict(t, trace=t["trace"][:2 * W]) for t in traces]
    px, py, tm, valid, _t = m._fill_rows(traces, list(range(4)), 2 * W)
    xin = V.pack_inputs(px, py, tm, valid)
    ca = cb = V.initial_carry_batch(4, m.cfg.beam_k)
    for c in range(2):
        x = torch.from_numpy(np.ascontiguousarray(xin[:, :, c * W:(c + 1) * W]))
        pa_, ca = V.match_batch_carry_packed(m._dg, m._du, x, m._params, m.cfg.beam_k, ca)
        pb_, cb = V.match_batch_carry_packed_plain(m._dg, m._du, x, m._params,
                                                   m.cfg.beam_k, cb)
        assert torch.equal(pa_, pb_)
        assert all(torch.equal(a, b) for a, b in zip(ca, cb))


@pytest.mark.parametrize("kernel", ["scan", "assoc"])
def test_dp2_mesh_legacy_equals_one_device(kernel):
    """On a dp 2 mesh of CPU ranks each rank runs the per-window program
    over its block of rows; the answers are one device's."""
    _net, pa, pu, traces = _world(61, n_traces=5)
    one = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                         config=MatcherConfig(viterbi_kernel=kernel, long_precompute=False,
                                              length_buckets=list(LONG_BUCKETS)))
    mesh = SegmentMatcher(arrays=pa, ubodt=pu, device=["cpu"] * 2,
                          config=MatcherConfig(viterbi_kernel=kernel, long_precompute=False,
                                               length_buckets=list(LONG_BUCKETS), devices=2))
    assert mesh._n_dp == 2 and not mesh._long_pre
    assert mesh.match_many(traces) == one.match_many(traces)
    assert {k[0] for k in mesh._compiled_shapes} == {"carry"}
