"""Long traces on the port's matcher (the windowed carry chain: kernels
1-3 hoisted over a group's windows, kernel 5 chaining the beam) against the
JAX matcher: ``_canon(match_many)`` equal, on mixed short and long traces,
the seam-break trace, a per-request parameter group, several trace groups
and deferred-fetch waves; the quality aux within rtol 1e-4."""

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.matching import matcher as port_matcher
from test_fuzz_differential import _canon, _seam_break_trace, random_traces
from test_torch_builders import scenario

LONG_BUCKETS = [16, 32]  # W = 32 windows


def _corpus(seed):
    net, ra, ru, pa, pu = scenario(seed)
    traces = random_traces(np.random.default_rng(seed), net, ra, 8, n_pts=100)
    for tr, n in zip(traces, (100, 10, 33, 64, 30, 97, 65, 100)):
        tr["trace"] = tr["trace"][:n]
    traces[3]["match_options"]["sigma_z"] = 7.0  # a long trace in its own params group
    traces.append(_seam_break_trace(net, W=32, n_pts=96))
    return ra, ru, pa, pu, traces


def _split_quality(results):
    return [r.pop("_quality", None) for r in results]


@pytest.mark.parametrize("seed", [7, 43])
def test_long_traces_equal_jax(seed):
    ra, ru, pa, pu, traces = _corpus(seed)
    ref = RefMatcher(arrays=ra, ubodt=ru, backend="jax",
                     config=RefConfig(length_buckets=LONG_BUCKETS, quality_aux=True))
    port = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                          config=MatcherConfig(length_buckets=LONG_BUCKETS, quality_aux=True))
    want = ref.match_many(traces)
    got = port.match_many(traces)
    qw, qg = _split_quality(want), _split_quality(got)
    assert [_canon(r) for r in got] == [_canon(r) for r in want]
    for a, b in zip(qg, qw):
        assert {k: a[k] for k in ("edge", "n_points", "breaks")} == \
            {k: b[k] for k in ("edge", "n_points", "breaks")}
        for k in ("margin_min", "margin_mean", "pool_exhausted_frac"):
            assert (a[k] is None) == (b[k] is None), k
            if b[k] is not None:
                assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-3), k
    seam = got[-1]["segments"]
    assert seam and qg[-1]["breaks"] >= 1  # the teleport at the first seam


def test_long_groups_waves_and_deferred_fetch(monkeypatch):
    """A device cap of 4 rows splits the long traces into three groups
    (the third queued after the first's outputs are fetched), one window
    per pre dispatch for full groups and a ladder-padded pre wave for the
    last, single-trace group; at most 2 windows wait on the device before a
    fetch.  The records equal the JAX matcher's."""
    ra, ru, pa, pu, traces = _corpus(19)
    traces = [t for t in traces if len(t["trace"]) > 32]
    traces += [dict(t, uuid=t["uuid"] + "b") for t in traces[:2]]
    assert len(traces) == 9
    monkeypatch.setattr(port_matcher, "MAX_DEFERRED_CHUNKS", 2)
    port = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                          config=MatcherConfig(length_buckets=LONG_BUCKETS,
                                               max_device_points=4 * 32))
    handles = port._dispatch_long(traces, list(range(9)))
    assert [len(h[0]) for h in handles] == [4, 4, 1]
    assert handles[0][2] is None and handles[1][2] is not None  # group 0 fetched
    assert handles[1][1]  # a full wave fetched during dispatch
    ref = RefMatcher(arrays=ra, ubodt=ru, backend="jax",
                     config=RefConfig(length_buckets=LONG_BUCKETS))
    for h in handles:
        group, (edge, offset, breaks), _times, _aux = port._fetch_long_aux(h)
        for row, i in enumerate(group):
            n = len(traces[i]["trace"])
            rh = ref._dispatch_long(traces, [i])
            _g, (re, ro, rb), _t = ref._fetch_long(rh[0])
            assert np.array_equal(edge[row, :n], re[0, :n]), i
            assert offset[row, :n].tobytes() == ro[0, :n].tobytes(), i
            assert np.array_equal(breaks[row, :n], rb[0, :n]), i
    got = port.match_many(traces)
    want = ref.match_many(traces)
    assert [_canon(r) for r in got] == [_canon(r) for r in want]
