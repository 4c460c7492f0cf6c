"""The port's columnar host packer (``matching/columnar.py``) on the CPU:
``TraceColumns.pack`` through ``_fill_rows`` equal to the port's legacy
per-row loop and to the JAX package's ``columnar.TraceColumns.pack`` bit
for bit (every row, a subset in another order, a zero-length trace, the
binary wire's ``"_columns"`` side channel); ``PackedTimes`` as a list of
lists and ``fill_abs`` against the row loop; ``match_many`` with
``host_pack`` on and off equal to each other and to the JAX matcher's
(scan and assoc, wide32, the sparse model, the long path, the session
path); ``$REPORTER_HOST_PACK`` over the config."""

import json

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching import columnar as ref_columnar
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import (
    MatcherConfig, SegmentMatcher, SessionEngine, SessionStore, columnar,
)
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from test_fuzz_differential import _canon

MO = {"mode": "auto", "report_levels": [0, 1], "transition_levels": [0, 1]}


@pytest.fixture(autouse=True)
def _no_ambient_knobs(monkeypatch):
    """Each matcher reads these when it is built; both sides of every
    differential start from the library defaults (``test_env_knob``
    sets $REPORTER_HOST_PACK on top)."""
    for var in ("REPORTER_HOST_PACK", "REPORTER_LONG_PRECOMPUTE", "REPORTER_SPARSE",
                "REPORTER_CALIBRATION", "REPORTER_VITERBI", "REPORTER_UBODT_LAYOUT",
                "REPORTER_PROBE_DEDUP", "REPORTER_QUALITY_AUX", "REPORTER_INTERPOLATE"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def world():
    """The 6 x 6 grid of 150 m in both packages."""
    ra = ref_build_graph_arrays(ref_grid_city(rows=6, cols=6, spacing_m=150.0),
                                cell_size=100.0)
    pa = build_graph_arrays(grid_city(rows=6, cols=6, spacing_m=150.0), cell_size=100.0)
    return ra, ref_build_ubodt(ra, delta=1500.0), pa, build_ubodt(pa, delta=1500.0)


@pytest.fixture(scope="module")
def matcher(world):
    _ra, _ru, pa, pu = world
    return SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                          config=MatcherConfig(length_buckets=[16, 64]))


def _traces(arrays, b, t, seed=7, dt=5.0):
    synth = TraceSynthesizer(arrays, seed=seed)
    return [s.trace for s in synth.batch(b, t, dt=dt, sigma=3.0)]


def _varied_traces(arrays, seed=3, dt=5.0):
    """Ragged lengths 1-16 and int, float and mixed time columns."""
    synth = TraceSynthesizer(arrays, seed=seed)
    out = []
    for i, n in enumerate([1, 2, 5, 16, 9, 3, 12, 7]):
        tr = synth.synthesize(n_points=n, uuid="veh-%d" % i, dt=dt).trace
        for j, p in enumerate(tr["trace"]):
            if i % 3 == 0 or (i % 3 == 1 and j % 2 == 0):
                p["time"] = int(p["time"])
        out.append(tr)
    return out


def _with_columns(traces, every=2):
    """Copies of ``traces``, every ``every``-th (from the second) carrying
    the binary wire's float64 "_columns"."""
    out = []
    for i, tr in enumerate(traces):
        tr = dict(tr)
        if i % every == every - 1:
            tr["_columns"] = {f: np.array([float(p[f]) for p in tr["trace"]], np.float64)
                              for f in ("lat", "lon", "time")}
        out.append(tr)
    return out


def _same_packs(a, b):
    for x, y, name in zip(a[:4], b[:4], ("px", "py", "tm", "valid")):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name
    assert len(a[4]) == len(b[4])
    for r in range(len(a[4])):
        assert list(a[4][r]) == list(b[4][r])


@pytest.mark.parametrize("idxs", ["all", [5, 1, 6], "reversed", [3]])
def test_pack_equals_legacy_and_reference(world, matcher, idxs):
    """One scatter a column equals the per-row loop and the JAX package's
    packer, times included, on every row and on subsets in any order."""
    ra = world[0]
    traces = _varied_traces(matcher.arrays)
    n = len(traces)
    if isinstance(idxs, str):
        idxs = list(range(n)) if idxs == "all" else list(range(n))[::-1]
    cols = columnar.extract_columns(traces)
    got = matcher._fill_rows(traces, idxs, 16, cols)
    assert isinstance(got[4], columnar.PackedTimes)
    _same_packs(got, matcher._fill_rows(traces, idxs, 16))
    _same_packs(got, ref_columnar.extract_columns(traces).pack(ra.proj, idxs, 16))


def test_zero_length_trace_packs_an_empty_row(matcher):
    traces = _varied_traces(matcher.arrays)
    traces.insert(2, {"uuid": "empty", "trace": []})
    cols = columnar.extract_columns(traces)
    px, py, tm, valid, times = matcher._fill_rows(traces, list(range(len(traces))), 16,
                                                  cols)
    assert not valid[2].any() and times[2] == []
    rest = [i for i in range(len(traces)) if i != 2]
    legacy = matcher._fill_rows(traces, rest, 16)
    for got, want in zip((px, py, tm, valid), legacy[:4]):
        assert np.delete(got, 2, axis=0).tobytes() == want.tobytes()


def test_side_channel_packs_as_the_dict_walk(world, matcher):
    """Traces carrying "_columns" pack as their dict-walked twins, are
    counted as taken from the side channel, and pack as the JAX package
    packs them."""
    ra = world[0]
    traces = _varied_traces(matcher.arrays)
    with_cols = _with_columns(traces)
    before = dict(columnar.COUNTS)
    a = columnar.extract_columns(traces)
    b = columnar.extract_columns(with_cols)
    assert columnar.COUNTS["side_channel"] - before["side_channel"] == len(traces) // 2
    assert columnar.COUNTS["walked"] - before["walked"] == len(traces) + len(traces) // 2
    for name in ("lens", "lat", "lon", "time"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes(), name
    idxs = list(range(len(traces)))
    got = matcher._fill_rows(with_cols, idxs, 16, b)
    _same_packs(got, matcher._fill_rows(traces, idxs, 16, a))
    _same_packs(got, ref_columnar.extract_columns(with_cols).pack(ra.proj, idxs, 16))


def test_packed_times_is_a_list_of_lists():
    pt = columnar.PackedTimes(np.array([1.0, 2.0, 3.0, 10.0, 20.0]),
                              np.array([3, 0, 2], np.int64), np.array([0, 3, 3], np.int64))
    assert len(pt) == 3
    assert (pt[0], pt[1], pt[2]) == ([1.0, 2.0, 3.0], [], [10.0, 20.0])


def test_fill_abs_equals_the_row_loop():
    rng = np.random.default_rng(5)
    lens = np.array([4, 0, 7, 1], np.int64)
    flat = rng.uniform(1e9, 2e9, int(lens.sum()))
    offs = np.cumsum(lens) - lens
    pt = columnar.PackedTimes(flat, lens, offs)
    vec, n_vec = np.zeros((4, 8)), np.zeros(4, np.int32)
    pt.fill_abs(vec, n_vec)
    ref, n_ref = np.zeros((4, 8)), np.zeros(4, np.int32)
    for r in range(4):
        ref[r, :len(pt[r])] = pt[r]
        n_ref[r] = len(pt[r])
    assert vec.tobytes() == ref.tobytes() and np.array_equal(n_vec, n_ref)
    rv, rn = np.zeros((4, 8)), np.zeros(4, np.int32)
    ref_columnar.PackedTimes(flat, lens, offs).fill_abs(rv, rn)
    assert vec.tobytes() == rv.tobytes() and np.array_equal(n_vec, rn)


def _wire(results):
    return json.dumps(results, sort_keys=True)


def _three(world, traces, ubodt=None, ref_ubodt=None, **kw):
    """host_pack on, host_pack off and the JAX matcher (host_pack on) over
    ``traces``: the two port answers are equal, and equal the
    reference's."""
    ra, ru, pa, pu = world
    outs = []
    for hp in (True, False):
        m = SegmentMatcher(arrays=pa, ubodt=ubodt or pu, device="cpu",
                           config=MatcherConfig(host_pack=hp, **kw))
        assert m._host_pack is hp
        outs.append(m.match_many(traces))
    assert _wire(outs[0]) == _wire(outs[1])
    ref = RefMatcher(arrays=ra, ubodt=ref_ubodt or ru, backend="jax",
                     config=RefConfig(host_pack=True, **kw))
    assert [_canon(r) for r in outs[0]] == [_canon(r) for r in ref.match_many(traces)]
    return outs[0]


@pytest.mark.parametrize("kernel", ["scan", "assoc"])
def test_match_many_host_pack_on_off_and_reference(world, kernel):
    traces = _varied_traces(world[2]) + _traces(world[2], 4, 40, seed=13)
    for tr in traces:
        tr["match_options"] = MO
    _three(world, _with_columns(traces, 3), length_buckets=[16, 64], viterbi_kernel=kernel)


def test_wide32_host_pack_on_off_and_reference(world):
    ra, _ru, pa, _pu = world
    _three(world, _varied_traces(pa, seed=9),
           ubodt=build_ubodt(pa, delta=1500.0, layout="wide32"),
           ref_ubodt=ref_build_ubodt(ra, delta=1500.0, layout="wide32"),
           length_buckets=[16], ubodt_layout="wide32")


def test_sparse_host_pack_on_off_and_reference(world):
    """dt 45 s puts the cohort over sparse_gap_s: the sparse programs see
    the same packed batches either way."""
    _three(world, _traces(world[2], 6, 12, seed=21, dt=45.0), length_buckets=[16],
           sparse=True)


def test_long_path_host_pack_on_off_and_reference(world):
    """Traces past the top bucket pack their long groups through the same
    columns as the bucketed ones."""
    traces = _varied_traces(world[2]) + _traces(world[2], 2, 80, seed=17)
    _three(world, _with_columns(traces), length_buckets=[16])


def test_session_path_host_pack_on_off_and_reference(world):
    """Streaming steps of 4 points and one 12-point step past the top
    session bucket (8, so it chains): the session batch packs from one
    extract with key "points", rebased on each session's t0."""
    ra, ru, pa, pu = world
    outs = []
    streams = _traces(pa, 3, 12, seed=31)
    for make in ([lambda hp=hp: SessionEngine(
            SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                           config=MatcherConfig(host_pack=hp, length_buckets=[16],
                                                session_buckets=[4, 8])),
            SessionStore(), tail_points=256) for hp in (True, False)]
                 + [lambda: RefEngine(RefMatcher(
                     arrays=ra, ubodt=ru, backend="jax",
                     config=RefConfig(length_buckets=[16], session_buckets=[4, 8])),
                     RefStore(), tail_points=256)]):
        eng = make()
        results = []
        for j, w in ((0, 4), (4, 4), (8, 4)):
            results.extend(eng.match_many([
                {"uuid": tr["uuid"], "trace": tr["trace"][j:j + w], "match_options": MO}
                for tr in streams]))
        results.extend(eng.match_many([{"uuid": "wide", "trace": streams[0]["trace"],
                                        "match_options": MO}]))
        for r in results:  # a wall-clock field, not part of the contract
            (r.get("_stream") or {}).get("session", {}).pop("age_s", None)
        outs.append(results)
    assert _wire(outs[0]) == _wire(outs[1])
    assert [_canon(r) for r in outs[0]] == [_canon(r) for r in outs[2]]


def test_env_knob_overrides_config(world, monkeypatch):
    _ra, _ru, pa, pu = world
    monkeypatch.setenv("REPORTER_HOST_PACK", "0")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(length_buckets=[16]))
    assert m._host_pack is False
    monkeypatch.setenv("REPORTER_HOST_PACK", "1")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(host_pack=False, length_buckets=[16]))
    assert m._host_pack is True
    traces = _varied_traces(pa)
    before = columnar.COUNTS["walked"]
    m.match_many(traces)
    assert columnar.COUNTS["walked"] - before == len(traces)
