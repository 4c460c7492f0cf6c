"""The port's UBODT memory system against the JAX package: the wide32
table layout (builders, relayout, host lookup), the plain and
deduplicated probes in both layouts (kernel 2's and the dedup kernels'
plain versions on the CPU), the distinct pair count, the probe-outcome
diagnostic, and whole matchers in the four {cuckoo, wide32} x {dedup off,
on} combinations, sparse cohorts and sessions included.  Every comparison
is bit for bit (tables, probe outputs, counts and wire records)."""

import functools

import jax
import numpy as np
import pytest
import torch

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.ops.diagnostics import ubodt_probe_stats as ref_probe_stats
from reporter_tpu.ops.hashtable import count_distinct_pairs as ref_count_distinct
from reporter_tpu.ops.hashtable import ubodt_lookup as ref_lookup
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu.tiles.ubodt import ubodt_from_columns as ref_from_columns
from reporter_tpu_torch import convert
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher, SessionEngine, SessionStore
from reporter_tpu_torch.matching.arena import carry_host
from reporter_tpu_torch.native import get_lib
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.ops.diagnostics import ubodt_probe_stats, ubodt_probe_stats_plain
from reporter_tpu_torch.ops.viterbi import pack_inputs
from reporter_tpu_torch.tiles.ubodt import build_ubodt, ubodt_from_columns
from test_fuzz_differential import _canon, _seam_break_trace, random_traces
from test_torch_builders import scenario

_ref_lookup = jax.jit(ref_lookup, static_argnames=("dedup",))
_ref_count = jax.jit(ref_count_distinct)
_ref_stats = jax.jit(ref_probe_stats, static_argnums=(4, 5))
COMBOS = [("cuckoo", False), ("cuckoo", True), ("wide32", False), ("wide32", True)]
LONG_BUCKETS = [16, 32]  # W = 32 windows


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Every matcher reads these when it is built; start from the library
    defaults."""
    for var in ("REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP", "REPORTER_OBS_PROBE_EVERY",
                "REPORTER_SPARSE", "REPORTER_CALIBRATION", "REPORTER_SESSION_ARENA"):
        monkeypatch.delenv(var, raising=False)


def _columns(rng, n):
    keys = rng.choice(10_000_000, size=(n, 2), replace=False)
    return (keys[:, 0].astype(np.int32), keys[:, 1].astype(np.int32),
            (rng.random(n) * 1000).astype(np.float32), (rng.random(n) * 100).astype(np.float32),
            rng.integers(0, 1 << 20, n).astype(np.int32))


@pytest.mark.parametrize("native", [True, False])
def test_wide32_tables_equal_reference(native):
    """ubodt_from_columns(layout="wide32") (native and Python packers) and
    build_ubodt(layout="wide32") give the reference's bytes."""
    cols = _columns(np.random.default_rng(5), 3000)
    want = ref_from_columns(*cols, delta=1000.0, layout="wide32")
    got = ubodt_from_columns(*cols, 1000.0, lib=get_lib() if native else None,
                             layout="wide32")
    assert got.packed.shape == want.packed.shape == (512, 32, 8)
    assert got.packed.tobytes() == want.packed.tobytes()
    assert (got.bmask, got.num_rows, got.max_kicks, got.bucket_entries) == (
        want.bmask, want.num_rows, 0, 32)
    _net, ra, _ru, pa, _pu = scenario(19)
    g = build_ubodt(pa, delta=1500.0, layout="wide32", use_native=native)
    assert g.packed.tobytes() == ref_build_ubodt(ra, delta=1500.0, layout="wide32").packed.tobytes()


def test_relayout_round_trip_and_host_lookup():
    """relayout repacks without a graph search into the reference's bytes;
    the host lookup (and the path walk on it) answers the same in both
    layouts, misses included."""
    _net, ra, ru, pa, pu = scenario(43)
    pw = pu.relayout("wide32")
    assert pw.layout == "wide32" and pu.relayout("cuckoo") is pu
    assert pw.packed.tobytes() == ru.relayout("wide32").packed.tobytes()
    back = pw.relayout("cuckoo")
    assert back.packed.tobytes() == ru.relayout("wide32").relayout("cuckoo").packed.tobytes()
    src, dst = pu.rows()[:2]
    for i in range(0, len(src), max(1, len(src) // 60)):
        s, d = int(src[i]), int(dst[i])
        assert pw.lookup(s, d) == back.lookup(s, d) == pu.lookup(s, d) == ru.lookup(s, d)
        assert pw.path_edges(s, d) == pu.path_edges(s, d)
    assert pw.lookup(int(src[0]), -5) == (float("inf"), -1)


def _key_sets():
    """(name, src, dst): duplicate-heavy with misses (the dispatch's
    usual shape), all distinct (forces the fallback), and under 1024."""
    rng = np.random.default_rng(11)
    cols = _columns(rng, 4000)
    src, dst = cols[:2]
    pick = rng.integers(0, 300, 3000)
    dup = (np.concatenate([src[pick], rng.integers(-2, 1 << 24, 1000)]),
           np.concatenate([dst[pick], rng.integers(-2, 1 << 24, 1000)]))
    dup[0][:7], dup[1][:7] = -1, -1  # the key equal to the dedup set's empty marker
    far = src + 10_000_001  # absent keys: beyond every table key
    return {"duplicates": dup,
            "all_distinct": (np.concatenate([src, far[:500]]), np.concatenate([dst, dst[:500]])),
            "small": (np.concatenate([src[:600], far[:300]]), dst[:900])}, cols


@pytest.mark.parametrize("layout", ["cuckoo", "wide32"])
@pytest.mark.parametrize("keys", ["duplicates", "all_distinct", "small"])
def test_probe_and_dedup_equal_reference(layout, keys):
    sets, cols = _key_sets()
    s, d = (np.ascontiguousarray(a, np.int32) for a in sets[keys])
    ru = ref_from_columns(*cols, delta=1000.0, layout=layout)
    du = convert.ubodt_from_numpy(ru.packed, ru.bmask, layout)
    ts, td = torch.from_numpy(s), torch.from_numpy(d)
    want = [np.asarray(x) for x in _ref_lookup(ru.to_device(), s, d, dedup=False)]
    assert np.isfinite(want[0]).any() and not np.isfinite(want[0]).all()
    for dedup in (False, True):
        ref = _ref_lookup(ru.to_device(), s, d, dedup=dedup)
        assert all(np.asarray(r).tobytes() == w.tobytes() for r, w in zip(ref, want))
        got = H.ubodt_lookup(du, ts, td, dedup=dedup)
        for g, w in zip(got, want):
            assert g.numpy().dtype == w.dtype and g.numpy().tobytes() == w.tobytes()
    r = H.ubodt_lookup_dedup_plain(du, ts, td)
    n_ref = int(_ref_count(s, d, np.ones(len(s), bool)))
    # called directly the dedup probe runs below 1024 pairs too (the
    # wrapper's gate is tested with DEDUP below); m as the reference sizes it
    assert r.m == max(512, len(s) // 2) and int(r.n_unique[0]) == n_ref
    assert (n_ref > r.m) == (keys != "duplicates")  # the reference's cond
    assert all(g.numpy().tobytes() == w.tobytes() for g, w in zip(r[:3], want))
    # node ids are never negative: the reference marks invalid positions
    # with the key (-1, -1), which a valid (-1, -1) would merge with
    valid = (np.arange(len(s)) % 3 != 0) & ((s != -1) | (d != -1))
    assert int(H.count_distinct_pairs(ts, td, torch.from_numpy(valid))) == \
        int(_ref_count(s, d, valid))


def test_dedup_stats_are_read_at_collect():
    """The wrapper records each deduplicated probe's distinct count and
    reads it back only at harvest; fallbacks are counted."""
    sets, cols = _key_sets()
    du = convert.ubodt_from_numpy(ref_from_columns(*cols, delta=1000.0).packed,
                                  ref_from_columns(*cols, delta=1000.0).bmask)
    H.DEDUP.reset()
    for name in ("duplicates", "all_distinct", "small"):
        s, d = (torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in sets[name])
        H.ubodt_lookup(du, s, d, dedup=True)
    assert len(H.DEDUP._pending) == 2 and H.DEDUP.probes == 0  # 900 pairs: plain
    summ = H.DEDUP.summary()
    assert summ["probes"] == 2 and summ["dedup_fallbacks"] == 1
    assert summ["pairs"] == 8500 and summ["last"] == (4500, 2250, 4500)


def _xin(pa, traces, T):
    m = SegmentMatcher(arrays=pa, ubodt=build_ubodt(pa, delta=1500.0), device="cpu")
    px, py, tm, valid, _t = m._fill_rows(traces, list(range(len(traces))), T)
    return pack_inputs(px, py, tm, valid), m


@pytest.mark.parametrize("delta", [1500.0, 40.0])
def test_probe_stats_equal_reference(delta):
    """int32 [5] (pairs, misses, costly misses, beyond delta, distinct)
    on a fuzz network, with the table's delta and a tiny one (beyond-delta
    misses present), both layouts."""
    net, ra, ru, pa, pu = scenario(7)
    traces = random_traces(np.random.default_rng(3), net, ra, 8, n_pts=24)
    xin, m = _xin(pa, traces, 32)
    ref = RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(), backend="jax")
    want = np.asarray(_ref_stats(ref._dg, ref._du, xin, ref._params, 8, delta))
    assert want[0] > want[4] > 0 and want[1] > 0 and want[2] > 0
    if delta < 100:
        assert want[3] > 0
    xt = torch.from_numpy(xin)
    for du in (m._du, pu.relayout("wide32").device_ubodt()):
        got = ubodt_probe_stats(m._dg, du, xt, m._params, 8, delta)
        assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert ubodt_probe_stats_plain(m._dg, m._du, xt, m._params, 8, delta).tolist() == \
        want.tolist()


@functools.lru_cache(maxsize=1)
def _mixed_world():
    """A fuzz network with short, medium and long (three windows of 32)
    traces, one breaking exactly on a carry seam, and the reference
    matcher's answers."""
    net, ra, ru, pa, pu = scenario(61, delta=2000.0)
    rng = np.random.default_rng(61)
    traces = random_traces(rng, net, ra, n_traces=6, n_pts=12)
    traces += random_traces(rng, net, ra, n_traces=4, n_pts=28)
    traces += random_traces(rng, net, ra, n_traces=3, n_pts=int(rng.integers(72, 97)))
    traces.append(_seam_break_trace(net))
    ref = RefMatcher(arrays=ra, ubodt=ru, backend="jax",
                     config=RefConfig(length_buckets=LONG_BUCKETS))
    return pa, pu, traces, [_canon(r) for r in ref.match_many(traces)]


@pytest.mark.parametrize("layout,dedup", COMBOS)
def test_match_many_memory_system_equals_jax(layout, dedup):
    """The port of test_fuzz_differential's memory-system differential
    (scan): each combination, the table repacked from one prebuilt cuckoo
    table, answers as the JAX matcher does."""
    pa, pu, traces, want = _mixed_world()
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(length_buckets=LONG_BUCKETS, ubodt_layout=layout,
                                            probe_dedup=dedup))
    assert (m.ubodt.layout, m._du.layout, m.probe_dedup) == (layout, layout, dedup)
    H.DEDUP.reset()
    assert [_canon(r) for r in m.match_many(traces)] == want
    assert (H.DEDUP.probes > 0) == dedup  # bucketed and long pre dispatches


def test_env_overrides_config(monkeypatch):
    pa, pu, traces, want = _mixed_world()
    monkeypatch.setenv("REPORTER_UBODT_LAYOUT", "wide32")
    monkeypatch.setenv("REPORTER_PROBE_DEDUP", "1")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(length_buckets=LONG_BUCKETS))
    assert (m.ubodt_layout, m.probe_dedup) == ("wide32", True)
    assert [_canon(r) for r in m.match_many(traces[:8])] == want[:8]
    monkeypatch.setenv("REPORTER_PROBE_DEDUP", "off")
    cfg = MatcherConfig.from_dict({"ubodt_layout": "wide32", "probe_dedup": True})
    assert (cfg.ubodt_layout, cfg.probe_dedup) == ("wide32", True)
    assert SegmentMatcher(arrays=pa, ubodt=pu, device="cpu", config=cfg).probe_dedup is False
    monkeypatch.setenv("REPORTER_UBODT_LAYOUT", "linear")
    with pytest.raises(ValueError, match="cuckoo|wide32"):
        SegmentMatcher(arrays=pa, ubodt=pu, device="cpu")


def test_probe_sampler_totals(monkeypatch):
    """$REPORTER_OBS_PROBE_EVERY=1 samples every dense bucketed dispatch:
    the totals are the sum of the diagnostic over those batches."""
    pa, pu, traces, _want = _mixed_world()
    monkeypatch.setenv("REPORTER_OBS_PROBE_EVERY", "1")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(length_buckets=LONG_BUCKETS))
    short = traces[:10]
    m.match_many(short)
    want = np.zeros(5, np.int64)
    for T, idxs in ((16, range(6)), (32, range(6, 10))):
        px, py, tm, valid, _t = m._fill_rows(short, list(idxs), T)
        px, py, tm, valid = (np.concatenate([a, np.zeros((m._ladder_rung(len(idxs)) - len(idxs),
                                                          T), a.dtype)])
                             for a in (px, py, tm, valid))
        want += ubodt_probe_stats_plain(m._dg, m._du, torch.from_numpy(
            pack_inputs(px, py, tm, valid)), m._params, 8, 2000.0).numpy()
    ps = m.probe_stats
    assert ps["samples"] == 2 and not m._probe_pending
    assert [ps[k] for k in ("pairs", "miss", "costly_miss", "beyond_delta")] == want[:4].tolist()
    assert ps["dedup_ratio"] > 1.0


@functools.lru_cache(maxsize=1)
def _city():
    from reporter_tpu.tiles.arrays import build_graph_arrays as ref_arrays
    from reporter_tpu.tiles.network import grid_city as ref_grid_city
    from reporter_tpu_torch.synth import TraceSynthesizer
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.network import grid_city

    ra = ref_arrays(ref_grid_city(6, 6, 200.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(6, 6, 200.0), cell_size=100.0)
    synth = TraceSynthesizer(pa, seed=5)
    traces = [synth.synthesize(n, dt=dt, uuid="t%d" % i, max_tries=400).trace
              for i, (n, dt) in enumerate([(12, 60.0), (20, 60.0), (10, 45.0), (40, 60.0),
                                           (14, 5.0)])]
    return ra, ref_build_ubodt(ra, delta=3000.0), pa, build_ubodt(pa, delta=3000.0), traces


def test_sparse_cohorts_with_dedup_equal_jax():
    """Sparse cohorts (K = 16, bucketed and long) with dedup on a wide32
    table answer as the JAX matcher's sparse model does."""
    ra, ru, pa, pu, traces = _city()
    kw = dict(length_buckets=[16, 32], sparse=True)
    ref = RefMatcher(arrays=ra, ubodt=ru, backend="jax", config=RefConfig(**kw))
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(ubodt_layout="wide32", probe_dedup=True, **kw))
    H.DEDUP.reset()
    assert [_canon(r) for r in m.match_many(traces)] == \
        [_canon(r) for r in ref.match_many(traces)]
    assert m.sparse.dispatch == {"ge60": 3, "45-60": 1} and H.DEDUP.probes >= 3


@pytest.mark.parametrize("arena", [False, True])
def test_session_stream_on_wide32_equals_jax(arena):
    """Streams of 4-point submits through SessionEngine on a wide32 table
    with dedup on (session steps never dedup; the seam probe reads wide32
    rows): records and beams equal the reference engine's."""
    ra, ru, pa, pu, traces = _city()
    kw = dict(length_buckets=[16], session_buckets=[4, 16])
    ref = RefMatcher(arrays=ra, ubodt=ru, backend="jax", config=RefConfig(**kw))
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(ubodt_layout="wide32", probe_dedup=True,
                                            session_arena=arena, **kw))
    ref_eng = RefEngine(ref, RefStore(), tail_points=512)
    eng = SessionEngine(m, SessionStore(), tail_points=512)
    H.DEDUP.reset()
    for j in range(0, 40, 4):
        subs = [{"uuid": t["uuid"], "trace": t["trace"][j:j + 4]} for t in traces
                if j < len(t["trace"])]
        assert [g["segments"] for g in eng.match_many(subs)] == \
            [w["segments"] for w in ref_eng.match_many(subs)]
    for t in traces:
        s, r = eng.store.peek(t["uuid"]), ref_eng.store.peek(t["uuid"])
        assert s.records == r.records
        a, b = carry_host(s.carry), carry_host(r.carry)
        assert all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)
    assert H.DEDUP.probes == 0
