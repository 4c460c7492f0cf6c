"""The port's tiered UBODT and the session arena's cold tier against the JAX
package.

The reference's contract is that a tiered table answers bit for bit as
the untiered one does, at every occupancy.  Its own tiered probe cannot
run on this container (its pinned_host pages refuse the jitted gather),
so every answer here is held against the JAX package's UNTIERED
``ubodt_lookup`` and ``match_many``.  The hot set is held against a
reference ``TieredTable`` fed, through ``_note`` and ``drain_stats``, the
samples the reference's tiered lookup notes for the same keys: its
window counts, its maintenance cadence and its hot set after each
``maintain`` must equal the port's.  On the CPU the port runs the plain
versions of the kernels, which fetch, count and total the same rows.
The 5 x 5 grid city with delta 1500 is tests/test_tiering.py's."""

import functools
import threading

import jax
import numpy as np
import pytest
import torch

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.ops.hashtable import device_pair_hash as ref_hash1
from reporter_tpu.ops.hashtable import device_pair_hash2 as ref_hash2
from reporter_tpu.ops.hashtable import ubodt_lookup as ref_lookup
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.tiering import TieredTable as RefTiered
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher, SessionEngine, SessionStore
from reporter_tpu_torch.matching.arena import carry_host
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.ops import viterbi as V
from reporter_tpu_torch.serve import ReporterService
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.tiering import TieredTable, parse_shard, shard_bucket_range
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from test_fuzz_differential import _canon

_ref_lookup = jax.jit(ref_lookup, static_argnames=("dedup",))
_ref_h1 = jax.jit(ref_hash1, static_argnums=2)
_ref_h2 = jax.jit(ref_hash2, static_argnums=2)
LAYOUTS = ("cuckoo", "wide32")
BUDGETS = (1, 3000, 1 << 30)
SLOT_B = 12 * 8 + 17  # one session slot at K = 8


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Every matcher reads these when it is built."""
    for var in ("REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP", "REPORTER_OBS_PROBE_EVERY",
                "REPORTER_SPARSE", "REPORTER_CALIBRATION", "REPORTER_SESSION_ARENA",
                "REPORTER_UBODT_HOT_BYTES", "REPORTER_UBODT_SHARD", "REPORTER_VITERBI",
                "REPORTER_SESSION_ARENA_BYTES", "REPORTER_SESSION_ARENA_COLD_BYTES",
                "REPORTER_INTERPOLATE"):
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=1)
def _world():
    """(reference arrays, port arrays, {layout: (reference table, port
    table)}) on the 5 x 5 grid city."""
    ra = ref_arrays(ref_grid_city(rows=5, cols=5, spacing_m=150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(5, 5, spacing_m=150.0), cell_size=100.0)
    tables = {}
    for layout in LAYOUTS:
        ru = ref_build_ubodt(ra, delta=1500.0, layout=layout)
        pu = build_ubodt(pa, delta=1500.0, layout=layout)
        assert pu.packed.tobytes() == ru.packed.tobytes()
        tables[layout] = (ru, pu)
    return ra, pa, tables


def fleet_traces(arrays, n=10, pts=12, seed=3):
    """tests/test_tiering.py's street-following traces along grid rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = int(rng.integers(0, 5))
        row_nodes = [r * 5 + c for c in range(5)]
        xs = arrays.node_x[row_nodes]
        ys = arrays.node_y[row_nodes]
        t = np.linspace(0.05, 0.9, pts)
        px = np.interp(t, np.linspace(0, 1, 5), xs) + rng.normal(0, 3, pts)
        py = np.interp(t, np.linspace(0, 1, 5), ys) + rng.normal(0, 3, pts)
        lat, lon = arrays.proj.to_latlon(px, py)
        out.append({"uuid": "v%d" % i, "trace": [
            {"lat": float(a), "lon": float(o), "time": 1000.0 + 15 * j}
            for j, (a, o) in enumerate(zip(lat, lon))]})
    return out


class _Muted(threading.Event):
    """An event nothing can set: keeps the reference tier's drain thread
    asleep, so its samples drain only where the test calls drain_stats."""

    def set(self):
        pass


def _ref_tier(ru, hot_bytes, **kw):
    t = RefTiered(ru, hot_bytes, **kw)
    t._stats_wake = _Muted()
    return t


def _ref_note(ref, layout, s, d):
    """Note on the reference tier what its tiered lookup of keys (s, d)
    notes: each hash's buckets (one sample per hash) with their hot flags
    under its current slot map, then drain."""
    slot_map = np.asarray(ref._hot_dev[1])
    for h in (_ref_h1,) if layout == "wide32" else (_ref_h1, _ref_h2):
        b = np.asarray(h(jax.numpy.asarray(s), jax.numpy.asarray(d),
                         int(ref.ubodt.bmask))).reshape(-1)
        ref._note(b, slot_map[b] >= 0)
    ref.drain_stats()


def _compact(s, d, n_unique_budget):
    """The keys the reference's deduplicated probe fetches: its compact
    buffer (the distinct keys, then (0, 0) up to the budget m), or every
    key when the distinct count is past m."""
    keys = np.unique(np.stack([s.reshape(-1), d.reshape(-1)], 1), axis=0)
    if len(keys) > n_unique_budget:
        return s.reshape(-1), d.reshape(-1)
    pad = np.zeros((n_unique_budget - len(keys), 2), np.int32)
    keys = np.concatenate([keys, pad])
    return keys[:, 0].astype(np.int32), keys[:, 1].astype(np.int32)


def _bincount(layout, s, d, bmask, n):
    hs = [_ref_h1] if layout == "wide32" else [_ref_h1, _ref_h2]
    b = np.concatenate([np.asarray(h(jax.numpy.asarray(s), jax.numpy.asarray(d), bmask))
                        .reshape(-1) for h in hs])
    return np.bincount(b, minlength=n)


def _same_state(port, ref):
    """Window counts, cadence counters and hot set equal."""
    np.testing.assert_array_equal(port.window_counts(), ref._counts)
    assert port._dispatches_since_maintain == ref._dispatches_since_maintain
    assert port._misses_since_maintain == ref._misses_since_maintain
    np.testing.assert_array_equal(port.hot_buckets(), ref.hot_buckets())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("hot_bytes", BUDGETS)
def test_probe_and_hot_set_equal_reference(layout, hot_bytes):
    """Plain, deduplicated and fallen-back probes of the tiered table equal
    the JAX package's untiered probe at every occupancy (a cold storm,
    then the warmed arena); each probe counts the bucket multiset the
    reference notes (np.bincount of its hashes); the window counts,
    cadence counters and hot set after each drain (which may maintain)
    and each explicit maintain equal a reference TieredTable fed the same
    samples."""
    _ra, _pa, tables = _world()
    ru, pu = tables[layout]
    ref_du = ru.to_device()
    # a cadence of 3 units: drains run maintenance passes of their own
    # between the explicit ones
    tier = TieredTable(pu, hot_bytes, maintain_every=3, device="cpu")
    ref = _ref_tier(ru, hot_bytes, maintain_every=3)
    tdu = tier.device()
    assert (tier.capacity, tier.n_buckets, tier.lanes) == (ref.capacity, ref.n_buckets,
                                                           ref.lanes)
    rng = np.random.default_rng(7)
    sets = [  # (keys, dedup): plain; dedup within its budget; past it
        (rng.integers(0, 30, size=(2, 16, 5, 4)).astype(np.int32), False),
        (rng.integers(0, 20, size=(2, 64, 5, 4)).astype(np.int32), True),
        (rng.integers(0, 1000, size=(2, 64, 5, 4)).astype(np.int32), True),
    ]
    fetched = 0
    for _rnd in range(2):  # a cold storm, then the EWMA-warmed arena
        for (s, d), dedup in sets:
            before = tier.window_counts()
            want = _ref_lookup(ref_du, s, d, dedup=dedup)
            got = H.ubodt_lookup(tdu, torch.from_numpy(s), torch.from_numpy(d), dedup=dedup)
            for a, b in zip(want, got):
                assert np.asarray(a).tobytes() == b.numpy().tobytes()
            keys = _compact(s, d, H._budget(s.size)) if dedup else (s, d)
            want_counts = _bincount(layout, *keys, pu.bmask, pu.n_buckets)
            np.testing.assert_array_equal(tier.window_counts() - before, want_counts)
            fetched += int(want_counts.sum())
            tier.drain_stats()
            _ref_note(ref, layout, *keys)
            _same_state(tier, ref)
        assert tier.maintain() == ref.maintain()
        _same_state(tier, ref)
    assert tier.hits + tier.misses == fetched
    assert tier.maintenance_passes > 2  # drains maintained too
    if tier.capacity >= tier.n_buckets:
        assert tier.resident_rows == tier.n_buckets and tier.hits > 0
    if tier.capacity == 0:
        assert tier.hits == 0 and tier.resident_rows == 0


def test_cold_miss_storm_counters():
    """tests/test_tiering.py's storm: everything cold at boot, then the
    EWMA admits the stormed buckets and repeat traffic hits."""
    _ra, _pa, tables = _world()
    tier = TieredTable(tables["cuckoo"][1], 4096, maintain_every=1, device="cpu")
    tdu = tier.device()
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.integers(0, 25, size=(256,)).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 25, size=(256,)).astype(np.int32))
    H.ubodt_lookup(tdu, src, dst)
    tier.drain_stats()  # due: misses and one unit (maintain_every 1)
    assert tier.misses == 512 and tier.hits == 0 and tier.maintenance_passes == 1
    assert tier.resident_rows == tier.capacity == 8
    H.ubodt_lookup(tdu, src, dst)
    tier.drain_stats()
    assert tier.hits > 0


def _ref_answers(layout, kernel, traces, **kw):
    ra, _pa, tables = _world()
    ref = RefMatcher(arrays=ra, ubodt=tables[layout][0], backend="jax",
                     config=RefConfig(ubodt_layout=layout, viterbi_kernel=kernel,
                                      length_buckets=[16], **kw))
    return [_canon(r) for r in ref.match_many(traces)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kernel", ["scan", "assoc"])
def test_match_many_tiered_equals_jax(layout, kernel):
    """Bucketed and long traffic through a tiered matcher (4 KB hot: a
    genuinely cold table, dedup on) answers as the JAX package's untiered
    matcher, through the cold-miss storm and again after eviction churn
    (another traffic mix, two maintenance passes)."""
    ra, pa, tables = _world()
    traces = fleet_traces(ra) + fleet_traces(ra, n=1, pts=40, seed=9)
    want = _ref_answers(layout, kernel, traces, probe_dedup=True)
    m = SegmentMatcher(arrays=pa, ubodt=tables[layout][1], device="cpu",
                       config=MatcherConfig(ubodt_layout=layout, viterbi_kernel=kernel,
                                            probe_dedup=True, length_buckets=[16],
                                            ubodt_hot_bytes=4096))
    t = m.tiering
    assert t is not None and t.table_bytes > 4 * 4096 and m._du.tier is t
    assert [_canon(r) for r in m.match_many(traces)] == want
    assert t.misses > 0
    m.match_many(fleet_traces(ra, n=8, seed=77))
    ev = t.maintain()
    t.maintain()
    assert ev["hot_rows"] > 0 and t.resident_rows == t.capacity
    assert [_canon(r) for r in m.match_many(traces)] == want
    assert t.hits > 0 and t.maintenance_passes >= 2


@pytest.mark.parametrize("arena", [False, True])
def test_session_streams_tiered_equal_jax(arena):
    """4-point submits through SessionEngine on a tiered table (2 KB hot):
    the seam probes read through the tier; records and beams equal the
    reference engine's on the untiered table."""
    ra, pa, tables = _world()
    kw = dict(length_buckets=[16], session_buckets=[4, 16])
    ref = RefMatcher(arrays=ra, ubodt=tables["cuckoo"][0], backend="jax",
                     config=RefConfig(**kw))
    m = SegmentMatcher(arrays=pa, ubodt=tables["cuckoo"][1], device="cpu",
                       config=MatcherConfig(session_arena=arena, ubodt_hot_bytes=2048, **kw))
    traces = fleet_traces(ra, n=4, pts=16)
    ref_eng = RefEngine(ref, RefStore(), tail_points=512)
    eng = SessionEngine(m, SessionStore(), tail_points=512)
    for j in range(0, 16, 4):
        subs = [{"uuid": t["uuid"], "trace": t["trace"][j:j + 4]} for t in traces]
        assert [g["segments"] for g in eng.match_many(subs)] == \
            [w["segments"] for w in ref_eng.match_many(subs)]
    for t in traces:
        assert eng.store.peek(t["uuid"]).records == ref_eng.store.peek(t["uuid"]).records
    assert m.tiering.misses > 0 and m.tiering.maintenance_passes > 0


def test_seam_counts_every_row():
    """The chain's seam probe counts the [K, K] pairs of every row
    (padding rows and dead slots included, their edges clamped to edge 0),
    one lookup's fetch units per launch: the multiset the reference notes
    for its vmapped seam.  The reference notes that probe once per batch
    row (its debug.callback unrolls under vmap), the port once per launch
    (ROADMAP.md section 3)."""
    ra, pa, tables = _world()
    ru, pu = tables["cuckoo"]
    base = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                          config=MatcherConfig(length_buckets=[16]))
    tier = TieredTable(pu, 3000, device="cpu")
    tdu = tier.device()
    traces = fleet_traces(ra, n=3, pts=32)
    px, py, tm, valid, _t = base._fill_rows(traces, [0, 1, 2], 32)
    px, py, tm, valid = (np.concatenate([a, np.zeros((1, 32), a.dtype)])
                         for a in (px, py, tm, valid))  # one padding row
    xin = torch.from_numpy(V.pack_inputs(px, py, tm, valid))
    x0, x1 = xin[:, :, :16].contiguous(), xin[:, :, 16:].contiguous()
    p, k = base._params, 8
    pre0 = V.precompute_batch_packed(base._dg, base._du, x0, p, k)
    carry = V.viterbi_chain_plain(base._dg, base._du, pre0.emis, pre0.logp, pre0.gc,
                                  *V.unpack_inputs(x0), pre0.cand.edge, pre0.cand.offset, p,
                                  V.initial_carry_batch(4, k))[2]
    pre = V.precompute_batch_packed(base._dg, base._du, x1, p, k)
    args = (pre.emis, pre.logp, pre.gc, *V.unpack_inputs(x1), pre.cand.edge,
            pre.cand.offset, p, carry)
    want = V.viterbi_chain_plain(base._dg, base._du, *args)
    got = V.viterbi_chain_plain(base._dg, tdu, *args)
    assert all(torch.equal(a, b) for a, b in zip(want[:2], got[:2]))
    rows = base._dg.edge_rows
    to_a = rows[carry.edge.clamp(min=0).long(), 0].contiguous().view(torch.int32)
    from_b = rows[pre.cand.edge[:, 0].clamp(min=0).long(), 1].contiguous().view(torch.int32)
    s = to_a[:, :, None].expand(4, k, k).numpy()
    d = from_b[:, None, :].expand(4, k, k).numpy()
    np.testing.assert_array_equal(tier.window_counts(),
                                  _bincount("cuckoo", s, d, pu.bmask, pu.n_buckets))
    tier.drain_stats()
    assert tier._dispatches_since_maintain == 2  # one lookup's units
    assert tier.hits + tier.misses == 2 * 4 * k * k


def test_tier_mechanics():
    """A budget below one row (everything cold); eviction accounting under
    skewed counts; shard seeding that survives a zero-traffic pass;
    parse_shard's errors and the partition."""
    _ra, _pa, tables = _world()
    pw, pu = tables["wide32"][1], tables["cuckoo"][1]
    t = TieredTable(pw, 1, device="cpu")
    assert t.capacity == 0 and t.summary()["hot_rows"] == 0
    assert t.maintain() == {"hot_rows": 0, "admitted": 0, "evicted": 0}
    t = TieredTable(pu, 8 * 512, device="cpu")
    assert t.capacity == 8
    t.counts[:8] += 1
    t.maintain()
    assert set(t.hot_buckets()) >= set(range(8))
    rival = np.arange(t.n_buckets - 8, t.n_buckets)
    for _ in range(6):
        t.counts[torch.from_numpy(rival)] += 4
        t.maintain()
    assert set(t.hot_buckets()) == set(rival) and t.evictions == 8
    lo, hi = shard_bucket_range(1, 4, pu.n_buckets)
    t = TieredTable(pu, 4 * 512, shard=(1, 4), device="cpu")
    hot = t.hot_buckets()
    assert len(hot) == 4 and (hot >= lo).all() and (hot < hi).all()
    t.maintain()
    assert set(t.hot_buckets()) == set(hot)
    ref = _ref_tier(tables["cuckoo"][0], 4 * 512, shard=(1, 4))
    np.testing.assert_array_equal(hot, ref.hot_buckets())
    assert {k: v for k, v in t.summary().items() if k != "cold_memory_kind"} == \
        {k: v for k, v in ref.summary().items() if k != "cold_memory_kind"}
    assert parse_shard("") is None and parse_shard("2/8") == (2, 8)
    for bad in ("8/2", "nope", "1/0"):
        with pytest.raises(ValueError):
            parse_shard(bad)
    spans = [shard_bucket_range(i, 3, pu.n_buckets) for i in range(3)]
    assert spans[0][0] == 0 and spans[-1][1] == pu.n_buckets
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_maintain_moves_only_changed_rows(layout):
    """Under churn every hot bucket's arena row is its page, every other
    bucket is cold in the slot map, no two buckets share a slot, and a
    bucket that stays hot keeps its slot across a pass."""
    _ra, _pa, tables = _world()
    row_bytes = 4 * (256 if layout == "wide32" else 128)
    t = TieredTable(tables[layout][1], 8 * row_bytes, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(12):
        before = t.source()[1].clone()
        t.counts += torch.from_numpy(rng.integers(0, 4, t.n_buckets).astype(np.int32))
        t.maintain()
        arena, slot_map = t.source()[:2]
        hot = t.hot_buckets()
        slots = slot_map[torch.from_numpy(hot)]
        assert (slots >= 0).all() and len(set(slots.tolist())) == len(hot) == t.capacity
        assert int((slot_map >= 0).sum()) == len(hot)
        assert torch.equal(arena[slots.long()], t.pages_t[torch.from_numpy(hot)])
        kept = (before >= 0) & (slot_map >= 0)
        assert torch.equal(before[kept], slot_map[kept])
    assert t.evictions > 0


def test_tier_state_across_relayout():
    """Tiering a relayouted table, and a matcher that relayouts a prebuilt
    cuckoo table to wide32 and tiers the result, both answer as the JAX
    package's untiered wide32 matcher."""
    ra, pa, tables = _world()
    pu = tables["cuckoo"][1]
    wide = pu.relayout("wide32")
    tier = TieredTable(wide, 4096, device="cpu")
    assert tier.n_buckets == wide.n_buckets and tier.lanes == 256
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(ubodt_layout="wide32", ubodt_hot_bytes=4096,
                                            length_buckets=[16]))
    assert m.ubodt.layout == "wide32" and m.tiering.ubodt.layout == "wide32"
    assert m._du.wide and m.tiering.lanes == 256
    traces = fleet_traces(ra, n=4)
    assert [_canon(r) for r in m.match_many(traces)] == \
        _ref_answers("wide32", "scan", traces)


def test_env_and_health(monkeypatch):
    """$REPORTER_UBODT_HOT_BYTES over the config, with the reference's
    error for a non-integer; $REPORTER_UBODT_SHARD seeds the arena; /health
    carries ubodt_shard and ubodt_tiered."""
    _ra, pa, tables = _world()
    pu = tables["cuckoo"][1]
    monkeypatch.setenv("REPORTER_UBODT_HOT_BYTES", "lots")
    with pytest.raises(ValueError, match="REPORTER_UBODT_HOT_BYTES must be an integer"):
        SegmentMatcher(arrays=pa, ubodt=pu, device="cpu")
    monkeypatch.setenv("REPORTER_UBODT_HOT_BYTES", "2048")
    monkeypatch.setenv("REPORTER_UBODT_SHARD", "1/4")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(ubodt_hot_bytes=1 << 30))
    assert m.tiering.hot_bytes == 2048 and m.ubodt_shard == (1, 4)
    lo, hi = shard_bucket_range(1, 4, pu.n_buckets)
    assert ((m.tiering.hot_buckets() >= lo) & (m.tiering.hot_buckets() < hi)).all()
    service = ReporterService(m, max_wait_ms=1.0)
    try:
        _code, health = service.handle_health()
    finally:
        service.close()
    assert health["ubodt_tiered"] is True and health["ubodt_shard"] == "1/4"
    assert health["ubodt_tier"]["capacity_rows"] == 4
    monkeypatch.setenv("REPORTER_UBODT_SHARD", "5/4")
    with pytest.raises(ValueError, match="out of range"):
        SegmentMatcher(arrays=pa, ubodt=pu, device="cpu")
    monkeypatch.delenv("REPORTER_UBODT_HOT_BYTES")
    monkeypatch.delenv("REPORTER_UBODT_SHARD")
    plain = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu")
    assert plain.tiering is None and not hasattr(plain._du, "tier")


def _stream(eng, traces, step, one_at_a_time):
    for j in range(0, max(len(t["trace"]) for t in traces), step):
        subs = [{"uuid": t["uuid"], "trace": t["trace"][j:j + step]}
                for t in traces if t["trace"][j:j + step]]
        for batch in ([s] for s in subs) if one_at_a_time else [subs]:
            eng.match_many(batch)
            yield


@pytest.mark.parametrize("budget,one_at_a_time", [((2, 2), True), ((3, 0), True),
                                                  ((1, 4), False)])
def test_session_cold_tier_equals_reference(budget, one_at_a_time):
    """The session slab under a byte budget (hot, cold slots): round-robin
    vehicles promote, demote and spill at every step; tier_counts after
    every submit and the promotion, eviction and readback counts equal the
    reference SessionArena's under the same budgets and calls, and the
    records and beams equal the host-carry path's.  A group wider than
    the slab (one hot slot, batched submits) takes the host-carry path."""
    ra, pa, tables = _world()
    hot, cold = budget
    kw = dict(length_buckets=[16], session_buckets=[4, 16], session_arena=True,
              session_arena_bytes=hot * SLOT_B, session_arena_cold_bytes=cold * SLOT_B)
    ref = RefMatcher(arrays=ra, ubodt=tables["cuckoo"][0], backend="jax",
                     config=RefConfig(**kw))
    m = SegmentMatcher(arrays=pa, ubodt=tables["cuckoo"][1], device="cpu",
                       config=MatcherConfig(**kw))
    host = SegmentMatcher(arrays=pa, ubodt=tables["cuckoo"][1], device="cpu",
                          config=MatcherConfig(length_buckets=[16], session_buckets=[4, 16]))
    traces = fleet_traces(ra, n=5, pts=10, seed=4)
    engines = [SessionEngine(m, SessionStore(), tail_points=512),
               RefEngine(ref, RefStore(), tail_points=512),
               SessionEngine(host, SessionStore(), tail_points=512)]
    arena, ref_arena = m.session_arena, ref.session_arena
    assert (arena.hot_slots, arena.cold_slots) == (ref_arena.hot_slots, ref_arena.cold_slots)
    steps = [_stream(e, traces, 2, one_at_a_time) for e in engines]
    for _ in zip(*steps):
        assert arena.tier_counts() == ref_arena.tier_counts()
    keys = ("hot_slots", "hot_used", "cold_slots", "cold_used", "slot_bytes", "hot_bytes",
            "cold_bytes", "promotions", "evictions", "readbacks")
    got, want = arena.summary(), ref_arena.summary()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    if one_at_a_time:
        assert got["promotions"] > 0 and got["evictions"] > 0
    else:
        assert got["promotions"] == 0
    for t in traces:
        sessions = [e.store.peek(t["uuid"]) for e in engines]
        assert sessions[0].records == sessions[2].records == sessions[1].records
        a, b = (carry_host(x.carry) for x in (sessions[0], sessions[2]))
        assert all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)
