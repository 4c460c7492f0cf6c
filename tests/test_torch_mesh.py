"""The port's device mesh (kernel row 11) against the JAX package.

On the CPU every rank of a port mesh is the ``cpu`` device, as the JAX
package's own mesh tests run on the 8 virtual CPU devices conftest.py
provides; the kernels run their plain versions.  Held here:

  - the gp-sharded probe (each gp rank's bucket range, merged by pmin /
    pmax) against ``_ubodt_lookup_sharded`` under ``shard_map``, both
    layouts, bit for bit;
  - ``match_and_histogram``, ``sharded_match_fn`` and
    ``graph_sharded_match_fn`` against the reference's: idx, breaks and
    the counts exact, the two float sums within rtol 1e-5 (the
    reference's own bound between its sharded and unsharded histograms);
  - the matcher at devices 1, 2, 8 and dp 2 x gp 4 against the JAX
    matcher at the same topology, wire for wire: dense, long, sparse,
    slab sessions and an eviction mid-stream;
  - the slot-sharded slab's gather and scatter against
    ``_arena_gather_mesh`` / ``_arena_scatter_mesh``, bit for bit;
  - the configuration rules, the rule table and the collectives.

The 5 x 5 grid city is tests/test_parallel.py's and
tests/test_mesh_identity.py's."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.ops.hashtable import ubodt_lookup as ref_lookup
from reporter_tpu.ops.viterbi import MatchParams as RefParams
from reporter_tpu.ops.viterbi import TraceCarry as RefCarry
from reporter_tpu.ops.viterbi import _arena_gather_mesh, _arena_scatter_mesh
from reporter_tpu.parallel import graph_sharded_match_fn as ref_graph_fn
from reporter_tpu.parallel import make_mesh as ref_make_mesh
from reporter_tpu.parallel import make_mesh2 as ref_make_mesh2
from reporter_tpu.parallel import match_and_histogram as ref_mah
from reporter_tpu.parallel import sharded_match_fn as ref_sharded_fn
from reporter_tpu.parallel.rules import shard_map
from reporter_tpu.synth import TraceSynthesizer as RefSynth
from reporter_tpu.synth.generator import example_grid_batch
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher, SessionEngine, SessionStore
from reporter_tpu_torch.matching.arena import carry_host
from reporter_tpu_torch.ops import collectives
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.ops import viterbi as V
from reporter_tpu_torch.ops.viterbi import MatchParams
from reporter_tpu_torch.parallel import (
    check_ubodt_shardable, graph_sharded_match_fn, make_mesh, make_mesh2,
    match_and_histogram, sharded_match_fn,
)
from reporter_tpu_torch.parallel.mesh import place
from reporter_tpu_torch.parallel.rules import BATCH_AXIS, GRAPH_AXIS, spec_for
from reporter_tpu_torch.serve.service import ReporterService, build_matcher, parse_service_config
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import DeviceUBODT, ShardedUBODT, build_ubodt

K = 8
LAYOUTS = ("cuckoo", "wide32")
MO = {"mode": "auto", "report_levels": [0, 1], "transition_levels": [0, 1]}
SLOT_B = 12 * K + 17  # one slab slot at K = 8
KW = dict(length_buckets=[16], session_buckets=[4, 16])
ENV = ("REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP", "REPORTER_OBS_PROBE_EVERY",
       "REPORTER_SPARSE", "REPORTER_CALIBRATION", "REPORTER_SESSION_ARENA",
       "REPORTER_UBODT_HOT_BYTES", "REPORTER_UBODT_SHARD", "REPORTER_VITERBI",
       "REPORTER_SESSION_ARENA_BYTES", "REPORTER_SESSION_ARENA_COLD_BYTES",
       "REPORTER_INTERPOLATE", "REPORTER_DEVICES", "REPORTER_GRAPH_DEVICES")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Every matcher reads these when it is built."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=1)
def _world():
    """(reference arrays, port arrays, {(layout, delta): (reference table,
    port table)}) on the 5 x 5 grid city."""
    ra = ref_arrays(ref_grid_city(rows=5, cols=5, spacing_m=150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(5, 5, spacing_m=150.0), cell_size=100.0)
    tables = {}
    for delta in (1500.0, 2000.0):
        for layout in LAYOUTS:
            ru = ref_build_ubodt(ra, delta=delta, layout=layout)
            pu = build_ubodt(pa, delta=delta, layout=layout)
            assert pu.packed.tobytes() == ru.packed.tobytes()
            tables[layout, delta] = (ru, pu)
    return ra, pa, tables


def _cpu(n):
    return ["cpu"] * n


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the gp-sharded probe (kernel 11a's plain version) ------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gp", [2, 4, 8])
def test_sharded_probe_bit_identical(gp, layout):
    """Each gp rank probes its bucket range, the rest reading as -2 rows;
    the pmin / pmax over the ranks equals the reference's
    ``_ubodt_lookup_sharded`` under shard_map (and the whole table's
    probe) bit for bit, hits and misses alike, and a rank's answer is
    either the whole table's or a clean miss."""
    ra, pa, tables = _world()
    ru, pu = tables[layout, 1500.0]
    rng = np.random.default_rng(gp)
    # node ids past the graph's never hit: misses beside the hits
    s = rng.integers(0, ra.num_nodes + 6, (4, 9, 6)).astype(np.int32)
    d = rng.integers(0, ra.num_nodes + 6, (4, 9, 6)).astype(np.int32)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:gp]), ("gp",))
    ref = jax.jit(shard_map(
        lambda du, a, b: ref_lookup(du.with_shard_axis("gp"), a, b),
        mesh=mesh, in_specs=(P("gp"), P(), P()), out_specs=P()))
    want = [np.asarray(x) for x in ref(ru.to_device(), jnp.asarray(s), jnp.asarray(d))]
    assert 0 < np.isfinite(want[0]).mean() < 1  # hits and misses
    (su,) = place(make_mesh2(1, gp, _cpu(gp)), "du", pu.to_device("cpu"))
    assert isinstance(su, ShardedUBODT) and len(su.shards) == gp
    assert H.probe_kernel_name(su) == "ubodt_probe[%ssharded]" % (
        "wide32," if layout == "wide32" else "")
    got = H.ubodt_lookup(su, _t(s), _t(d))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == w.tobytes()
    full = H.ubodt_lookup(pu.to_device("cpu"), _t(s), _t(d))
    for view in su.shards:
        assert view.packed.shape[0] * gp == pu.n_buckets
        rd, rt, rf = H.ubodt_lookup_plain(view, _t(s), _t(d))
        hit = torch.isfinite(rd)
        assert torch.equal(rd[hit], full[0][hit]) and torch.equal(rf[hit], full[2][hit])
        assert bool((rt[~hit] == float("inf")).all()) and bool((rf[~hit] == -1).all())
    # the dedup option is skipped on a sharded table, as in the reference
    assert all(torch.equal(a, b) for a, b in zip(
        H.ubodt_lookup(su, _t(s), _t(d), dedup=True), got))


def test_check_ubodt_shardable():
    _ra, _pa, tables = _world()
    pu = tables["cuckoo", 1500.0][1]
    assert check_ubodt_shardable(pu, 4) is pu
    with pytest.raises(ValueError, match="not divisible"):
        check_ubodt_shardable(pu, 3)
    du = pu.to_device("cpu")
    with pytest.raises(ValueError):
        du.shard(0, 3)
    with pytest.raises(ValueError):
        du.shard(0, 2).shard(0, 2)


def test_whole_table_needs_every_bucket():
    """A table short of buckets is refused, not taken for a gp rank's
    range: only ``shard`` builds a bucket-range view."""
    _ra, _pa, tables = _world()
    du = tables["cuckoo", 1500.0][1].to_device("cpu")
    with pytest.raises(ValueError, match="buckets, bmask"):
        DeviceUBODT(du.packed[:-1], du.bmask, du.layout)
    with pytest.raises(ValueError, match="buckets, bmask"):
        DeviceUBODT(du.packed, du.bmask, du.layout, lo=1)
    view = du.shard(1, 2)
    assert view.sharded and not du.sharded and H.probe_kernel_name(view) == \
        "ubodt_probe[sharded]"
    assert view.to_device("cpu").sharded and view.lo == (du.bmask + 1) // 2


# -- the histogram programs (kernel 11b's plain version) ----------------------


def _hist_inputs(B=8, T=12, seed=3):
    ra, pa, tables = _world()
    ru, pu = tables["cuckoo", 2000.0]
    px, py, times, valid = example_grid_batch(ra, B, T, seed)
    return ra, pa, ru, pu, (px, py, times, valid)


def _same_hist(got, want):
    for name, a, b in zip(("point_count", "trace_count", "time", "distance"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        if name.endswith("count"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_match_and_histogram_equals_reference():
    ra, pa, ru, pu, batch = _hist_inputs()
    S = len(ra.seg_ids)
    res_r, hist_r = jax.jit(ref_mah, static_argnums=(7, 8))(
        ra.to_device(), ru.to_device(), *(jnp.asarray(a) for a in batch),
        RefParams.from_config(RefConfig()), K, S)
    res, hist = match_and_histogram(pa.to_device("cpu"), pu.to_device("cpu"),
                                    *(_t(a) for a in batch),
                                    MatchParams.from_config(MatcherConfig()), K, S)
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(res_r.idx))
    np.testing.assert_array_equal(res.breaks.numpy(), np.asarray(res_r.breaks))
    assert res.route_dist.numpy().tobytes() == np.asarray(res_r.route_dist).tobytes()
    np.testing.assert_array_equal(res.cand.edge.numpy(), np.asarray(res_r.cand.edge))
    _same_hist(hist, hist_r)
    assert float(hist.point_count.sum()) == batch[0].size


def test_sharded_match_fn_dp8_equals_reference():
    ra, pa, ru, pu, batch = _hist_inputs()
    S = len(ra.seg_ids)
    res_r, hist_r = ref_sharded_fn(ref_make_mesh(), K, S)(
        ra.to_device(), ru.to_device(), *(jnp.asarray(a) for a in batch),
        RefParams.from_config(RefConfig()))
    res, hist = sharded_match_fn(make_mesh(8, _cpu(8)), K, S)(
        pa.to_device("cpu"), pu.to_device("cpu"), *(_t(a) for a in batch),
        MatchParams.from_config(MatcherConfig()))
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(res_r.idx))
    _same_hist(hist, hist_r)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_graph_sharded_match_fn_dp2_gp4_equals_reference(layout):
    ra, pa, _ru, _pu, batch = _hist_inputs()
    _ra, _pa, tables = _world()
    ru, pu = tables[layout, 2000.0]
    S = len(ra.seg_ids)
    res_r, hist_r = ref_graph_fn(ref_make_mesh2(2, 4), K, S)(
        ra.to_device(), ru.to_device(), *(jnp.asarray(a) for a in batch),
        RefParams.from_config(RefConfig()))
    fn = graph_sharded_match_fn(make_mesh2(2, 4, _cpu(8)), K, S)
    res, hist = fn(pa.to_device("cpu"), pu.to_device("cpu"), *(_t(a) for a in batch),
                   MatchParams.from_config(MatcherConfig()))
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(res_r.idx))
    np.testing.assert_array_equal(res.breaks.numpy(), np.asarray(res_r.breaks))
    _same_hist(hist, hist_r)
    with pytest.raises(ValueError, match="gp axis"):
        graph_sharded_match_fn(make_mesh(2, _cpu(2)), K, S)


def test_trace_count_exact_on_reentry():
    """tests/test_parallel.py's out-and-back drive: a trace that re-enters
    a segment counts once per segment, as in the reference."""
    ra, pa, tables = _world()
    ru, pu = tables["cuckoo", 2000.0]
    nodes = [2 * 5 + c for c in [0, 1, 2, 3, 2, 1, 0]]
    xs, ys = ra.node_x[nodes], ra.node_y[nodes]
    t = np.linspace(0.0, 1.0, 14)
    px = np.interp(t, np.linspace(0, 1, len(xs)), xs)[None, :].astype(np.float32)
    py = np.interp(t, np.linspace(0, 1, len(ys)), ys)[None, :].astype(np.float32)
    times = (np.arange(14, dtype=np.float32) * 15.0)[None, :]
    valid = np.ones((1, 14), bool)
    S = len(ra.seg_ids)
    batch = (px, py, times, valid)
    _res_r, hist_r = jax.jit(ref_mah, static_argnums=(7, 8))(
        ra.to_device(), ru.to_device(), *(jnp.asarray(a) for a in batch),
        RefParams.from_config(RefConfig()), K, S)
    res, hist = match_and_histogram(pa.to_device("cpu"), pu.to_device("cpu"),
                                    *(_t(a) for a in batch),
                                    MatchParams.from_config(MatcherConfig()), K, S)
    _same_hist(hist, hist_r)
    idx = res.idx.numpy()
    edge = np.take_along_axis(res.cand.edge.numpy(), np.maximum(idx, 0)[..., None], 2)[..., 0]
    segs = {int(pa.edge_seg[e]) for e, i in zip(edge[0], idx[0])
            if i >= 0 and pa.edge_seg[e] >= 0}
    want = np.zeros(S)
    want[sorted(segs)] = 1
    np.testing.assert_array_equal(hist.trace_count.numpy(), want)


# -- the matcher on a mesh -----------------------------------------------------


def _traces(n=6, pts=12, seed=3, dt=5.0, chain=True):
    ra, _pa, _tables = _world()
    synth = RefSynth(ra, seed=seed)
    trs = [synth.synthesize(pts, dt=dt, uuid="v%d" % i, sigma=3.0, max_tries=300).trace
           for i in range(n)]
    if chain:  # past the largest bucket: the long path's carried windows
        trs.append(synth.synthesize(40, dt=5.0, uuid="chain", sigma=3.0,
                                    max_tries=300).trace)
    return trs


def _pair(devices=1, gp=1, layout="cuckoo", **kw):
    ra, pa, tables = _world()
    ru, pu = tables[layout, 1500.0]
    ref = RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(
        ubodt_layout=layout, devices=devices, graph_devices=gp, **KW, **kw))
    port = SegmentMatcher(arrays=pa, ubodt=pu, device=_cpu(devices), config=MatcherConfig(
        ubodt_layout=layout, devices=devices, graph_devices=gp, **KW, **kw))
    return ref, port


def _wire(results):
    return json.dumps(results, sort_keys=True)


@pytest.mark.parametrize("devices,gp", [(1, 1), (2, 1), (8, 1), (8, 4)])
def test_matcher_wire_identical_at_each_topology(devices, gp):
    """Dense windowed and long (carried) traffic at the reference's
    topology, both forwards on the 2-D mesh."""
    trs = _traces()
    ref, port = _pair(devices, gp)
    assert (port._mesh is None) == (devices == 1)
    if devices > 1:
        assert port._mesh.shape == ({"dp": devices // gp, "gp": gp} if gp > 1
                                    else {"dp": devices})
    assert _wire(port.match_many(trs)) == _wire(ref.match_many(trs))
    if gp > 1:
        ref_a, port_a = _pair(devices, gp, viterbi_kernel="assoc")
        assert _wire(port_a.match_many(trs)) == _wire(ref_a.match_many(trs))


@pytest.mark.parametrize("devices,gp", [(2, 1), (8, 4)])
def test_matcher_sparse_wire_identical(devices, gp):
    """Sparse cohorts (60 s gaps) on the mesh, as tests/test_sparse.py:118."""
    trs = _traces(n=4, dt=60.0, seed=7, chain=False)
    ref, port = _pair(devices, gp, sparse=True, sparse_vmax_mps=16.0)
    assert port.sparse.enabled
    assert _wire(port.match_many(trs)) == _wire(ref.match_many(trs))
    assert port.sparse.dispatch


def _stream(m, trs, engine, store, step=2, batched=True):
    st = store()
    eng = engine(m, st, tail_points=512)
    for j in range(0, max(len(t["trace"]) for t in trs), step):
        batch = [{"uuid": t["uuid"], "trace": t["trace"][j:j + step], "match_options": MO}
                 for t in trs if t["trace"][j:j + step]]
        if batched:
            eng.match_many(batch)
        else:
            for item in batch:
                eng.match_many([item])
    return st


def _carry_bytes(c):
    c = carry_host(c)
    return [np.asarray(c[k]).tobytes() for k in
            ("scores", "edge", "offset", "x", "y", "t", "active", "committed")]


def _same_sessions(port_store, ref_store, trs):
    for t in trs:
        s, r = port_store.peek(t["uuid"]), ref_store.peek(t["uuid"])
        assert s.records == r.records, t["uuid"]
        assert _carry_bytes(s.carry) == _carry_bytes(r.carry), t["uuid"]


def test_slab_eviction_midstream_dp2():
    """tests/test_mesh_identity.py's mid-stream eviction: a 2-hot / 2-cold
    slab split over dp 2 churns (promotion, eviction, readback) while 6
    vehicles round-robin, against the JAX matcher at the same topology."""
    trs = _traces(n=6, pts=10, seed=9, chain=False)
    ref, port = _pair(2, session_arena=True, session_arena_bytes=SLOT_B,
                      session_arena_cold_bytes=2 * SLOT_B)
    s0 = port.session_arena.summary()
    assert s0["hot_slots"] == 2 and s0["devices"] == 2  # one slot rounds up to dp
    want = _stream(ref, trs, RefEngine, RefStore, batched=False)
    got = _stream(port, trs, SessionEngine, SessionStore, batched=False)
    _same_sessions(got, want, trs)
    s = port.session_arena.summary()
    assert s["evictions"] > 0 and s["readbacks"] > 0 and s["promotions"] > 0
    r = ref.session_arena.summary()
    assert {k: s[k] for k in ("hot_slots", "cold_slots", "devices")} == \
        {k: r[k] for k in ("hot_slots", "cold_slots", "devices")}


@pytest.mark.parametrize("kernel", ["scan", "assoc"])
def test_slab_sessions_dp2_gp4(kernel):
    """Sessions on the slot-sharded slab of a dp 2 x gp 4 matcher (the
    seam resolved over the gp ranks) against the JAX matcher's host
    carries on one device, and the host-carry session path on the mesh."""
    trs = _traces(n=4, pts=10, chain=False)
    ref, _p = _pair(viterbi_kernel=kernel)
    want = _stream(ref, trs, RefEngine, RefStore)
    _r, port = _pair(8, 4, viterbi_kernel=kernel, session_arena=True)
    assert port.session_arena.hot_slots % 2 == 0 and len(port.session_arena.hot) == 2
    _same_sessions(_stream(port, trs, SessionEngine, SessionStore), want, trs)
    _r, host = _pair(8, 4, viterbi_kernel=kernel)
    _same_sessions(_stream(host, trs, SessionEngine, SessionStore, step=5), _stream(
        ref, trs, RefEngine, RefStore, step=5), trs)


@pytest.mark.parametrize("k", [1, 8, 16, 32])
@pytest.mark.parametrize("dp", [2, 4])
def test_slab_gather_scatter_equal_reference(dp, k):
    """The slot-sharded gather (owned rows' bit patterns, psummed) and
    scatter (all-gathered carry-out, owned rows written) against
    ``_arena_gather_mesh`` / ``_arena_scatter_mesh`` under shard_map, NaN
    payloads, -0.0 and padding rows included, at beam widths of one to
    four words a lane of the kernels' warp."""
    S, B = 16, 8
    rng = np.random.default_rng(dp)
    words = rng.integers(-2 ** 31, 2 ** 31, (S, 3 * k + 5), dtype=np.int64).astype(np.int32)
    words[:, 3 * k + 3] &= 1
    words[:2, 0] = np.array([0x80000000, 0x7FC00001], np.uint32).view(np.int32)
    slab = V.carry_from_words(torch.from_numpy(words), k)
    slots = np.array([0, 1, 9, 16, 4, 12, 16, 7], np.int32)  # 16 = padding
    new = rng.integers(-2 ** 31, 2 ** 31, (B, 3 * k + 5), dtype=np.int64).astype(np.int32)
    new[:, 3 * k + 3] &= 1
    out = V.carry_from_words(torch.from_numpy(new), k)

    def ref_of(c):
        return RefCarry(*(jnp.asarray(t.numpy()) for t in c))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:dp]), ("dp",))
    gather = jax.jit(shard_map(lambda s, sl: _arena_gather_mesh(s, sl, "dp"), mesh=mesh,
                               in_specs=(P("dp"), P()), out_specs=P()))
    scatter = jax.jit(shard_map(lambda s, c, sl: _arena_scatter_mesh(s, c, sl, "dp"),
                                mesh=mesh, in_specs=(P("dp"), P("dp"), P()),
                                out_specs=P("dp")))
    want_g = gather(ref_of(slab), jnp.asarray(slots))
    want_s = scatter(ref_of(slab), ref_of(out), jnp.asarray(slots))
    s_local = S // dp
    sl = torch.from_numpy(slots)
    shards = [V.TraceCarry(*(t[r * s_local:(r + 1) * s_local].clone() for t in slab))
              for r in range(dp)]
    got_g = V.carry_from_words(collectives.psum(
        [V.slab_gather_owned(sh, sl, r * s_local) for r, sh in enumerate(shards)])[0], k)
    for g, w in zip(got_g, want_g):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    words_out = V.carry_words(out)
    for r, sh in enumerate(shards):
        V.slab_scatter_owned(sh, words_out, sl, r * s_local)
    for leaf, w in zip(zip(*shards), want_s):
        assert torch.cat(leaf).numpy().tobytes() == np.asarray(w).tobytes()


# -- configuration, rule table, collectives ------------------------------------


def test_mesh_config_rules(monkeypatch):
    _ra, pa, tables = _world()
    pu = tables["cuckoo", 1500.0][1]

    def build(device="cpu", **kw):
        return SegmentMatcher(arrays=pa, ubodt=pu, device=device,
                              config=MatcherConfig(**KW, **kw))
    with pytest.raises(ValueError, match="powers of two"):
        build(_cpu(3), devices=3)
    with pytest.raises(ValueError, match="powers of two"):
        build(_cpu(4), devices=4, graph_devices=3)
    with pytest.raises(ValueError, match="must divide"):
        build(_cpu(2), devices=2, graph_devices=4)
    # the visible cards by default: none here
    with pytest.raises(ValueError, match="only 0 device"):
        build("cuda", devices=2)
    # one device other than "cuda" is refused on a mesh, not swapped for the cards
    for one in ("cpu", "cuda:0"):
        with pytest.raises(ValueError, match="explicit device list"):
            build(one, devices=2)
    with pytest.raises(ValueError, match="only 2 device"):
        build(_cpu(2), devices=8, graph_devices=4)
    with pytest.raises(ValueError, match="tiered UBODT"):
        build(_cpu(2), devices=2, ubodt_hot_bytes=4096)
    cfg = MatcherConfig(**KW)
    monkeypatch.setenv("REPORTER_DEVICES", "8")
    monkeypatch.setenv("REPORTER_GRAPH_DEVICES", "4")
    m = SegmentMatcher(arrays=pa, ubodt=pu, device=_cpu(8), config=cfg)
    assert m._mesh.shape == {"dp": 2, "gp": 4}
    assert (m.cfg.devices, m.cfg.graph_devices) == (8, 4) and cfg.devices == 1
    assert isinstance(m._du, ShardedUBODT)
    monkeypatch.setenv("REPORTER_DEVICES", "two")
    with pytest.raises(ValueError, match="REPORTER_DEVICES must be an integer"):
        build(_cpu(8))


def test_service_config_carries_the_mesh(tmp_path):
    conf = {"network": {"type": "grid", "rows": 5, "cols": 5, "spacing_m": 150},
            "matcher": {"devices": 4, "graph_devices": 2, "ubodt_delta": 1500.0,
                        "length_buckets": [16]},
            "batch": {"max_batch": 8, "max_wait_ms": 1}}
    path = tmp_path / "svc.json"
    path.write_text(json.dumps(conf))
    cfg, conf2 = parse_service_config(str(path))
    assert (cfg.devices, cfg.graph_devices) == (4, 2)
    m = build_matcher(cfg, conf2, device=_cpu(4))
    svc = ReporterService(m, max_wait_ms=1.0)
    try:
        code, health = svc.handle_health()
        assert code == 200 and health["mesh"] == {"dp": 2, "gp": 2}
        trs = _traces(n=2, chain=False)
        code, body = svc.handle_report(dict(trs[0], match_options=MO))
        assert code == 200 and body["segment_matcher"]["segments"]
    finally:
        svc.close()


def test_rule_table():
    mesh1, mesh2 = make_mesh(2, _cpu(2)), make_mesh2(2, 2, _cpu(4))
    assert spec_for("du") == (GRAPH_AXIS,)
    assert spec_for("du", mesh1) == (None,) and spec_for("du", mesh2) == (GRAPH_AXIS,)
    assert spec_for("xin", mesh1) == (None, BATCH_AXIS)
    for name in ("pre", "carry", "aux", "slab"):
        assert spec_for(name, mesh2) == (BATCH_AXIS,)
    for name in ("dg", "p", "sp", "slots", "use"):
        assert spec_for(name, mesh2) == ()
    with pytest.raises(ValueError, match="no partition rule"):
        spec_for("mystery")
    xin = np.arange(4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    parts = place(mesh1, "xin", xin)
    assert [tuple(p.shape) for p in parts] == [(4, 3, 3)] * 2
    assert np.array_equal(torch.cat(parts, 1).numpy(), xin)
    with pytest.raises(ValueError, match="do not split"):
        place(mesh1, "xin", xin[:, :5])


def test_collectives():
    a = torch.tensor([1.0, -0.0, 5.0])
    b = torch.tensor([3.0, 2.0, -1.0])
    assert torch.equal(collectives.pmin([a, b])[1], torch.tensor([1.0, -0.0, -1.0]))
    assert torch.equal(collectives.pmax([a, b])[0], torch.tensor([3.0, 2.0, 5.0]))
    assert torch.equal(collectives.psum([a, b, a])[2], a + b + a)
    g = collectives.all_gather([a[None], b[None]], 0)
    assert len(g) == 2 and torch.equal(g[0], torch.stack([a, b]))
