"""The port's tiered UBODT on a dp x gp device mesh against the JAX package.

The reference composes tiering with its mesh (tests/test_tiering.py::
test_mesh_composes_tiering): the arena, slot map and pages split by the
gp probe's bucket ranges, ``hot_bytes`` is a per-chip budget, and the
meshed, tiered matcher answers as the untiered single-device one.  Its own
tiered lookups fail on this container (its pinned_host pages refuse the
jitted gather), so every answer here is held against the JAX package's
UNTIERED matcher and probe, as tests/test_torch_tiering.py does.  The
hot sets are held against a reference ``TieredTable(mesh=..., n_gp=...)``
on conftest's virtual devices: the seed of every rank, and each range's
selection from the same EWMA.  On the CPU every rank runs the plain
versions, which fetch, count and total the rows the ``[tiered,sharded]``
kernels do."""

import json

import jax
import numpy as np
import pytest
import torch

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.ops import _kernels
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.parallel import make_mesh, make_mesh2
from reporter_tpu_torch.parallel.mesh import place
from reporter_tpu_torch.tiles.tiering import TieredTable
from reporter_tpu_torch.tiles.ubodt import ShardedUBODT
from test_torch_tiering import LAYOUTS, _ref_lookup, _ref_tier, _world, fleet_traces

MESHES = ((2, 1), (8, 4), (4, 2))  # (devices, gp)
BUDGETS = (1, 4096, 1 << 30)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Every matcher reads these when it is built."""
    for var in ("REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP", "REPORTER_OBS_PROBE_EVERY",
                "REPORTER_SPARSE", "REPORTER_CALIBRATION", "REPORTER_SESSION_ARENA",
                "REPORTER_UBODT_HOT_BYTES", "REPORTER_UBODT_SHARD", "REPORTER_VITERBI",
                "REPORTER_DEVICES", "REPORTER_GRAPH_DEVICES", "REPORTER_INTERPOLATE"):
        monkeypatch.delenv(var, raising=False)


_REF_WIRE = {}


def _ref_wire(layout, traces):
    """The JAX package's untiered single-device answers, as wire JSON."""
    if layout not in _REF_WIRE:
        ra, _pa, tables = _world()
        ref = RefMatcher(arrays=ra, ubodt=tables[layout][0], backend="jax",
                         config=RefConfig(ubodt_layout=layout, length_buckets=[16]))
        _REF_WIRE[layout] = json.dumps(ref.match_many(traces), sort_keys=True)
    return _REF_WIRE[layout]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("devices,gp", MESHES)
@pytest.mark.parametrize("hot_bytes", BUDGETS)
def test_mesh_tiered_matcher_equals_untiered_jax(layout, devices, gp, hot_bytes):
    """A tiered matcher on devices=["cpu"] * n at (devices, gp) answers the
    JAX package's untiered single-device matcher's wire, before and after
    a maintenance pass; the budget is a rank's, and every probe's fetches
    land on the rank whose range holds the bucket."""
    ra, pa, tables = _world()
    traces = fleet_traces(ra, n=6)
    m = SegmentMatcher(arrays=pa, ubodt=tables[layout][1], device=["cpu"] * devices,
                       config=MatcherConfig(devices=devices, graph_devices=gp,
                                            ubodt_hot_bytes=hot_bytes,
                                            ubodt_layout=layout, length_buckets=[16]))
    t = m.tiering
    assert t is not None and t.n_gp == gp
    s = t.summary()
    assert s["hot_bytes_total"] == s["hot_bytes"] * gp == hot_bytes * gp
    assert s["capacity_rows_total"] == t.capacity * gp and s["devices"] == gp
    want = _ref_wire(layout, traces)
    assert json.dumps(m.match_many(traces), sort_keys=True) == want
    fetched = t.hits + t.misses
    assert fetched > 0
    t.maintain()
    assert json.dumps(m.match_many(traces), sort_keys=True) == want
    # the second call fetched the same rows as the first
    assert t.hits + t.misses == 2 * fetched
    if gp > 1:
        assert isinstance(m._du, ShardedUBODT)
        assert H.probe_kernel_name(m._du.shards[0]) == (
            "ubodt_probe[wide32,tiered,sharded]" if layout == "wide32"
            else "ubodt_probe[tiered,sharded]")
    if t.capacity >= t.shard_len:
        assert t.resident_rows == t.n_buckets and t.hits > 0


def _virtual_mesh(devices, gp):
    """The reference's mesh on conftest's virtual CPU devices."""
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices()[:devices]).reshape(devices // gp, gp)
    return Mesh(devs, ("dp", "gp"))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("devices,gp", [(8, 4), (4, 2), (2, 2)])
@pytest.mark.parametrize("hot_bytes,shard", [(4096, None), (2048, (1, 4)),
                                             (1 << 30, None), (1, None)])
def test_rank_hot_sets_equal_reference(layout, devices, gp, hot_bytes, shard):
    """Each gp rank's seeded hot set, and its selection from one EWMA
    after a maintenance pass, equal the reference ``TieredTable(mesh=...,
    n_gp=...)``'s; the summary too (but where the cold pages live)."""
    if len(jax.devices()) < devices:
        pytest.skip("needs %d virtual devices" % devices)
    _ra, _pa, tables = _world()
    ru, pu = tables[layout]
    ref = _ref_tier(ru, hot_bytes, shard=shard, mesh=_virtual_mesh(devices, gp), n_gp=gp)
    tier = TieredTable(pu, hot_bytes, shard=shard,
                       mesh=make_mesh2(devices // gp, gp, ["cpu"] * devices))
    assert (tier.capacity, tier.shard_len) == (ref.capacity, ref.shard_len)
    np.testing.assert_array_equal(tier.hot_buckets(), ref.hot_buckets())
    drop = ("cold_memory_kind",)
    assert {k: v for k, v in tier.summary().items() if k not in drop} == \
        {k: v for k, v in ref.summary().items() if k not in drop}
    # both fold one window of counts (skewed to the top of each range)
    rng = np.random.default_rng(gp)
    counts = rng.integers(0, 3, tier.n_buckets) * (np.arange(tier.n_buckets) % 7 == 3)
    ref._counts[:] = counts
    for r in tier._ranks.values():
        r.counts += torch.from_numpy(counts[r.lo:r.lo + r.n].astype(np.int32))
    assert tier.maintain() == ref.maintain()
    np.testing.assert_array_equal(tier.hot_buckets(), ref.hot_buckets())
    np.testing.assert_array_equal(tier._ewma, ref._ewma)
    for g in range(gp):
        lo, hi = g * tier.shard_len, (g + 1) * tier.shard_len
        mine = tier._hot_g[g]
        assert ((mine >= lo) & (mine < hi)).all() and len(mine) <= tier.capacity
        r = tier.rank(g)
        # the rank's slot map names exactly its hot buckets, local slots
        held = np.flatnonzero(r.slot_map.numpy() >= 0) + lo
        np.testing.assert_array_equal(held, mine)
        for b in mine:
            row = r.arena[int(r.slot_map[b - lo])]
            assert torch.equal(row, tier.pages_t[b])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gp", [2, 4])
def test_rank_probes_equal_untiered_and_sum_its_fetches(layout, gp):
    """The plain ``[tiered,sharded]`` probes of every gp rank merged by pmin
    / pmax equal the JAX package's untiered probe bit for bit; each rank
    counts only its range's fetches, and the ranks' counts and totals sum
    to the one-rank tier's for the same keys, at three occupancies."""
    _ra, _pa, tables = _world()
    ru, pu = tables[layout]
    rng = np.random.default_rng(gp)
    s = rng.integers(0, 30, size=(3, 16, 5, 4)).astype(np.int32)
    d = rng.integers(0, 30, size=(3, 16, 5, 4)).astype(np.int32)
    want = _ref_lookup(ru.to_device(), s, d, dedup=False)
    for hot_bytes in BUDGETS:
        one = TieredTable(pu, hot_bytes, device="cpu")
        tier = TieredTable(pu, hot_bytes, mesh=make_mesh2(1, gp, ["cpu"] * gp))
        for t in (one, tier):
            t.maintain()  # a pass over empty counts: the seeds stay
        du = tier.device()
        assert isinstance(du, ShardedUBODT) and len(du.shards) == gp
        got = H.ubodt_lookup(du, torch.from_numpy(s), torch.from_numpy(d))
        for a, b in zip(want, got):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
        H.ubodt_lookup(one.device(), torch.from_numpy(s), torch.from_numpy(d))
        np.testing.assert_array_equal(tier.window_counts(), one.window_counts())
        ranks = list(tier._ranks.values())
        assert len(ranks) == gp
        for r in ranks:
            np.testing.assert_array_equal(r.counts.numpy(),
                                          one.window_counts()[r.lo:r.lo + r.n])
        # the hot / cold split differs (a rank's budget is its own)
        totals = sum(r.totals for r in ranks)
        assert totals.sum() == one.totals.sum() == one.window_counts().sum()


def test_place_splits_a_tier_like_the_table():
    """``place`` gives each dp rank its row's rank views over the one
    manager: the gp ranks in order on their devices, ranks that share a
    device sharing one copy; a dp-only mesh gives each rank the whole
    tier."""
    _ra, _pa, tables = _world()
    pu = tables["cuckoo"][1]
    mesh = make_mesh2(2, 4, ["cpu"] * 8)
    tier = TieredTable(pu, 4096, mesh=mesh)
    rows = place(mesh, "du", tier)
    assert len(rows) == 2 and all(isinstance(r, ShardedUBODT) for r in rows)
    for r in rows:
        assert [sh.lo for sh in r.shards] == [g * tier.shard_len for g in range(4)]
        assert all(sh.tier is tier for sh in r.shards)
    assert [sh.rank for sh in rows[0].shards] == [sh.rank for sh in rows[1].shards]
    flat = make_mesh(2, ["cpu"] * 2)
    t1 = TieredTable(pu, 4096, mesh=flat)
    views = place(flat, "du", t1)
    assert [v.sharded for v in views] == [False, False]
    assert views[0].rank is views[1].rank and views[0].local_buckets == pu.n_buckets


def test_host_ranges_register_once(monkeypatch):
    """A range inside a registered host buffer takes a reference to it and
    its address at the same offset (no second registration, which CUDA
    refuses); a straddling range raises; the last reference unregisters
    the buffer once."""
    calls = []

    class Lib:
        def ubodt_host_unregister(self, addr):
            calls.append(addr.value)
            return 0

    monkeypatch.setattr(_kernels, "_HOST", {0x1000: [0x9000, 1, 0x400]})
    monkeypatch.setattr(_kernels, "_probe_lib", lambda: Lib())
    assert _kernels.host_register(0x1100, 0x100) == 0x9100
    assert _kernels._HOST[0x1000][1] == 2
    with pytest.raises(ValueError, match="overlaps"):
        _kernels.host_register(0x1300, 0x200)
    _kernels.host_unregister(0x1100)
    assert calls == [] and _kernels._HOST[0x1000][1] == 1
    _kernels.host_unregister(0x1000)
    assert calls == [0x1000] and _kernels._HOST == {}
