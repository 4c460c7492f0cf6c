"""The staging of kernel 2's tiered probes against the JAX package.

On the card a tiered probe stages the distinct cold rows of a dispatch
before it probes (``csrc/ubodt_probe.cu``: ``ubodt_cold_mark``, then
``ubodt_cold_gather``, then the probe, which on a cuckoo table claims and
copies the cold second rows of keys their first row does not hold).  On
the CPU the plain versions run: ``TieredTable.stage_plain`` is the plain
twin of the staging list, and the plain probe counts the staging as the
card does.  Here the twin's bucket set is held
against a numpy computation from the JAX package's hashes, table and
reference tier (its hot set, the reference ``TieredTable``'s, on
conftest's virtual devices for a gp mesh); the staged probe's answers,
fetch counts and totals against the JAX package's untiered probe (its
tiered one cannot run on this container: tests/test_tiering.py); and the
kernels' claims, gather and second-row copies, emulated in numpy in one
order the card may take, against both."""

import jax
import numpy as np
import pytest
import torch

from reporter_tpu_torch.ops import _kernels
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.parallel import make_mesh2
from reporter_tpu_torch.tiles import tiering
from reporter_tpu_torch.tiles.tiering import TieredTable
from test_torch_tiering import LAYOUTS, _ref_h1, _ref_h2, _ref_lookup, _ref_tier, _world

GPS = (1, 2, 4)
ROW_BYTES = {"cuckoo": 512, "wide32": 1024}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP", "REPORTER_UBODT_HOT_BYTES",
                "REPORTER_UBODT_SHARD", "REPORTER_DEVICES", "REPORTER_GRAPH_DEVICES"):
        monkeypatch.delenv(var, raising=False)


def _keys(seed, n=(2, 24, 5, 4), hi=30):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, size=n).astype(np.int32),
            rng.integers(0, hi, size=n).astype(np.int32))


def _budgets(layout):
    """1 byte (every row cold), a part of a rank's range, a rank's whole
    range at gp 1 (every row hot)."""
    n_buckets = _world()[2][layout][0].n_buckets
    return (1, 6 * ROW_BYTES[layout], n_buckets * ROW_BYTES[layout])


def _tiers(layout, hot_bytes, gp):
    """(port tier, reference tier) of the layout's table at ``hot_bytes``
    a rank over ``gp`` ranks; the reference on conftest's virtual
    devices."""
    _ra, _pa, tables = _world()
    ru, pu = tables[layout]
    if gp == 1:
        return TieredTable(pu, hot_bytes, device="cpu"), _ref_tier(ru, hot_bytes)
    if len(jax.devices()) < gp:
        pytest.skip("needs %d virtual devices" % gp)
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:gp]).reshape(1, gp), ("dp", "gp"))
    return (TieredTable(pu, hot_bytes, mesh=make_mesh2(1, gp, ["cpu"] * gp)),
            _ref_tier(ru, hot_bytes, mesh=mesh, n_gp=gp))


def _cold_rows_numpy(ru, hot, s, d, lo, n):
    """The distinct cold buckets (offsets in [lo, lo + n)) the probe reads
    for keys (s, d), from the JAX package's hashes and table and the
    reference tier's hot set: each key's first row in the range, and on a
    cuckoo table its second row in the range unless its first row is in
    the range and holds the key."""
    bmask = int(ru.bmask)
    s, d = (np.asarray(x).reshape(-1) for x in np.broadcast_arrays(s, d))
    h1 = np.asarray(_ref_h1(s, d, bmask)).astype(np.int64)
    in1 = (h1 >= lo) & (h1 < lo + n)
    read = [h1[in1]]
    if ru.layout == "cuckoo":
        rows = np.asarray(ru.packed).reshape(ru.n_buckets, -1, 8)[h1]
        held = ((rows[:, :, 0] == s[:, None]) & (rows[:, :, 1] == d[:, None])).any(1)
        h2 = np.asarray(_ref_h2(s, d, bmask)).astype(np.int64)
        read.append(h2[(h2 >= lo) & (h2 < lo + n) & ~(in1 & held)])
    b = np.unique(np.concatenate(read))
    return b[~np.isin(b, hot)] - lo


def _warm(tier, ref, s, d):
    """One window of the keys' counts on both tiers, then a pass: the hot
    sets become the keys' most probed buckets, not a prefix."""
    counts = np.zeros(tier.n_buckets, np.int64)
    for h in (_ref_h1,) if tier.ubodt.layout == "wide32" else (_ref_h1, _ref_h2):
        counts += np.bincount(np.asarray(h(s, d, int(tier.ubodt.bmask))).reshape(-1),
                              minlength=tier.n_buckets)
    ref._counts[:] = counts
    for r in tier._ranks.values():
        r.counts += torch.from_numpy(counts[r.lo:r.lo + r.n].astype(np.int32))
    assert tier.maintain() == ref.maintain()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gp", GPS)
@pytest.mark.parametrize("occ", [0, 1, 2])
@pytest.mark.parametrize("warm", [False, True])
def test_stage_plain_is_the_cold_rows_read(layout, gp, occ, warm):
    """The plain twin's bucket set, per rank, equals the numpy computation
    of the distinct cold rows the probe reads (the second-row skip and the
    rank's range honoured, the hot set the reference tier's), as seeded
    and after a pass that makes the keys' most probed buckets hot."""
    ru = _world()[2][layout][0]
    tier, ref = _tiers(layout, _budgets(layout)[occ], gp)
    s, d = _keys(gp * 10 + occ)
    if warm:
        _warm(tier, ref, s, d)
    hot = ref.hot_buckets()
    np.testing.assert_array_equal(tier.hot_buckets(), hot)
    total = 0
    for g in range(gp):
        r = tier.rank(g)
        want = _cold_rows_numpy(ru, hot, s, d, r.lo, r.n)
        got = tier.stage_plain(torch.from_numpy(s), torch.from_numpy(d), r)
        np.testing.assert_array_equal(got.numpy(), want)
        total += len(want)
    if occ == 0:  # every row cold: the twin reads the keys' rows
        assert total > 0
    if occ == 2 and gp == 1 and warm:  # the whole table hot after a pass
        assert total == 0


def test_stage_plain_honours_the_skip_and_the_range():
    """A key its first row holds stages no second row; a key whose first
    row lies outside the rank's range stages its second row there; the
    twin depends on the distinct keys alone."""
    _ra, pa, tables = _world()
    ru, pu = tables["cuckoo"]
    rows = pu.rows()
    s, d = rows[0][:200].astype(np.int32), rows[1][:200].astype(np.int32)
    bmask = int(pu.bmask)
    h1 = np.asarray(_ref_h1(s, d, bmask)).astype(np.int64)
    h2 = np.asarray(_ref_h2(s, d, bmask)).astype(np.int64)
    held = np.asarray([(ru.packed.reshape(ru.n_buckets, -1, 8)[b, :, :2] == [x, y]).all(1).any()
                       for b, x, y in zip(h1, s, d)])
    tier = TieredTable(pu, 1, device="cpu")
    got = tier.stage_plain(torch.from_numpy(s), torch.from_numpy(d)).numpy()
    want = np.unique(np.concatenate([h1, h2[~held]]))
    np.testing.assert_array_equal(got, want)
    assert held.any() and (~held).any()  # both branches of the skip
    # repeats change nothing
    again = tier.stage_plain(torch.from_numpy(np.tile(s, 3)), torch.from_numpy(np.tile(d, 3)))
    np.testing.assert_array_equal(again.numpy(), got)
    gp = TieredTable(pu, 1, mesh=make_mesh2(1, 2, ["cpu"] * 2))
    for g in range(2):
        r = gp.rank(g)
        in1 = (h1 >= r.lo) & (h1 < r.lo + r.n)
        in2 = (h2 >= r.lo) & (h2 < r.lo + r.n)
        want = np.unique(np.concatenate([h1[in1], h2[in2 & ~(in1 & held)]])) - r.lo
        np.testing.assert_array_equal(
            gp.stage_plain(torch.from_numpy(s), torch.from_numpy(d), r).numpy(), want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gp", GPS)
@pytest.mark.parametrize("occ", [0, 1, 2])
def test_staged_probe_equals_jax(layout, gp, occ):
    """The staged plain probe of every rank, merged by pmin / pmax, equals
    the JAX package's untiered probe bit for bit; each rank's fetch
    counts are the bincount of its range's home buckets and its hit /
    miss totals split them by its hot set; its staged and in-place rows
    sum to its twin's cold rows, all staged below the capacity."""
    ru, pu = _world()[2][layout]
    tier, ref = _tiers(layout, _budgets(layout)[occ], gp)
    s, d = _keys(occ + 3)
    want = _ref_lookup(ru.to_device(), s, d, dedup=False)
    hot = ref.hot_buckets()
    hs = [_ref_h1] if layout == "wide32" else [_ref_h1, _ref_h2]
    home = sum(np.bincount(np.asarray(h(s, d, int(pu.bmask))).reshape(-1),
                           minlength=pu.n_buckets) for h in hs)
    twin = {r.g: tier.stage_plain(torch.from_numpy(s), torch.from_numpy(d), r).numel()
            for r in tier._ranks.values()}
    got = H.ubodt_lookup(tier.device(), torch.from_numpy(s), torch.from_numpy(d))
    for a, b in zip(want, got):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    for r in tier._ranks.values():
        mine = home[r.lo:r.lo + r.n]
        np.testing.assert_array_equal(r.counts.numpy(), mine)
        is_hot = np.isin(np.arange(r.lo, r.lo + r.n), hot)
        assert r.totals.tolist() == [int(mine[is_hot].sum()), int(mine[~is_hot].sum())]
        assert r.stage_stats.tolist() == [twin[r.g], 0]
        assert twin[r.g] == len(_cold_rows_numpy(ru, hot, s, d, r.lo, r.n))
    summ = tier.stage_summary()
    assert summ["staged_rows"] == sum(twin.values()) and summ["inplace_cold_rows"] == 0
    assert summ["stage_rows_cap"] == tier.rank().stage_cap


@pytest.mark.parametrize("layout", LAYOUTS)
def test_capacity_overflow_reads_in_place(layout, monkeypatch):
    """Past the staging capacity (a module constant, here shrunk to 5
    rows) the rest of a dispatch's cold rows count as read in place; the
    answers stay the JAX package's."""
    ru, pu = _world()[2][layout]
    monkeypatch.setattr(tiering, "STAGE_BYTES", 5 * ROW_BYTES[layout])
    tier = TieredTable(pu, 1, device="cpu")
    assert tier.rank().stage_cap == 5
    s, d = _keys(5)
    n_cold = tier.stage_plain(torch.from_numpy(s), torch.from_numpy(d)).numel()
    assert n_cold > 5
    got = H.ubodt_lookup(tier.device(), torch.from_numpy(s), torch.from_numpy(d))
    for a, b in zip(_ref_lookup(ru.to_device(), s, d, dedup=False), got):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert tier.stage_summary()["staged_rows"] == 5
    assert tier.stage_summary()["inplace_cold_rows"] == n_cold - 5


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dedup_stages_the_distinct_keys_only(layout):
    """The deduplicated probe stages its compact keys' cold rows (the
    twin's rows of every key: the set depends on the distinct keys alone),
    never the compact buffer's (0, 0) tail; past the budget the card's
    scatter probes every key in place, so nothing is staged."""
    ru, pu = _world()[2][layout]
    tier = TieredTable(pu, 1, device="cpu")
    tdu = tier.device()
    s, d = _keys(9, n=(2, 64, 5, 4), hi=20)
    want = _ref_lookup(ru.to_device(), s, d, dedup=True)
    n_cold = tier.stage_plain(torch.from_numpy(s), torch.from_numpy(d)).numel()
    got = H.ubodt_lookup(tdu, torch.from_numpy(s), torch.from_numpy(d), dedup=True)
    for a, b in zip(want, got):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert tier.stage_summary()["staged_rows"] == n_cold
    s, d = _keys(10, n=(2, 64, 5, 4), hi=1000)  # past the budget
    before = tier.stage_summary()["staged_rows"]
    r = H.ubodt_lookup_dedup(tdu, torch.from_numpy(s), torch.from_numpy(d))
    assert int(r.n_unique[0]) > r.m
    assert tier.stage_summary()["staged_rows"] == before


# -- the kernels' staging emulated in numpy ---------------------------------------------

_OVER = -2


def _emulate(ru, rank_slot, lo, n, cap, s, d):
    """kernel 2's staged probe of one rank in numpy, in one order the card
    may take (keys in order): the mark claims each key's cold first row in
    the range (slot = claims so far; past ``cap`` over); the gather copies
    those slots; the probe reads a first row from the arena (the page),
    its slot's copy or the page (over), and for a cuckoo key not found
    there its second row in the range: hot, staged already, or claimed now
    and copied by the probe, or over (in place).  Returns (dist, time,
    first, the staged buckets in slot order, rows read in place, slots the
    probe copied)."""
    pages = np.asarray(ru.packed).reshape(ru.n_buckets, -1)
    bmask = int(ru.bmask)
    s, d = (np.asarray(x).reshape(-1) for x in np.broadcast_arrays(s, d))
    h = [np.asarray(_ref_h1(s, d, bmask)).astype(np.int64) - lo]
    if ru.layout == "cuckoo":
        h.append(np.asarray(_ref_h2(s, d, bmask)).astype(np.int64) - lo)
    smap, lst, over = {}, [], [0]

    def claim(b):
        if b not in smap:
            slot = len(smap)  # the claims so far
            smap[b] = slot if slot < cap else _OVER
            if slot < cap:
                lst.append(b)
            else:
                over[0] += 1
        return smap[b]

    for i in range(len(s)):  # the mark
        b = h[0][i]
        if 0 <= b < n and rank_slot[b] < 0:
            claim(b)
    copies = {sl: pages[b + lo] for sl, b in enumerate(lst)}  # the gather
    gathered = len(copies)

    def row(b):
        if rank_slot[b] >= 0:
            return pages[b + lo]
        e = smap.get(b, _OVER)
        return copies[e] if e >= 0 else pages[b + lo]

    def select(r, x, y):
        e = r.reshape(-1, 8)
        hit = (e[:, 0] == x) & (e[:, 1] == y)
        if not hit.any():
            return None
        return (e[hit, 2].view(np.float32).min(), e[hit, 3].view(np.float32).min(),
                e[hit, 4].max())

    out = [(np.float32(np.inf), np.float32(np.inf), -1)] * len(s)
    for i in range(len(s)):  # the probe
        found = False
        b = h[0][i]
        if 0 <= b < n:
            r = select(row(b), s[i], d[i])
            if r is not None:
                out[i], found = r, True
        if len(h) > 1 and not found and 0 <= h[1][i] < n:
            b = h[1][i]
            if rank_slot[b] < 0:
                e = claim(b)
                if e >= 0 and e not in copies:  # the claiming warp copies it
                    copies[e] = pages[b + lo]
            r = select(row(b), s[i], d[i])
            if r is not None:
                out[i] = r
    dist, time_, first = (np.asarray(x) for x in zip(*out))
    return (dist.astype(np.float32), time_.astype(np.float32), first.astype(np.int32),
            np.asarray(lst, np.int64), over[0], len(copies) - gathered)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gp", [1, 4])
@pytest.mark.parametrize("cap", [None, 4])
def test_emulated_staging_equals_jax_and_the_twin(layout, gp, cap):
    """The emulated claims, gather and probe of every rank, merged by min /
    max, equal the JAX package's untiered probe bit for bit; each rank's
    staged set is its twin's (the first ``cap`` claims of it past the
    capacity, the rest read in place); the wide32 probe copies no row (only
    a cuckoo second row escapes the mark)."""
    ru, pu = _world()[2][layout]
    tier, ref = _tiers(layout, _budgets(layout)[1], gp)
    s, d = _keys(gp + 40)
    want = _ref_lookup(ru.to_device(), s, d, dedup=False)
    parts, copied = [], 0
    for r in tier._ranks.values():
        c = r.n if cap is None else cap
        dist, time_, first, lst, over, by_probe = _emulate(
            ru, r.slot_map.numpy(), r.lo, r.n, c, s, d)
        twin = tier.stage_plain(torch.from_numpy(s), torch.from_numpy(d), r).numpy()
        assert len(lst) == min(len(twin), c) and over == len(twin) - len(lst)
        assert len(np.unique(lst)) == len(lst) and np.isin(lst, twin).all()
        copied += by_probe
        parts.append((dist, time_, first))
    if layout == "wide32":
        assert copied == 0
    dist = np.minimum.reduce([p[0] for p in parts])
    time_ = np.minimum.reduce([p[1] for p in parts])
    first = np.maximum.reduce([p[2] for p in parts])
    for a, b in zip(want, (dist, time_, first)):
        assert np.asarray(a).reshape(-1).tobytes() == b.tobytes()


def test_staging_kernels_registered():
    """The mark and gather are kernel 2's library's entry points with
    launch counters and the probe's stage label; every tiered probe takes
    the staging arguments last, before the stream; the capacity is the
    module constant (a rank's range at most)."""
    for name in ("ubodt_cold_mark", "ubodt_cold_gather"):
        k = _kernels.KERNELS[name]
        assert k.base == "ubodt_probe" and k.entry == name and k.launches >= 0
        assert k.stage == _kernels.KERNELS["ubodt_probe"].stage
    for name in ("ubodt_probe[tiered]", "ubodt_probe[wide32,tiered]",
                 "ubodt_probe[tiered,sharded]", "ubodt_probe[wide32,tiered,sharded]"):
        assert _kernels.KERNELS[name].argtypes[-len(_kernels._STAGE):] == _kernels._STAGE
    pu = _world()[2]["cuckoo"][1]
    t = TieredTable(pu, 1, device="cpu")
    assert t.rank().stage_cap == min(t.shard_len, tiering.STAGE_BYTES // 512)
    assert t.stage_summary() == {"staged_rows": 0, "inplace_cold_rows": 0,
                                 "stage_rows_cap": t.rank().stage_cap, "stage_bytes": 16}


def test_parent_probe_adapter():
    """``chip_smoke._unstaged``: a tree from before the staged probe gets
    its own arguments, the staging dropped and the stream kept."""
    import chip_smoke

    seen = []
    fn = chip_smoke._unstaged(lambda *a: seen.append(a) or 0, len(_kernels._STAGE))
    args = tuple(range(17)) + tuple("s%d" % i for i in range(len(_kernels._STAGE)))
    assert fn(*args, "stream") == 0 and seen == [tuple(range(17)) + ("stream",)]
