"""The port's stream checkpoints against the JAX package's, on the CPU:
snapshots equal the reference's for the same fed lines (and load into
either package), a restore mid-stream equals an uninterrupted run (a
deterministic stub matcher and the port's matcher on a 5 x 5 grid), a
corrupt file is set aside and a version mismatch refused, the partition
runner hands in-flight windows across a rebalance, and ``kafka_io`` keeps
its commit-after-snapshot protocol over the in-memory stand-in broker of
``tests/test_kafka_io.py``.  Nothing here waits on a wall-clock ratio or
on when a signal arrives: the one SIGTERM is sent from inside a feed."""

import json
import os
import signal
import sys

import numpy as np
import pytest

from reporter_tpu.stream import anonymiser as ref_anonymiser
from reporter_tpu.stream import batcher as ref_batcher
from reporter_tpu.stream import checkpoint as ref_checkpoint
from reporter_tpu.stream import formatter as ref_formatter
from reporter_tpu.stream import topology as ref_topology
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.stream import anonymiser as port_anonymiser
from reporter_tpu_torch.stream import batcher as port_batcher
from reporter_tpu_torch.stream import formatter as port_formatter
from reporter_tpu_torch.stream import kafka_io
from reporter_tpu_torch.stream import topology as port_topology
from reporter_tpu_torch.stream.checkpoint import (
    Checkpointer,
    PartitionCheckpointer,
    PartitionedStreamRunner,
    load_file,
    restore,
    save_file,
    snapshot,
)
from reporter_tpu_torch.stream.client import LocalMatcherClient
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.network import grid_city
from test_kafka_io import FakeBroker, ScriptedPipeline, fake_kafka_module

SV = ",sv,\\|,0,2,3,1,4"
T0 = 1_460_000_000
PORT = (port_anonymiser, port_batcher, port_formatter, port_topology)
REF = (ref_anonymiser, ref_batcher, ref_formatter, ref_topology)


class NullClient:
    """Never reports: everything stays in flight."""

    def report_many(self, requests):
        return [None] * len(requests)


class StubClient:
    """Deterministic matcher stand-in: one segment pair per consecutive
    point pair, ids from the uuid; keeps the last point in flight."""

    def report_many(self, requests):
        out = []
        for r in requests:
            pts = r["trace"]
            uid = int("".join(c for c in r["uuid"] if c.isdigit()) or 0)
            out.append({"shape_used": len(pts) - 1, "datastore": {"reports": [
                {"id": 1000 * (uid + 1) + i, "next_id": 1000 * (uid + 1) + i + 1,
                 "t0": float(pts[i]["time"]), "t1": float(pts[i + 1]["time"]),
                 "length": 120, "queue_length": 0} for i in range(len(pts) - 1)]}})
        return out


def _pipeline(mods, client, out, microbatch=4, gate=(0, 4, 0), slice_size=None):
    anon_m, batcher_m, fmt_m, topo_m = mods
    kw = {} if slice_size is None else {"slice_size": slice_size}
    anon = anon_m.AnonymisingProcessor(privacy=1, quantisation=3600, output=str(out),
                                       source="CKPT", flush_interval_sec=10 ** 9, **kw)
    batcher = batcher_m.BatchingProcessor(
        client=client, sink=anon.process, microbatch_size=microbatch,
        report_dist=gate[0], report_count=gate[1], report_time=gate[2])
    return topo_m.StreamPipeline(fmt_m.Formatter.from_config(SV), batcher, anon)


def _records(n=36, vehicles=3):
    return ["veh-%d|%d|%0.6f|%0.6f|5" % (i % vehicles, T0 + (i // vehicles) * 15,
                                         37.75 + (i // vehicles) * 5e-3,
                                         -122.44 + (i // vehicles) * 5e-3) for i in range(n)]


def tile_rows(*dirs):
    rows = []
    for d in dirs:
        for root, _, files in os.walk(d):
            for f in files:
                with open(os.path.join(root, f)) as fh:
                    body = fh.read().strip().splitlines()
                rows.extend((os.path.relpath(root, d), ln) for ln in body[1:])
    return sorted(rows)


# -- snapshots ------------------------------------------------------------


@pytest.mark.parametrize("client", [NullClient, StubClient])
def test_snapshot_equals_reference(client, tmp_path):
    """The same lines into both packages' pipelines give equal snapshots,
    and a snapshot written by either loads into the other."""
    snaps = []
    for name, mods in (("port", PORT), ("ref", REF)):
        p = _pipeline(mods, client(), tmp_path / name, microbatch=2, slice_size=3)
        for i, raw in enumerate(_records(20) + ["garbage"]):
            p.feed(raw, (T0 + i) * 1000)
        snaps.append(json.loads(json.dumps((snapshot if mods is PORT
                                            else ref_checkpoint.snapshot)(p))))
    assert snaps[0] == snaps[1]
    assert snaps[0]["batcher"]["store"] and snaps[0]["dropped"] == 1
    if client is StubClient:
        assert snaps[0]["anonymiser"]["slices"]
    for mods, rest in ((PORT, restore), (REF, ref_checkpoint.restore)):
        q = _pipeline(mods, client(), tmp_path / "x", microbatch=2, slice_size=3)
        rest(q, snaps[1] if mods is PORT else snaps[0])
        assert json.loads(json.dumps((snapshot if mods is PORT
                                      else ref_checkpoint.snapshot)(q))) == snaps[0]


def test_roundtrip_preserves_inflight_state(tmp_path):
    p1 = _pipeline(PORT, NullClient(), tmp_path / "o1", microbatch=1000, gate=(500, 10, 60))
    for i, raw in enumerate(_records(9)):
        p1.feed(raw, (T0 + i) * 1000)
    ck = str(tmp_path / "state.ckpt")
    save_file(p1, ck)
    p2 = _pipeline(PORT, NullClient(), tmp_path / "o2", microbatch=1000, gate=(500, 10, 60))
    assert load_file(p2, ck)
    assert set(p2.batcher.store) == set(p1.batcher.store)
    for k, a in p1.batcher.store.items():
        b = p2.batcher.store[k]
        # the serde stores max_separation as f32 (Batch.java:92-146's layout)
        assert np.float32(a.max_separation) == np.float32(b.max_separation)
        assert a.last_update == b.last_update
        assert [p.pack() for p in a.points] == [p.pack() for p in b.points]
    assert p2.formatted == p1.formatted and p2.anonymiser.map == p1.anonymiser.map


@pytest.mark.parametrize("cut", [7, 20, 29])
def test_restore_mid_stream_equals_uninterrupted(cut, tmp_path):
    """Lines 0..cut-1, a checkpoint, a fresh pipeline restored from it (in
    the port, and in the JAX package from the port's file), the rest: the
    tiles equal one uninterrupted run's."""
    recs = _records()

    def feed(p, lo, hi):
        for i in range(lo, hi):
            p.feed(recs[i], T0 * 1000 + i)
    whole = _pipeline(PORT, StubClient(), tmp_path / "whole")
    feed(whole, 0, len(recs))
    whole.close()
    want = tile_rows(tmp_path / "whole")
    assert want
    first = _pipeline(PORT, StubClient(), tmp_path / "first")
    feed(first, 0, cut)
    ck = str(tmp_path / "cut.ckpt")
    save_file(first, ck)
    for name, mods, load in (("port", PORT, load_file), ("ref", REF, ref_checkpoint.load_file)):
        second = _pipeline(mods, StubClient(), tmp_path / name)
        assert load(second, ck) and second.formatted == cut
        feed(second, cut, len(recs))
        second.close()
        assert tile_rows(tmp_path / "first", tmp_path / name) == want, name


def test_restore_mid_stream_with_the_port_matcher(tmp_path):
    """The port's matcher on the CPU behind the pipeline: a checkpoint
    after half of the lines, restored into a fresh pipeline and fed the
    rest, gives the uninterrupted run's tiles (lat / lon at float32, the
    point serde's precision, so the restored points are the fed ones)."""
    m = SegmentMatcher(network=grid_city(5, 5, 150.0), config=MatcherConfig(), device="cpu")
    synth = TraceSynthesizer(m.arrays, seed=7)
    rows = []
    for v in range(4):
        st = synth.synthesize(24, dt=15.0, sigma=3.0, uuid="veh-%d" % v)
        rows.extend((int(p["time"]), v, "veh-%d|%d|%r|%r|%d" % (
            v, int(p["time"]), float(np.float32(p["lat"])), float(np.float32(p["lon"])),
            p["accuracy"])) for p in st.trace["trace"])
    lines = [r[2] for r in sorted(rows)]

    def run(out, lo, hi, ckpt_in=None, ckpt_out=None):
        p = port_topology.build_pipeline(
            format_config=SV, client=LocalMatcherClient(m), privacy=1, quantisation=3600,
            output=str(out), source="CI", report_levels=(0, 1, 2),
            transition_levels=(0, 1, 2), microbatch_size=4)
        p.batcher.report_dist, p.batcher.report_count, p.batcher.report_time = 200, 8, 30
        if ckpt_in:
            assert load_file(p, ckpt_in)
        for line in lines[lo:hi]:
            p.feed(line, int(line.split("|")[1]) * 1000)
        if ckpt_out:
            save_file(p, ckpt_out)
        else:
            p.close()
    run(tmp_path / "whole", 0, len(lines))
    want = tile_rows(tmp_path / "whole")
    assert want
    half = len(lines) // 2
    ck = str(tmp_path / "half.ckpt")
    run(tmp_path / "a", 0, half, ckpt_out=ck)
    run(tmp_path / "b", half, len(lines), ckpt_in=ck)
    assert tile_rows(tmp_path / "a", tmp_path / "b") == want


def test_missing_corrupt_and_version_mismatch(tmp_path):
    p = _pipeline(PORT, NullClient(), tmp_path / "o", microbatch=1000)
    assert not load_file(p, str(tmp_path / "nope.ckpt")) and p.batcher.store == {}
    with pytest.raises(ValueError):
        restore(p, {"version": 99})
    p1 = _pipeline(PORT, NullClient(), tmp_path / "o5", microbatch=1000, gate=(500, 10, 60))
    for i, raw in enumerate(_records(6)):
        p1.feed(raw, (T0 + i) * 1000)
    ck = str(tmp_path / "state.ckpt")
    save_file(p1, ck)
    # a mid-restore failure: restore() mutates counters before it fails,
    # so the rollback must cover them all
    partial = json.loads(open(ck).read())
    partial["dropped"] = 7
    partial["batcher"]["reported_pairs"] = 9
    partial["anonymiser"]["slices"] = {"t": "!!!notbase64"}
    for payload in (b"{truncated", b"\x00\xff\x00garbage", json.dumps({"version": 99}).encode(),
                    json.dumps({"version": 1, "batcher": 42}).encode(),
                    json.dumps(partial).encode()):
        with open(ck, "wb") as f:
            f.write(payload)
        p2 = _pipeline(PORT, NullClient(), tmp_path / "o5b", microbatch=1000)
        assert load_file(p2, ck) is False
        assert p2.batcher.store == {} and p2.batcher._ready == []
        assert p2.dropped == 0 and p2.batcher.reported_pairs == 0
        assert os.path.exists(ck + ".corrupt") and not os.path.exists(ck)
        assert load_file(_pipeline(PORT, NullClient(), tmp_path / "o5c"), ck) is False
        os.remove(ck + ".corrupt")


def test_checkpointer_interval_and_failed_save(tmp_path):
    p = _pipeline(PORT, NullClient(), tmp_path / "o", microbatch=1000)
    ck = Checkpointer(p, str(tmp_path / "c.ckpt"), interval_sec=60)
    assert ck.maybe_save(1_000) and not ck.maybe_save(30_000) and ck.maybe_save(61_000)
    assert Checkpointer(p, None).save() is False
    bad = Checkpointer(p, str(tmp_path / "no" / "such" / "dir" / "c.ckpt"))
    assert bad.save() is False  # logged, not raised


def test_corrupt_partition_checkpoint_boots_partition_clean(tmp_path):
    p = _pipeline(PORT, NullClient(), tmp_path / "o6")
    ck = PartitionCheckpointer(p, str(tmp_path / "parts"))
    with open(ck._path(3), "wb") as f:
        f.write(b"{nope")
    assert ck.load(3) == 0
    assert os.path.exists(ck._path(3) + ".corrupt") and not os.path.exists(ck._path(3))
    assert ck.load(3) == 0


# -- the partition runner (a consumer group's rebalance) ------------------------

N_VEHICLES = 6


class SpanClient:
    """One segment pair a request spanning the trace, ids from the uuid;
    shape_used = n - 1 keeps a rolling tail in flight."""

    def report_many(self, requests):
        out = []
        for r in requests:
            vid = int(r["uuid"].rsplit("-", 1)[1])
            out.append({"shape_used": len(r["trace"]) - 1, "datastore": {"reports": [{
                "id": 8 * (vid + 1), "next_id": 8 * (vid + 1) + 8,
                "t0": r["trace"][0]["time"], "t1": r["trace"][-1]["time"],
                "length": 100 + vid, "queue_length": 0}]}})
        return out


def _instance(tmp_path, name, mods=PORT):
    out = tmp_path / name
    out.mkdir(exist_ok=True)
    anon_m, batcher_m, fmt_m, topo_m = mods
    anon = anon_m.AnonymisingProcessor(privacy=1, quantisation=3600, output=str(out),
                                       source="RB", flush_interval_sec=10 ** 9)
    batcher = batcher_m.BatchingProcessor(client=SpanClient(), sink=anon.process,
                                          microbatch_size=1)
    return topo_m.StreamPipeline(fmt_m.Formatter.from_config(SV), batcher, anon), out


def _rb_records():
    """16 points a vehicle, ~111 m and 10 s apart: the 500 m / 10 point /
    60 s gate crosses at point 10, after the rebalance at point 8."""
    return [(t, v % 2, "veh-%d|%d|%0.6f|%0.6f|5" % (v, T0 + t * 10, 37.75, -122.44 + t * 1e-3))
            for t in range(16) for v in range(N_VEHICLES)]


def _drain(p):
    p.tick((T0 + 16 * 10 + 3600) * 1000)
    p.anonymiser.punctuate()


def _single(tmp_path, name, mods=PORT):
    p, out = _instance(tmp_path, name, mods)
    for t, part, raw in _rb_records():
        p.feed(raw, (T0 + t * 10) * 1000, partition=part)
    _drain(p)
    return tile_rows(out)


def test_rebalance_no_lost_or_duplicated_observations(tmp_path):
    msgs = _rb_records()
    want = _single(tmp_path, "single")
    assert want and want == _single(tmp_path, "single_ref", REF)
    ckpt = str(tmp_path / "ckpt")
    pa, out_a = _instance(tmp_path, "a")
    pb, out_b = _instance(tmp_path, "b")
    ra, rb = PartitionedStreamRunner(pa, ckpt), PartitionedStreamRunner(pb, ckpt)
    ra.on_assigned([0, 1])
    for t, part, raw in msgs:
        if t < 8:
            ra.feed(raw, (T0 + t * 10) * 1000, part)
    assert pa.batcher.store
    assert ra.on_revoked([1]) == [1]
    rb.on_assigned([1])
    assert pb.batcher.store and all(p == 1 for p in pb.batcher.partitions.values())
    assert all(p == 0 for p in pa.batcher.partitions.values())
    for t, part, raw in msgs:
        if t >= 8:
            (ra if part == 0 else rb).feed(raw, (T0 + t * 10) * 1000, part)
    _drain(pa)
    _drain(pb)
    got = tile_rows(out_a, out_b)
    assert got == want
    # the first report after the move spans points fed before it
    starts = [int(float(ln.split(",")[6])) for _t, ln in tile_rows(out_b)]
    assert min(starts) < T0 + 8 * 10


def test_graceful_close_hands_off_instead_of_reporting(tmp_path):
    msgs = _rb_records()
    want = _single(tmp_path, "single3")
    ckpt = str(tmp_path / "ckpt3")
    p1, out_1 = _instance(tmp_path, "gen1")
    r1 = PartitionedStreamRunner(p1, ckpt)
    r1.on_assigned([0, 1])
    for t, part, raw in msgs:
        if t < 8:
            r1.feed(raw, (T0 + t * 10) * 1000, part)
    assert r1.close((T0 + 80) * 1000)
    p2, out_2 = _instance(tmp_path, "gen2")
    r2 = PartitionedStreamRunner(p2, ckpt)
    r2.on_assigned([0, 1])
    for t, part, raw in msgs:
        if t >= 8:
            r2.feed(raw, (T0 + t * 10) * 1000, part)
    _drain(p2)
    assert tile_rows(out_1, out_2) == want


# -- kafka_io over the stand-in broker --------------------------------------------


@pytest.fixture
def broker(monkeypatch):
    b = FakeBroker()
    monkeypatch.setitem(sys.modules, "kafka", fake_kafka_module(b))
    return b


def _run(pipeline, duration=0.25, tick=0.05, on_tick=None, on_close=None, manual=True):
    kafka_io.run_pipeline(pipeline, "raw", "fake:9092", group="g", duration_sec=duration,
                          tick_sec=tick, on_tick=on_tick, on_close=on_close,
                          manual_commit=manual)


def test_kafka_missing_raises_clearly(monkeypatch):
    monkeypatch.setitem(sys.modules, "kafka", None)
    with pytest.raises(RuntimeError, match="kafka-python is not installed"):
        kafka_io.print_topic("raw", "x:9092")


def test_commit_only_after_snapshot_lands(broker):
    for i in range(5):
        broker.produce("raw", "m%d" % i)
    p = ScriptedPipeline()
    _run(p, on_tick=lambda ts: False, on_close=lambda: False)
    assert p.fed == ["m%d" % i for i in range(5)] and p.closed
    assert broker.committed == {} and broker.commit_log == []


def test_graceful_exit_commits_after_final_snapshot(broker):
    for i in range(5):
        broker.produce("raw", "m%d" % i)
    p = ScriptedPipeline()
    snaps = []
    _run(p, on_tick=lambda ts: True, on_close=lambda: snaps.append(len(p.fed)) or True)
    assert snaps and snaps[-1] == 5 and broker.committed[("g", "raw")] == 5 and p.closed


def test_crash_mid_feed_commits_nothing_then_replays(broker):
    for i in range(4):
        broker.produce("raw", "m%d" % i)
    p1 = ScriptedPipeline()
    snapshots = []
    _run(p1, duration=0.2, tick=0.04, on_tick=lambda ts: snapshots.append(list(p1.fed)) or True,
         on_close=lambda: snapshots.append(list(p1.fed)) or True)
    assert broker.committed[("g", "raw")] == 4
    for i in range(4, 7):
        broker.produce("raw", "m%d" % i)
    crash = ScriptedPipeline(fail_on_feed=1)
    closes = []
    with pytest.raises(ValueError):
        _run(crash, on_tick=lambda ts: True, on_close=lambda: closes.append(1) or True)
    assert crash.fed == ["m4"] and not crash.closed and closes == []
    assert broker.committed[("g", "raw")] == 4
    p2 = ScriptedPipeline()
    _run(p2, on_tick=lambda ts: True, on_close=lambda: True)
    assert snapshots[-1] + p2.fed == ["m%d" % i for i in range(7)]
    assert broker.committed[("g", "raw")] == 7


def test_sigterm_during_a_feed_reaches_final_snapshot_and_commit(broker):
    """The stop handler only sets a flag; the loop sees it after the
    message in hand, then closes, snapshots and commits, and gives the
    previous SIGTERM disposition back."""
    for i in range(4):
        broker.produce("raw", "m%d" % i)

    class Terminated(ScriptedPipeline):
        def feed(self, value, ts_ms, partition=0):
            super().feed(value, ts_ms, partition)
            if len(self.fed) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
    before = signal.getsignal(signal.SIGTERM)
    p = Terminated()
    closes = []
    _run(p, duration=None, on_tick=lambda ts: True,
         on_close=lambda: closes.append(len(p.fed)) or True)
    assert p.fed == ["m0", "m1"] and p.closed and closes == [2]
    assert broker.committed[("g", "raw")] == 2
    assert signal.getsignal(signal.SIGTERM) == before


def test_auto_commit_and_produce_file(broker):
    for i in range(2):
        broker.produce("raw", "m%d" % i)
    _run(ScriptedPipeline(), manual=False)
    assert broker.committed[("g", "raw")] == 2
    n = kafka_io.produce_file(["a|1", "b|2", "skip|3"], "raw2", "fake:9092",
                              key_with="lambda line: line.split('|')[0]",
                              send_if="lambda line: not line.startswith('skip')")
    assert n == 2 and [m.value for m in broker.topics["raw2"]] == ["a|1", "b|2"]


def test_full_pipeline_checkpoint_restart_on_fake_broker(broker, tmp_path):
    class Consumed:
        def report_many(self, requests):
            return [{"datastore": {"reports": []}, "shape_used": len(r["trace"]) - 1}
                    for r in requests]

    def mk():
        return port_topology.build_pipeline(format_config=",sv,\\|,0,1,2,3,4",
                                            client=Consumed(), privacy=1, quantisation=3600,
                                            output=str(tmp_path / "results"), source="TEST")
    rows = ["veh-%d|37.75|%0.6f|%d|5" % (i % 3, -122.45 + i * 1e-5, T0 + i) for i in range(30)]
    for r in rows[:20]:
        broker.produce("raw", r)
    ckpt = str(tmp_path / "state.ckpt")
    p1 = mk()
    c1 = Checkpointer(p1, ckpt, interval_sec=0.01)
    kafka_io.run_pipeline(p1, "raw", "fake:9092", group="g", duration_sec=0.15,
                          tick_sec=0.03, on_tick=c1.maybe_save, on_close=c1.save,
                          manual_commit=True)
    assert p1.formatted == 20 and broker.committed[("g", "raw")] == 20
    for r in rows[20:]:
        broker.produce("raw", r)
    p2 = mk()
    assert load_file(p2, ckpt) and p2.formatted == 20
    c2 = Checkpointer(p2, ckpt, interval_sec=0.01)
    kafka_io.run_pipeline(p2, "raw", "fake:9092", group="g", duration_sec=0.15,
                          tick_sec=0.03, on_tick=c2.maybe_save, on_close=c2.save,
                          manual_commit=True)
    assert p2.formatted == 30 and broker.committed[("g", "raw")] == 30


def test_partitioned_runner_through_transport(broker, tmp_path):
    """The rebalance listener snapshots the revoked partition and commits
    its offsets; the next consumer adopts both; the union of the two
    instances' tiles equals one uninterrupted consumer's."""
    msgs = _rb_records()
    single, out_single = _instance(tmp_path, "k_single")
    for t, part, raw in msgs:
        single.feed(raw, (T0 + t * 10) * 1000, partition=part)
    _drain(single)
    want = tile_rows(out_single)
    for t, part, raw in msgs:
        broker.produce("raw", raw, ts=(T0 + t * 10) * 1000, partition=part)
    ckpt = str(tmp_path / "k_ckpt")
    pa, out_a = _instance(tmp_path, "k_a")
    broker.revoke_after = (sum(1 for m in msgs if m[0] < 8), [1])
    kafka_io.run_pipeline(pa, "raw", "fake:9092", group="g", duration_sec=0.2,
                          tick_sec=0.05, runner=PartitionedStreamRunner(pa, ckpt))
    assert broker.committed.get(("g", "raw", 1)) is not None
    pb, out_b = _instance(tmp_path, "k_b")
    broker.next_assignment = [1]
    kafka_io.run_pipeline(pb, "raw", "fake:9092", group="g", duration_sec=0.2,
                          tick_sec=0.05, runner=PartitionedStreamRunner(pb, ckpt))
    _drain(pa)
    _drain(pb)
    assert tile_rows(out_a, out_b) == want
