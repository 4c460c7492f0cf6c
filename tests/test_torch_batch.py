"""The port's batch pipeline against the JAX package's, on the CPU: the
split, the inactivity windows, the cull, the valuer, the archive keys and
phase 1's shards; whole runs on a 5 x 5 grid whose tiles must hold the
reference's rows under the same tile paths; a failed upload that keeps the
match directory; the privacy cull; a dp 2 mesh of CPU ranks equal to one
device; the CLI with ``--device cpu`` in a process of its own (phases 1 and
3 on two spawned workers, ``--warmup``, ``--metrics``); a micro-batch whose
match fails counted and skipped; and ``SegmentMatcher.warmup``'s shapes per
kernel equal to the reference's for the same config."""

import glob
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from reporter_tpu.batch import pipeline as ref_pipeline
from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.obs import metrics as ref_metrics
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu_torch.batch import pipeline
from reporter_tpu_torch.batch.pipeline import (
    LocalArchive,
    _cull_lines,
    _windows,
    compile_valuer,
    get_traces,
    report_tiles,
    run_pipeline,
    split,
)
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.obs import metrics as obs
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.network import grid_city

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUER = 'lambda l: tuple(l.split("|"))'
GRID = dict(rows=5, cols=5, spacing_m=150.0)
KW = dict(valuer=VALUER, time_pattern=None, report_levels={0, 1, 2},
          transition_levels={0, 1, 2}, privacy=1, source="CI", quantisation=3600)


def tile_rows(out):
    """{tile path: sorted CSV rows} under ``out`` (file names carry a
    uuid4, so only the tile path and the rows compare)."""
    tiles = {}
    for f in glob.glob(os.path.join(out, "**", "*"), recursive=True):
        if os.path.isfile(f):
            with open(f) as fh:
                lines = fh.read().strip().split("\n")
            assert lines[0].startswith("segment_id,next_segment_id,")
            tiles.setdefault(os.path.dirname(os.path.relpath(f, out)), []).extend(lines[1:])
    return {k: sorted(v) for k, v in tiles.items()}


def _counter(name, *labels):
    fam = obs.REGISTRY.snapshot().get(name, {"samples": []})
    return sum(v for lv, v in fam["samples"] if tuple(lv) == labels)


def test_split_windows_cull_and_valuer_equal_reference():
    for n, k in ((10, 3), (0, 3), (17, 4), (5, 8)):
        assert split(list(range(n)), k) == ref_pipeline.split(list(range(n)), k)
    assert split(list(range(10)), 3) == [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9]]
    pts = [{"time": t} for t in (0, 10, 20, 200, 210, 500, 505, 900)]
    for gap in (5, 120, 300):
        assert list(_windows(pts, gap)) == list(ref_pipeline._windows(pts, gap))
    assert [len(w) for w in _windows(pts, 120)] == [3, 2, 2]
    rows = ["%d,%d,10,1,50.0,0.0,%d,%d,SRC,AUTO\n" % (a, b, t, t + 10)
            for a, b, t in ((1, 2, 100), (1, 2, 200), (3, 4, 100), (5, 6, 7))]
    for privacy in (1, 2, 3):
        assert _cull_lines(rows + ["garbage\n"], privacy) == ref_pipeline._cull_lines(
            rows + ["garbage\n"], privacy)
    assert len(_cull_lines(rows, 2)) == 2 and _cull_lines(["garbage\n"], 1) == []
    line = "2017-01-01 06:05:40|veh-9|x|x|x|6.5|x|x|x|3.465725|-76.5135033"
    assert compile_valuer(None)(line) == ref_pipeline.compile_valuer(None)(line) == (
        "veh-9", "2017-01-01 06:05:40", "3.465725", "-76.5135033", "6.5")


def test_archive_keys_and_phase1_shards_equal_reference(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "x.gz").write_bytes(b"")
    (tmp_path / "b.txt").write_text("")
    arch = LocalArchive(str(tmp_path))
    assert arch.keys() == [os.path.join("a", "x.gz"), "b.txt"]
    assert arch.keys(key_regex=r".*\.gz") == [os.path.join("a", "x.gz")]
    src = tmp_path / "arch"
    src.mkdir()
    # the default valuer's columns: time 0, uuid 1, accuracy 5, lat 9, lon 10
    lines = ["2017-01-01 06:05:40|veh-1||||4.2||||37.75|-122.45",
             "2017-01-01 06:05:50|veh-1||||4.2||||37.76|-122.44",
             "2017-01-01 06:05:40|veh-2||||4.2||||10.0|10.0",  # outside the bbox
             "2017-01-01 06:05:45|veh-3||||1500||||37.70|-122.40"]  # accuracy capped
    with gzip.open(str(src / "day1.gz"), "wt") as f:
        f.write("\n".join(lines) + "\n")
    # a row the valuer cannot read fails its whole file, as in the reference
    (src / "day2").write_text("not a row\n")
    errors = _counter("reporter_batch_source_files_total", "error")
    shards = {}
    for name, fn in (("port", get_traces), ("ref", ref_pipeline.get_traces)):
        out = fn(str(src), bbox=(37.0, -123.0, 38.0, -122.0), dest_dir=str(tmp_path / name))
        shards[name] = {s: open(os.path.join(out, s)).read() for s in os.listdir(out)}
    assert shards["port"] == shards["ref"] and len(shards["port"]) == 2
    assert _counter("reporter_batch_source_files_total", "error") - errors == 1
    rows = [r for body in shards["port"].values() for r in body.strip().split("\n")]
    assert sorted(r.split(",")[0] for r in rows) == ["veh-1", "veh-1", "veh-3"]
    assert "veh-1,1483250740,37.75,-122.45,5" in rows
    assert any(r.startswith("veh-3,") and r.endswith(",1000") for r in rows)


@pytest.fixture(scope="module")
def matchers():
    port = SegmentMatcher(network=grid_city(**GRID), config=MatcherConfig(), device="cpu")
    ref = RefMatcher(network=ref_grid_city(**GRID), config=RefConfig(), backend="jax")
    return port, ref


def _write_archive(arrays, root, n_vehicles=4, n_points=24, seed=3, gap_after=None):
    """SV rows uuid|epoch|lat|lon|acc over two files; vehicle 0 pauses 300
    s after ``gap_after`` points (two windows at the 120 s inactivity)."""
    os.makedirs(root, exist_ok=True)
    synth = TraceSynthesizer(arrays, seed=seed)
    files = [open(os.path.join(root, "day%d" % i), "w") for i in range(2)]
    try:
        for v in range(n_vehicles):
            st = synth.synthesize(n_points, dt=15.0, sigma=3.0, uuid="veh-%d" % v)
            for j, p in enumerate(st.trace["trace"]):
                t = int(p["time"]) + (300 if v == 0 and gap_after and j >= gap_after else 0)
                files[j % 2].write("veh-%d|%d|%r|%r|%d\n" % (v, t, p["lat"], p["lon"],
                                                              p["accuracy"]))
    finally:
        for f in files:
            f.close()


def test_batch_end_to_end_equals_reference(matchers, tmp_path):
    port_m, ref_m = matchers
    _write_archive(port_m.arrays, str(tmp_path / "arch"), gap_after=12)
    outs = {}
    fails = _counter("reporter_batch_report_failures_total")
    windows = _counter("reporter_batch_windows_matched_total")
    for name, m, run in (("port", port_m, run_pipeline), ("ref", ref_m, ref_pipeline.run_pipeline)):
        out = str(tmp_path / ("out_" + name))
        trace_dir, match_dir = run(m, archive_spec=str(tmp_path / "arch"),
                                   dest_store="dir:" + out, cleanup=False, **KW)
        assert trace_dir and match_dir
        outs[name] = tile_rows(out)
        if name == "port":
            # resume from match_dir only re-runs phase 3
            report_tiles(match_dir, "dir:" + str(tmp_path / "again"), privacy=1)
            assert tile_rows(str(tmp_path / "again")) == outs["port"]
    assert outs["port"] and outs["port"] == outs["ref"]
    assert _counter("reporter_batch_report_failures_total") == fails
    assert _counter("reporter_batch_windows_matched_total") - windows == 5  # 4 + the split
    for rows in outs["port"].values():
        parts = rows[0].split(",")
        assert parts[3] == "1" and parts[8] == "CI" and parts[9] == "AUTO"


def test_failed_upload_keeps_match_dir(matchers, tmp_path, monkeypatch):
    port_m, _ = matchers
    _write_archive(port_m.arrays, str(tmp_path / "arch"), n_vehicles=2)

    class BrokenStore:
        def put(self, key, body):
            raise RuntimeError("datastore down")
    monkeypatch.setattr(pipeline, "make_store", lambda spec: BrokenStore())
    before = _counter("reporter_batch_tiles_uploaded_total", "error")
    trace_dir, match_dir = run_pipeline(port_m, archive_spec=str(tmp_path / "arch"),
                                        dest_store="dir:unused", cleanup=True, **KW)
    assert trace_dir is None and match_dir is not None and os.path.isdir(match_dir)
    assert _counter("reporter_batch_tiles_uploaded_total", "error") > before
    import shutil

    shutil.rmtree(match_dir, ignore_errors=True)


def test_privacy_cull_drops_lone_vehicle(matchers, tmp_path):
    port_m, _ = matchers
    _write_archive(port_m.arrays, str(tmp_path / "arch"), n_vehicles=1)
    out = str(tmp_path / "out")
    run_pipeline(port_m, archive_spec=str(tmp_path / "arch"), dest_store="dir:" + out,
                 cleanup=True, **dict(KW, privacy=1000))
    assert not glob.glob(os.path.join(out, "*", "*", "*", "*"))


def test_batch_on_dp2_cpu_mesh_equals_one_device(matchers, tmp_path):
    port_m, _ = matchers
    mesh = SegmentMatcher(arrays=port_m.arrays, ubodt=port_m.ubodt, device=["cpu"] * 2,
                          config=MatcherConfig(devices=2))
    assert mesh._n_dp == 2
    _write_archive(port_m.arrays, str(tmp_path / "arch"))
    outs = []
    for name, m in (("single", port_m), ("mesh", mesh)):
        out = str(tmp_path / ("out_" + name))
        run_pipeline(m, archive_spec=str(tmp_path / "arch"), dest_store="dir:" + out,
                     cleanup=True, **KW)
        outs.append(tile_rows(out))
    assert outs[0] and outs[0] == outs[1]


def test_failed_micro_batch_is_counted_and_skipped(matchers, tmp_path):
    """The reference's semantics: a micro-batch whose match raises counts
    every window as a failure, lands in the flight recorder, and the run
    goes on."""
    port_m, _ = matchers
    _write_archive(port_m.arrays, str(tmp_path / "arch"), n_vehicles=2)

    class Failing:
        arrays = port_m.arrays

        def match_many(self, traces):
            raise RuntimeError("injected match failure")
    before = _counter("reporter_batch_report_failures_total")
    _t, match_dir = run_pipeline(Failing(), archive_spec=str(tmp_path / "arch"),
                                 cleanup=True, **KW)
    assert _counter("reporter_batch_report_failures_total") - before == 2
    # no destination: the (empty) match directory is kept for a resume
    assert match_dir and os.listdir(match_dir) == []
    os.rmdir(match_dir)


def test_cli_device_cpu_in_a_process(matchers, tmp_path):
    """python -m reporter_tpu_torch.batch --device cpu --concurrency 2
    --warmup --metrics: exit 0, the in-process run's tiles, and a metrics
    line that counts the windows and the warmup's shapes."""
    port_m, _ = matchers
    _write_archive(port_m.arrays, str(tmp_path / "arch"), gap_after=12)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"network": dict(type="grid", **GRID)}))
    out = str(tmp_path / "cli")
    r = subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.batch", "--device", "cpu",
         "--src", str(tmp_path / "arch"), "--match-config", str(cfg),
         "--src-valuer", VALUER, "--src-time-pattern", "", "--dest", "dir:" + out,
         "--privacy", "1", "--source-id", "CI", "--report-levels", "0,1,2",
         "--transition-levels", "0,1,2", "--concurrency", "2", "--warmup", "--metrics"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    snap = json.loads(r.stdout.strip().splitlines()[-1])
    assert sum(v for _lv, v in snap["reporter_batch_windows_matched_total"]["samples"]) == 5
    assert sum(v for _lv, v in snap["reporter_batch_source_files_total"]["samples"]) == 2
    assert sum(v for _lv, v in snap["reporter_warmup_shapes_total"]["samples"]) == 7
    want = str(tmp_path / "inproc")
    run_pipeline(port_m, archive_spec=str(tmp_path / "arch"), dest_store="dir:" + want,
                 cleanup=True, **KW)
    assert tile_rows(out) and tile_rows(out) == tile_rows(want)


def _warm_shapes(registry):
    fam = registry.REGISTRY.snapshot().get("reporter_warmup_shapes_total", {"samples": []})
    return {tuple(lv): v for lv, v in fam["samples"]}


@pytest.mark.parametrize("cfg", [
    dict(length_buckets=[16, 32]),
    dict(length_buckets=[16, 32], viterbi_kernel="auto", viterbi_assoc_threshold=32,
         warmup_batch_sizes=[2], sparse=True, session_arena=True),
])
def test_warmup_shapes_per_kernel_equal_reference(cfg, matchers):
    """The same shapes per kernel as the reference's warmup for the same
    config, the default pass and the carry-chain + session-step one; the
    CPU baseline warms nothing."""
    port_m, ref_m = matchers
    port = SegmentMatcher(arrays=port_m.arrays, ubodt=port_m.ubodt, device="cpu",
                          config=MatcherConfig(**cfg))
    ref = RefMatcher(arrays=ref_m.arrays, ubodt=ref_m.ubodt, config=RefConfig(**cfg),
                     backend="jax")
    for kw in (dict(), dict(carry_chain=True, session_step=True)):
        p0, r0 = _warm_shapes(obs), _warm_shapes(ref_metrics)
        assert port.warmup(**kw) > 0.0
        ref.warmup(**kw)
        p1, r1 = _warm_shapes(obs), _warm_shapes(ref_metrics)
        delta = lambda a, b: {k: b[k] - a.get(k, 0.0) for k in b  # noqa: E731
                              if b[k] != a.get(k, 0.0)}
        assert delta(p0, p1) == delta(r0, r1) and delta(p0, p1), kw
    if cfg.get("session_arena"):
        assert port.session_arena.summary()["hot_used"] == 0
    cpu = SegmentMatcher(arrays=port_m.arrays, ubodt=port_m.ubodt, backend="cpu",
                         config=MatcherConfig(**cfg))
    assert cpu.warmup(carry_chain=True) == 0.0
