"""The port's stage attribution on the CPU: the labels partition the JAX
package's twelve stages and name every kernel of ops/_kernels.py; a
``torch.profiler`` capture of ``match_many`` on host cores attributes
every label of the path it ran; the outputs are bit-identical with
``REPORTER_STAGE_SCOPES=0`` and ``=1``; ``parse_trace_events`` reads the
card's Chrome trace shape (``kernel``, ``cuda_runtime`` / ``cuda_driver``,
``user_annotation`` and ``gpu_user_annotation`` events, built here by hand
with the kernels' names, since this machine has no card); and captures
are single-flight."""

import gzip
import json
import threading

import numpy as np
import pytest
import torch

from reporter_tpu.obs import attrib as ref_attrib
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.obs import attrib, profiler
from reporter_tpu_torch.ops import _kernels
from reporter_tpu_torch.ops.viterbi import match_batch_compact_packed_aux
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city

SCAN = "scan-recursion+backtrace+compact-gather"


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REPORTER_STAGE_SCOPES", "REPORTER_VITERBI", "REPORTER_SPARSE",
                "REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP",
                "REPORTER_OBS_PROBE_EVERY", "REPORTER_UBODT_HOT_BYTES"):
        monkeypatch.delenv(var, raising=False)
    attrib.set_scopes()
    yield
    monkeypatch.delenv("REPORTER_STAGE_SCOPES", raising=False)
    attrib.set_scopes()


def test_labels_partition_the_reference_stages():
    assert attrib.REFERENCE_STAGES == ref_attrib.STAGES
    parts = [p for label in attrib.STAGES for p in label.split("+")]
    for st in ref_attrib.STAGES:
        assert parts.count(st) == 1, st
    assert len(set(attrib.STAGES)) == len(attrib.STAGES)
    assert {k.stage for k in _kernels.KERNELS.values()} == set(attrib.STAGES)
    for name, k in _kernels.KERNELS.items():
        assert attrib._scope_of("rs.%s/%s" % (k.stage, name)) == (k.stage, name)


@pytest.fixture(scope="module")
def city():
    pa = build_graph_arrays(grid_city(6, 6, 150.0), cell_size=100.0)
    synth = TraceSynthesizer(pa, seed=9)
    rng = np.random.default_rng(9)
    traces = [synth.synthesize(int(rng.integers(8, 30)), dt=5.0, sigma=4.0,
                               uuid="a-%d" % i, max_tries=400).trace for i in range(6)]
    long = synth.synthesize(70, dt=5.0, sigma=4.0, uuid="long", max_tries=400).trace
    return pa, traces + [long]


def _matcher(pa, kernel="scan", dedup=False):
    return SegmentMatcher(arrays=pa, device="cpu", config=MatcherConfig(
        ubodt_delta=2000.0, length_buckets=[16, 32], viterbi_kernel=kernel,
        probe_dedup=dedup))


@pytest.mark.parametrize("kernel,dedup", [("scan", False), ("assoc", True)])
def test_cpu_capture_attributes_every_path_label(city, kernel, dedup, tmp_path):
    pa, traces = city
    m = _matcher(pa, kernel, dedup)
    res = attrib.capture(lambda: m.match_many(traces), reps=2,
                         out_dir=str(tmp_path / "cap"), store=False)
    assert res["platform"] == "cpu"
    want = {"candidate-sweep", "ubodt-probe+select", "emission+transition-build",
            SCAN if kernel == "scan" else "assoc-recursion"}
    if dedup:
        want.add("dedup-sort+dedup-compact")
    for label in want:
        assert res["stages_ms"].get(label, 0.0) > 0.0, (label, res["stages_ms"])
    assert attrib.UNATTRIBUTED not in res["stages_ms"]
    assert res["reps"] == 2 and res["wall_s"] > 0
    assert set(res["host_stages_s"]) == set(attrib.HOST_STAGES)
    again = attrib.parse_trace_dir(res["trace_dir"])
    assert again["stages_ms"] == res["stages_ms"]


def test_scopes_off_and_on_are_bit_identical(city, monkeypatch, tmp_path):
    pa, traces = city
    m = _matcher(pa)
    outs, packed = [], []
    dg, du = m._dg, m._du
    rng = np.random.default_rng(4)
    xin = torch.from_numpy(np.stack([
        rng.uniform(0, 750, (4, 16)), rng.uniform(0, 750, (4, 16)),
        np.tile(np.arange(16) * 5.0, (4, 1)), np.ones((4, 16))]).astype(np.float32))
    for flag in ("0", "1", "0"):
        monkeypatch.setenv("REPORTER_STAGE_SCOPES", flag)
        attrib.set_scopes()
        assert attrib.scopes_enabled() == (flag == "1")
        outs.append(json.dumps(m.match_many(traces), sort_keys=True))
        packed.append(match_batch_compact_packed_aux(dg, du, xin, m._params, 8))
    assert outs[0] == outs[1] == outs[2]
    for a, b in zip(packed[0], packed[1]):
        assert torch.equal(a, b)
    monkeypatch.setenv("REPORTER_STAGE_SCOPES", "0")
    attrib.set_scopes()
    res = attrib.capture(lambda: m.match_many(traces[:2]), reps=1,
                         out_dir=str(tmp_path / "off"), store=False)
    assert res["stages_ms"] == {}


def _x(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _card_trace():
    """A hand-built capture of the card's shape: host pid 1 (threads 10
    and 11), device pid 0 (stream 7), with the kernels' own names."""
    k = _kernels.KERNELS
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        # the sweep: its range, the runtime launch, the kernel
        _x("user_annotation", "rs.candidate-sweep/candidate_sweep", 1, 10, 100, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 10, 105, 3, correlation=1),
        _x("kernel", "void candidate_sweep_kernel<32>(...)", 0, 7, 200, 5.0,
           correlation=1),
        # a plain range around a launch range: the innermost names the launch
        _x("user_annotation", "rs.emission+transition-build", 1, 10, 130, 40),
        _x("user_annotation", "rs.%s/ubodt_probe[wide32]" % k["ubodt_probe[wide32]"].stage,
           1, 10, 135, 10),
        _x("cuda_driver", "cuLaunchKernel", 1, 10, 137, 2, correlation=2),
        _x("kernel", "void rtt::probe_kernel<true, false, false>(...)", 0, 7, 210, 4.0,
           correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 10, 150, 2, correlation=3),
        _x("kernel", "void transition_build_kernel<8, false>(...)", 0, 7, 220, 3.0,
           correlation=3),
        # one launcher, two device kernels (the histogram zeroes first)
        _x("user_annotation", "rs.segment-histogram/segment_histogram", 1, 11, 300, 30),
        _x("cuda_runtime", "cudaLaunchKernelExC", 1, 11, 305, 2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernelExC", 1, 11, 310, 2, correlation=5),
        _x("kernel", "void zero_output(...)", 0, 7, 400, 1.0, correlation=4),
        _x("kernel", "void segment_histogram_kernel(...)", 0, 7, 402, 2.0,
           correlation=5),
        # a launch the runtime trace lost: the device-side annotation names it
        _x("gpu_user_annotation", "rs.dedup-scatter/ubodt_dedup_scatter", 0, 7, 500, 10),
        _x("kernel", "void rtt::dedup_scatter_kernel(...)", 0, 7, 502, 6.0,
           correlation=99),
        # PyTorch's own kernel: neither
        _x("cuda_runtime", "cudaLaunchKernel", 1, 10, 600, 2, correlation=6),
        _x("kernel", "void at::native::elementwise_kernel<...>(...)", 0, 7, 610, 4.0,
           correlation=6),
        _x("cpu_op", "aten::copy_", 1, 10, 590, 30),
    ]
    return {"traceEvents": ev}


def test_parse_card_trace_by_hand(tmp_path):
    res = attrib.parse_trace_events(_card_trace()["traceEvents"])
    assert res["platform"] == "cuda"
    assert res["device_total_ms"] == pytest.approx(0.025)
    assert res["stages_ms"] == {
        "dedup-scatter": 0.006, "candidate-sweep": 0.005,
        "ubodt-probe+select": 0.004, attrib.UNATTRIBUTED: 0.004,
        "emission+transition-build": 0.003, "segment-histogram": 0.003}
    assert res["unattributed_frac"] == pytest.approx(0.16)
    assert res["attributed_by"] == {"launch": 5, "annotation": 1, "none": 1}
    kern = res["kernels"]
    assert {n: v["launches"] for n, v in kern.items()} == {
        "candidate_sweep": 1, "ubodt_probe[wide32]": 1, "segment_histogram": 1,
        "ubodt_dedup_scatter": 1}
    assert kern["segment_histogram"]["device_ms"] == pytest.approx(0.003)
    assert kern["ubodt_probe[wide32]"]["stage"] == "ubodt-probe+select"
    # the directory form: plain and gzipped Chrome traces merge
    (tmp_path / "a.trace.json").write_text(json.dumps(_card_trace()))
    with gzip.open(tmp_path / "b.trace.json.gz", "wt") as f:
        json.dump(_card_trace(), f)
    both = attrib.parse_trace_dir(str(tmp_path))
    assert both["kernels"]["candidate_sweep"]["launches"] == 2
    assert both["stages_ms"]["dedup-scatter"] == pytest.approx(0.012)
    assert both["unattributed_frac"] == pytest.approx(0.16)
    with pytest.raises(FileNotFoundError):
        attrib.parse_trace_dir(str(tmp_path / "empty"))


def test_capture_is_single_flight(tmp_path):
    got = []
    with profiler.session("attrib", trace_id="owner", out_dir=str(tmp_path / "a")):
        with pytest.raises(profiler.ProfilerBusy) as e:
            profiler.capture(0.05, out_dir=str(tmp_path / "b"))
        got.append(e.value.inflight)
        th = threading.Thread(target=lambda: got.append(profiler.inflight()))
        th.start()
        th.join()
    assert got[0]["trace_id"] == "owner" and got[0]["kind"] == "attrib"
    assert got[1]["trace_id"] == "owner"
    assert profiler.inflight() is None
    d, secs = profiler.capture(0.05, out_dir=str(tmp_path / "c"))
    assert secs == pytest.approx(0.05)
    assert attrib.trace_files(d)


def test_store_result_publishes_gauges():
    attrib.store_result({"stages_ms": {"candidate-sweep": 2.0, "dedup-scatter": 1.0},
                         "captured_unix": 1.0, "platform": "cuda",
                         "device_total_ms": 3.0, "unattributed_frac": 0.0})
    assert attrib.G_STAGE_S.labels("candidate-sweep").value == pytest.approx(0.002)
    attrib.store_result({"stages_ms": {"candidate-sweep": 4.0}, "captured_unix": 2.0})
    assert attrib.G_STAGE_S.labels("dedup-scatter").value == 0.0
    s = attrib.summary()
    assert s["captured"] and s["top_stage"] == {"stage": "candidate-sweep", "ms": 4.0}
    assert set(s) >= {"captured", "host", "age_s", "platform"}
