"""The port's CPU baseline and brute oracle against the JAX package's, on
the CPU: ``CPUViterbiMatcher.run_batch`` on the fuzz differential's random
topologies, ``BruteForceMatcher`` dense and with the sparse model's
``oracle_values``, the triple agreement (the device program on
``device="cpu"``, ``backend="cpu"`` and the brute oracle) on the brute
oracle's topologies, ``SegmentMatcher(backend="cpu")`` against the
reference's CPU backend on bucketed, long and session traffic, and, on
the bench's realistic city at 40 x 40, the port's device program against
the reference's JAX path on the same paths, with the one place where the
reference's two backends part pinned: the port's two part there in
exactly the same way.  Records compare through ``_canon``; the per-point
arrays bit for bit."""

import json

import numpy as np
import pytest
import torch

from reporter_tpu.baseline.brute_matcher import BruteForceMatcher as RefBrute
from reporter_tpu.baseline.cpu_matcher import CPUViterbiMatcher as RefCPU
from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.matching.session import SessionEngine as RefEngine
from reporter_tpu.matching.session import SessionStore as RefStore
from reporter_tpu.synth.osm_city import realistic_city_network as ref_realistic_city_network
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.baseline import BruteForceMatcher, CPUViterbiMatcher
from reporter_tpu_torch.matching import (
    MatcherConfig, SegmentMatcher, SessionEngine, SessionStore,
)
from reporter_tpu_torch.serve import ReporterService
from reporter_tpu_torch.serve.service import build_matcher, parse_service_config
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.synth.osm_city import realistic_city_network
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from test_brute_oracle import TOPOLOGIES, _road_trace
from test_fuzz_differential import _canon, random_traces
from test_torch_builders import scenario, to_port_network

FUZZ_SEEDS = [11, 23, 37, 59, 71, 83, 97, 109]  # test_random_topology_backend_parity's
MO = {"mode": "auto", "report_levels": [0, 1, 2], "transition_levels": [0, 1, 2]}


def _same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_cpu_matcher_run_batch_equals_reference(seed):
    net, ra, ru, pa, pu = scenario(seed, delta=2000.0)
    traces = random_traces(np.random.default_rng(seed), net, ra, n_traces=6)
    ref = RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(), backend="cpu")
    px, py, tm, valid, _t = ref._fill_rows(traces, list(range(6)), 32)
    want = RefCPU(ra, ru, RefConfig()).run_batch(px, py, tm, valid)
    _same_arrays(CPUViterbiMatcher(pa, pu, MatcherConfig()).run_batch(px, py, tm, valid), want)


def _sparse_traces(net, n=3):
    """Road-following traces with a fix a minute (the sparse cohorts)."""
    out = []
    for i in range(n):
        tr = _road_trace(net, "sp%d" % i, n_pts=10, edge_idx=min(2 * i, net.num_edges - 1),
                         seed=i)
        for p in tr["trace"]:
            p["time"] = 1000 + (p["time"] - 1000) * 12
        out.append(tr)
    return out


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_brute_matcher_equals_reference(topo):
    """Dense, and with the sparse model's values for the "ge60" cohort
    (``SparseModel.oracle_values`` of both packages, equal)."""
    net = TOPOLOGIES[topo]()
    ra = ref_build_graph_arrays(net, cell_size=100.0)
    pa = build_graph_arrays(to_port_network(net), cell_size=100.0)
    rcfg, cfg = RefConfig(ubodt_delta=20000.0), MatcherConfig(ubodt_delta=20000.0)
    traces = [_road_trace(net, "d%d" % i, edge_idx=min(i, net.num_edges - 1), seed=i)
              for i in range(3)] + _sparse_traces(net)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=20000.0), config=rcfg,
                     backend="cpu")
    px, py, tm, valid, _t = ref._fill_rows(traces, list(range(len(traces))), 12)
    _same_arrays(BruteForceMatcher(pa, cfg).run_batch(px, py, tm, valid),
                 RefBrute(ra, rcfg).run_batch(px, py, tm, valid))
    assert BruteForceMatcher(pa, cfg).candidate_counts(px[0], py[0]) == \
        RefBrute(ra, rcfg).candidate_counts(px[0], py[0])
    from dataclasses import replace

    pu = build_ubodt(pa, delta=20000.0)
    sm = SegmentMatcher(arrays=pa, ubodt=pu, config=replace(cfg, sparse=True), device="cpu")
    rsm = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=20000.0),
                     config=replace(rcfg, sparse=True), backend="cpu")
    for label in ("ge60", "45-60"):
        vals = sm.sparse.oracle_values(label, (6.0, 4.0, 40.0))
        assert vals == rsm.sparse.oracle_values(label, (6.0, 4.0, 40.0))
    vals = sm.sparse.oracle_values("ge60")
    assert vals == rsm.sparse.oracle_values("ge60")
    _same_arrays(BruteForceMatcher(pa, cfg, sparse=vals).run_batch(px, py, tm, valid),
                 RefBrute(ra, rcfg, sparse=vals).run_batch(px, py, tm, valid))


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_triple_agreement(topo):
    """The port's device program (plain versions on the CPU), its CPU
    baseline and its brute oracle give the same records; and the same as
    the reference's CPU backend."""
    net = TOPOLOGIES[topo]()
    pnet = to_port_network(net)
    pa = build_graph_arrays(pnet, cell_size=100.0)
    pu = build_ubodt(pa, delta=20000.0)
    cfg = MatcherConfig(ubodt_delta=20000.0)
    dev = SegmentMatcher(arrays=pa, ubodt=pu, config=cfg, device="cpu")
    cpu = SegmentMatcher(arrays=pa, ubodt=pu, config=cfg, backend="cpu")
    brute = BruteForceMatcher(pa, cfg)
    traces = [_road_trace(net, "%s-0" % topo, edge_idx=0, seed=1),
              _road_trace(net, "%s-1" % topo, edge_idx=min(2, net.num_edges - 1), seed=2),
              _road_trace(net, "%s-2" % topo, edge_idx=min(4, net.num_edges - 1), n_pts=16,
                          seed=3)]
    idxs = list(range(len(traces)))
    px, py, tm, valid, times = dev._fill_rows(traces, idxs, 16)
    for b in idxs:
        n = int(valid[b].sum())
        counts = brute.candidate_counts(px[b, :n], py[b, :n])
        assert 1 <= min(counts) and max(counts) <= cfg.beam_k, (topo, b, counts)
    out_dev, out_cpu = dev.match_many(traces), cpu.match_many(traces)
    out_brute = [None] * len(traces)
    dev._associate_and_store(idxs, *brute.run_batch(px, py, tm, valid), times, out_brute)
    ra = ref_build_graph_arrays(net, cell_size=100.0)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=20000.0),
                     config=RefConfig(ubodt_delta=20000.0), backend="cpu")
    out_ref = ref.match_many(traces)
    for i in idxs:
        assert out_dev[i] == out_cpu[i] == out_brute[i] == out_ref[i], (topo, i)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_cpu_backend_equals_reference_on_fuzz(seed):
    net, ra, ru, pa, pu = scenario(seed, delta=2000.0)
    traces = random_traces(np.random.default_rng(seed), net, ra, n_traces=6)
    ref = RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(), backend="cpu")
    port = SegmentMatcher(arrays=pa, ubodt=pu, config=MatcherConfig(), backend="cpu")
    assert [_canon(r) for r in port.match_many(traces)] == \
        [_canon(r) for r in ref.match_many(traces)]


@pytest.fixture(scope="module")
def grid_pair():
    kw = dict(length_buckets=[16, 32], session_buckets=[4, 16], quality_aux=True)
    ra = ref_build_graph_arrays(ref_grid_city(8, 8, 200.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(8, 8, 200.0), cell_size=100.0)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=3000.0),
                     config=RefConfig(**kw), backend="cpu")
    port = SegmentMatcher(arrays=pa, ubodt=build_ubodt(pa, delta=3000.0),
                          config=MatcherConfig(**kw), backend="cpu")
    syn = TraceSynthesizer(pa, seed=5)
    traces = [syn.synthesize(n, dt=5.0, sigma=6.0, uuid="s%d" % i, max_tries=200).trace
              for i, n in enumerate([12, 30, 30, 70, 150, 3, 33])]
    traces[2]["match_options"]["sigma_z"] = 9.0
    traces[3]["match_options"]["search_radius"] = 35.0
    traces.append({"uuid": "empty", "trace": [], "match_options": traces[0]["match_options"]})
    return ref, port, traces


def test_cpu_backend_bucketed_and_long(grid_pair):
    """Several buckets, per-request parameter groups, an empty trace and
    traces longer than the largest bucket (70, 150 and 33 points over
    buckets of 16 and 32: matched whole, not windowed), with the
    diagnostics block (no confidence aux on this backend)."""
    ref, port, traces = grid_pair
    want, got = ref.match_many(traces), port.match_many(traces)
    assert [_canon(r) for r in got] == [_canon(r) for r in want]
    assert got[3]["_quality"] == want[3]["_quality"]
    assert "margin_min" not in got[3]["_quality"]
    assert port._bucket_len(150) == ref._bucket_len(150) == 256


@pytest.mark.parametrize("step", [1, 4, 20])
def test_cpu_backend_sessions(grid_pair, step):
    """A session step on the CPU backend is a stateless window over the
    arriving points (20 at a time: over the largest session bucket, one
    wider window); the engines' answers and sessions equal the
    reference's."""
    ref, port, traces = grid_pair
    live = [t for t in traces[:3] if t["trace"]]

    def stream(eng):
        out = []
        for j in range(0, max(len(t["trace"]) for t in live), step):
            out.extend(eng.match_many([
                {"uuid": t["uuid"], "trace": t["trace"][j:j + step], "match_options": MO}
                for t in live if j < len(t["trace"])]))
        return out
    ref_eng, eng = RefEngine(ref, RefStore(), tail_points=64), SessionEngine(port,
                                                                          SessionStore())
    want, got = stream(ref_eng), stream(eng)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _canon({"segments": g["segments"]}) == _canon({"segments": w["segments"]})
        assert g["_stream"]["trace"] == w["_stream"]["trace"]
        assert g["_quality"] == w["_quality"]
    for t in live:
        s, r = eng.store.peek(t["uuid"]), ref_eng.store.peek(t["uuid"])
        assert s.records == r.records and s.carry is None and r.carry is None


def test_cpu_backend_is_chosen_only_when_asked(monkeypatch, tmp_path):
    """Without CUDA the default backend still raises; backend="cpu" (or a
    service config's "backend": "cpu") runs on the host; anything else
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pa = build_graph_arrays(grid_city(4, 4, 150.0))
    pu = build_ubodt(pa, delta=1000.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegmentMatcher(arrays=pa, ubodt=pu, config=MatcherConfig())
    m = SegmentMatcher(arrays=pa, ubodt=pu, config=MatcherConfig(), backend="cpu")
    assert m.backend == "cpu" and m.device.type == "cpu" and m._dg is None
    with pytest.raises(ValueError, match="unknown backend"):
        SegmentMatcher(arrays=pa, ubodt=pu, config=MatcherConfig(), backend="gpu")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({"network": {"type": "grid", "rows": 4, "cols": 4},
                                    "backend": "cpu"}))
    cfg, conf = parse_service_config(str(cfg_path))
    sm = build_matcher(cfg, conf)
    assert sm.backend == "cpu"
    service = ReporterService(sm, threshold_sec=15)
    try:
        tr = TraceSynthesizer(sm.arrays, seed=3).synthesize(12, dt=5.0, sigma=3.0,
                                                            uuid="v").trace
        code, body = service.handle_report(tr)
        assert code == 200
        assert body["segment_matcher"]["segments"] == \
            build_matcher(cfg, conf).match(tr)["segments"]
        assert service.handle_health()[1]["backend"] == "cpu"
    finally:
        service.close()
    cfg_path.write_text(json.dumps({"network": {"type": "grid"}, "backend": "tpu"}))
    with pytest.raises(ValueError, match="backend"):
        parse_service_config(str(cfg_path))


# -- the bench's realistic city at 40 x 40 ------------------------------------

@pytest.fixture(scope="module")
def city40():
    """Both packages' matchers on the realistic city (seed 3) and 32 traces
    of 64 points (seed 7): the reference's JAX path and CPU backend, the
    port on device="cpu" and backend="cpu"; buckets up to 32, so the
    64-point traces take the long path too."""
    ra = ref_build_graph_arrays(ref_realistic_city_network(40, 40, seed=3), cell_size=100.0)
    pa = build_graph_arrays(realistic_city_network(40, 40, seed=3), cell_size=100.0)
    ru, pu = ref_build_ubodt(ra, delta=3000.0), build_ubodt(pa, delta=3000.0)
    assert pu.packed.tobytes() == ru.packed.tobytes()
    traces = [s.trace for s in TraceSynthesizer(pa, seed=7).batch(32, 64, dt=5.0, sigma=5.0)]
    out = {}
    for name, kw in (("bucketed", {}), ("long", {"length_buckets": [16, 32]})):
        out[name] = {
            "ref_jax": RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(**kw), backend="jax"),
            "ref_cpu": RefMatcher(arrays=ra, ubodt=ru, config=RefConfig(**kw), backend="cpu"),
            "dev": SegmentMatcher(arrays=pa, ubodt=pu, config=MatcherConfig(**kw),
                                  device="cpu"),
            "cpu": SegmentMatcher(arrays=pa, ubodt=pu, config=MatcherConfig(**kw),
                                  backend="cpu")}
    return out, traces


def _answers(m, traces, path):
    if path != "session":
        return [_canon(r) for r in m.match_many(traces)]
    eng = (RefEngine(m, RefStore(), tail_points=64) if isinstance(m, RefMatcher)
           else SessionEngine(m, SessionStore()))
    out = []
    for j in range(0, 64, 16):
        out = eng.match_many([{"uuid": t["uuid"], "trace": t["trace"][j:j + 16],
                               "match_options": t["match_options"]} for t in traces])
    return [_canon({"segments": r["segments"]}) for r in out]


@pytest.fixture(scope="module")
def city40_answers(city40):
    ms, traces = city40
    return {path: {k: _answers(m, traces, path) for k, m in
                   ms["long" if path == "long" else "bucketed"].items()}
            for path in ("bucketed", "long", "session")}


@pytest.mark.parametrize("path", ["bucketed", "long", "session"])
def test_realistic_city_device_program_equals_jax(city40_answers, path):
    a = city40_answers[path]
    assert a["dev"] == a["ref_jax"]
    assert sum(bool(r["segments"]) for r in a["dev"]) == 32


@pytest.mark.parametrize("path", ["bucketed", "long", "session"])
def test_realistic_city_cpu_backend_equals_reference(city40_answers, path):
    a = city40_answers[path]
    assert a["cpu"] == a["ref_cpu"]


@pytest.mark.parametrize("path", ["bucketed", "long", "session"])
def test_realistic_city_backends_part_as_the_reference_does(city40_answers, path):
    """Where the reference's JAX path and CPU backend give other records,
    the port's device program and CPU baseline give other records, the
    same ones; nowhere else.  On the bucketed path that is one trace of
    32 (the same segment ids, another field)."""
    a = city40_answers[path]
    parted = [i for i, (j, c) in enumerate(zip(a["ref_jax"], a["ref_cpu"])) if j != c]
    assert parted == [i for i, (d, c) in enumerate(zip(a["dev"], a["cpu"])) if d != c]
    ids = lambda r: [s.get("segment_id") for s in r["segments"]]  # noqa: E731
    for i in parted:
        assert (ids(a["dev"][i]) == ids(a["cpu"][i])) == (ids(a["ref_jax"][i])
                                                            == ids(a["ref_cpu"][i]))
    if path == "bucketed":
        assert len(parted) == 1
