"""The port's observability arithmetic against the JAX package's, on the
CPU: the metrics registry (byte-equal ``render()``, equal ``snapshot()``
and ``merge``), the quantile math, trace ids and spans, the log
formatters, the flight recorder's tail sampling, the SLO engine, the
adaptive controls and the economics engine under the same injected
clocks, and the shadow-oracle quality engine on the same grid city and
traces.  Every comparison is exact."""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.obs import adaptive as r_adaptive
from reporter_tpu.obs import economics as r_econ
from reporter_tpu.obs import flight as r_flight
from reporter_tpu.obs import log as r_log
from reporter_tpu.obs import metrics as r_metrics
from reporter_tpu.obs import quality as r_quality
from reporter_tpu.obs import quantile as r_quantile
from reporter_tpu.obs import slo as r_slo
from reporter_tpu.obs import trace as r_trace
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.obs import adaptive as p_adaptive
from reporter_tpu_torch.obs import economics as p_econ
from reporter_tpu_torch.obs import flight as p_flight
from reporter_tpu_torch.obs import log as p_log
from reporter_tpu_torch.obs import metrics as p_metrics
from reporter_tpu_torch.obs import quality as p_quality
from reporter_tpu_torch.obs import quantile as p_quantile
from reporter_tpu_torch.obs import slo as p_slo
from reporter_tpu_torch.obs import trace as p_trace
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city

class Clock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += float(dt)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REPORTER_ADAPTIVE", "REPORTER_COST_PER_CHIP_HOUR",
                "REPORTER_CAPACITY_WINDOW_S", "REPORTER_HISTORY_TICK_S",
                "REPORTER_HISTORY_MAX_BYTES", "REPORTER_QUALITY_SAMPLE_EVERY",
                "REPORTER_QUALITY_QUEUE", "REPORTER_QUALITY_WINDOW_S",
                "REPORTER_QUALITY_TARGET", "REPORTER_QUALITY_PACE",
                "REPORTER_SPARSE", "REPORTER_CALIBRATION", "REPORTER_VITERBI",
                "REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP",
                "REPORTER_FLIGHT_CAPACITY", "REPORTER_FLIGHT_SLOW_MS",
                "REPORTER_FLIGHT_SAMPLE_EVERY"):
        monkeypatch.delenv(var, raising=False)
    for name in list(os.environ):
        if name.startswith("REPORTER_SLO_"):
            monkeypatch.delenv(name, raising=False)


def _instrument(mod, seed):
    """A fresh registry of ``mod`` driven through one seeded sequence of
    instrument operations."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("reporter_t_total", "a counter", ("route", "outcome"))
    g = reg.gauge("reporter_t_gauge", "a gauge\nwith a newline")
    h = reg.histogram("reporter_t_seconds", "latency", ("route",))
    f = reg.histogram("reporter_t_fill", "fill", buckets=mod.BATCH_FILL_BUCKETS)
    u = reg.counter("reporter_t_plain", "unlabeled")
    for i in range(200):
        route = ("report", "batch", 'we"ird\\route\n')[int(rng.integers(3))]
        c.labels(route, ("ok", "error")[int(rng.integers(2))]).inc(
            float(rng.integers(1, 4)))
        g.set(float(rng.normal()))
        g.inc(0.5)
        g.dec(0.25)
        h.labels(route).observe(float(rng.exponential(0.05)),
                                exemplar="tid-%d" % i if i % 7 == 0 else None)
        f.observe(int(rng.integers(1, 3000)))
        u.inc(0.1)
    # re-registering the same name and kind returns the family
    assert reg.counter("reporter_t_total", "", ("route", "outcome")) is c
    return reg


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_registry_render_snapshot_merge_equal(seed):
    ref, port = _instrument(r_metrics, seed), _instrument(p_metrics, seed)
    assert port.render() == ref.render()
    assert port.snapshot() == ref.snapshot()
    other_r, other_p = _instrument(r_metrics, seed + 100), _instrument(p_metrics, seed + 100)
    assert (p_metrics.merge(port.snapshot(), other_p.snapshot())
            == r_metrics.merge(ref.snapshot(), other_r.snapshot()))
    assert p_metrics.LATENCY_BUCKETS_S == r_metrics.LATENCY_BUCKETS_S
    assert p_metrics.BATCH_FILL_BUCKETS == r_metrics.BATCH_FILL_BUCKETS
    with pytest.raises(ValueError):
        port.gauge("reporter_t_total")
    with pytest.raises(ValueError):
        port.counter("bad name")


def test_quantile_equal():
    rng = np.random.default_rng(3)
    B = r_quantile.SLO_BUCKETS_S
    assert p_quantile.SLO_BUCKETS_S == B
    assert (p_quantile.log_bucket_bounds(0.0001, 30.0, 6)
            == r_quantile.log_bucket_bounds(0.0001, 30.0, 6))
    samples = rng.lognormal(-4.0, 1.5, 5000)
    for v in list(samples[:400]) + [0.0, 1e-9, B[3], 1e6, float("inf")]:
        assert p_quantile.bucket_index(B, float(v)) == r_quantile.bucket_index(B, float(v))
    counts = [0] * (len(B) + 1)
    for v in samples:
        counts[r_quantile.bucket_index(B, float(v))] += 1
    cum = r_quantile.cumulate(B, counts)
    assert p_quantile.cumulate(B, counts) == cum
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert p_quantile.hist_quantile(cum, q) == r_quantile.hist_quantile(cum, q)
    assert p_quantile.hist_quantile([], 0.5) == r_quantile.hist_quantile([], 0.5)
    reg_r, reg_p = _instrument(r_metrics, 4), _instrument(p_metrics, 4)
    parsed = (r_quantile.parse_metrics(reg_r.render()),
              p_quantile.parse_metrics(reg_p.render()))
    assert parsed[1] == parsed[0]
    hb = (r_quantile.hist_buckets(parsed[0], "reporter_t_seconds"),
          p_quantile.hist_buckets(parsed[1], "reporter_t_seconds"))
    assert hb[1] == hb[0]
    assert (p_quantile.merge_parsed([parsed[1], parsed[1]])
            == r_quantile.merge_parsed([parsed[0], parsed[0]]))


def test_trace_ids_and_spans_equal():
    raws = [None, "", "abc", "a" * 64, "a" * 65, "has space", "ok.id-1_2", "é", " pad "]
    assert [p_trace.accept_trace_id(r) for r in raws] == [
        r_trace.accept_trace_id(r) for r in raws]
    assert len(p_trace.new_trace_id()) == len(r_trace.new_trace_id())
    for mod in (r_trace, p_trace):
        sp = mod.Span("report", trace_id="fixed-trace-id-0001")
        sp.mark("queue_wait_s", 0.0123456789)
        sp.meta["uuid"] = "veh"
        sp.fail(ValueError("x" * 500), status="invalid")
        with mod.bind(sp):
            assert mod.current_trace_id() == "fixed-trace-id-0001"
        assert mod.current_span() is None
    a = r_trace.Span("report", trace_id="fixed-trace-id-0001")
    b = p_trace.Span("report", trace_id="fixed-trace-id-0001")
    for sp in (a, b):
        sp.mark("k", 1.23456789)
        sp.meta["n"] = 3
    assert b.breakdown() == a.breakdown()
    assert b.span_id == a.span_id


def _record(fields):
    rec = logging.LogRecord("reporter.t", logging.WARNING, __file__, 1,
                            "event %s", ("one",), None)
    rec.created, rec.msecs = 1700000000.25, 250.0
    if fields is not None:
        rec.event = "compile_stall"
        rec.event_fields = dict(fields)
    return rec


@pytest.mark.parametrize("fields", [None, {}, {"shape": "64x8", "seconds": 0.5}])
def test_log_formatters_equal(fields):
    for bound in (False, True):
        out = []
        for log_mod, tr_mod in ((r_log, r_trace), (p_log, p_trace)):
            span = tr_mod.Span("x", trace_id="tid-1") if bound else None
            with tr_mod.bind(span):
                out.append((log_mod.JsonFormatter().format(_record(fields)),
                            log_mod.TextFormatter(log_mod.TEXT_FORMAT).format(
                                _record(fields))))
        assert out[1] == out[0]
    assert p_log.TEXT_FORMAT == r_log.TEXT_FORMAT


def _spans(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(120):
        sp = mod.Span("report", trace_id="flight-trace-%06d" % i)
        sp.timings["total_s"] = float(rng.choice([0.001, 0.01, 0.3, 2.0]))
        kind = int(rng.integers(8))
        if kind == 0:
            sp.fail("boom", status="error")
        elif kind == 1:
            sp.meta["slo_violation"] = ["latency_report"]
        elif kind == 2:
            sp.meta["flight_keep"] = "pin"
        elif kind == 3:
            sp.meta["low_margin"] = 0.25
        out.append(sp)
    return out


@pytest.mark.parametrize("seed", [2, 5])
def test_flight_recorder_keeps_the_same_traces(seed, tmp_path):
    ref = r_flight.FlightRecorder(capacity=16, slow_ms=250, sample_every=4)
    port = p_flight.FlightRecorder(capacity=16, slow_ms=250, sample_every=4)
    dec_r = [ref.record(s) for s in _spans(r_trace, seed)]
    dec_p = [port.record(s) for s in _spans(p_trace, seed)]
    assert dec_p == dec_r

    def strip(entries):
        # the end times are the wall clock's: compare what was kept
        return sorted(({k: v for k, v in e.items() if k != "t_end"} for e in entries),
                      key=lambda e: e["trace_id"])

    assert strip(port.snapshot(40)) == strip(ref.snapshot(40))
    assert port.summary() == ref.summary()
    for i in (3, 50, 119):
        tid = "flight-trace-%06d" % i
        assert strip(port.find(tid)) == strip(ref.find(tid))
    path = port.dump(str(tmp_path / "f.json"))
    with open(path) as f:
        assert len(json.load(f)["traces"]) == len(port.snapshot(32))


def _drive_slo(mod, clk):
    eng = mod.SLOEngine(mod.default_objectives(), window_s=60.0, instrument=False,
                        clock=clk)
    rng = np.random.default_rng(11)
    for i in range(600):
        clk.tick(float(rng.exponential(0.2)))
        route = ("report", "report_stream", "trace_attributes_batch")[i % 3]
        code = int(rng.choice([200, 200, 200, 200, 429, 500, 503, 400, 504]))
        eng.observe(route, code, float(rng.lognormal(-3.0, 1.0)),
                    degraded=bool(i % 17 == 0), trace_id="t%d" % i)
        if i % 5 == 0:
            eng.observe_sample("agreement", float(rng.uniform(0.7, 1.0)),
                               float(rng.integers(2, 60)))
    return eng


def test_slo_engine_equal():
    a, b = Clock(), Clock()
    ref, port = _drive_slo(r_slo, a), _drive_slo(p_slo, b)
    ref.objectives.append(r_slo.Objective("agreement", "agreement", 0.9))
    port.objectives.append(p_slo.Objective("agreement", "agreement", 0.9))
    assert port.summary() == ref.summary()

    def report(eng, **kw):
        # the violating ring stamps the wall clock: compare the rest
        out = eng.report(**kw)
        for v in out["violating_traces"]:
            v.pop("t_unix", None)
        return out

    assert report(port) == report(ref)
    assert report(port, window_s=10.0) == report(ref, window_s=10.0)
    spec = {"availability": 0.995, "degraded_fraction": 0.2, "agreement": 0.9,
            "latency": {"report": {"p99_ms": 500}, "*": {"p95_ms": 1000}}}
    for sp in (spec, None):
        assert ([dataclasses.asdict(o) for o in p_slo.objectives_from_spec(sp)]
                == [dataclasses.asdict(o) for o in r_slo.objectives_from_spec(sp)])
    for code in (200, 400, 404, 409, 422, 429, 500, 503, 504):
        assert p_slo.classify(code) == r_slo.classify(code)
        assert p_slo.classify(code, degraded=True) == r_slo.classify(code, degraded=True)


def test_adaptive_controls_equal():
    a, b = Clock(), Clock()
    wq = (r_adaptive.WindowedQuantile(window_s=30.0, clock=a),
          p_adaptive.WindowedQuantile(window_s=30.0, clock=b))
    ctl = (r_adaptive.Controller("t_wait_s", 0.01, lo=0.002, hi=0.04, clock=a),
           p_adaptive.Controller("t_wait_s", 0.01, lo=0.002, hi=0.04, clock=b))
    rng = np.random.default_rng(5)
    outs = ([], [])
    for i in range(400):
        dt, v = float(rng.exponential(0.3)), float(rng.lognormal(-4.0, 1.0))
        a.tick(dt)
        b.tick(dt)
        target = float(rng.uniform(0.0, 0.06))
        for k in (0, 1):
            wq[k].observe(v)
            outs[k].append((wq[k].count(), wq[k].quantile(0.95), wq[k].quantile(0.5),
                            ctl[k].propose(target), ctl[k].value))
    assert outs[1] == outs[0]
    assert p_adaptive.enabled() == r_adaptive.enabled()


def _batcher_phases(scenario):
    """(ticks, queue wait s, device step s, requested fill) phases: a
    host-bound finish (the step dwarfs the queue wait, batches fill),
    a queue-bound one (the wait dwarfs the step), or the first then the
    second."""
    dev = (160, (0.0005, 0.002), (0.2, 0.4), 64)
    que = (400, (0.05, 0.12), (0.004, 0.008), 8)  # past the 60 s step window
    return {"device_bound": [dev], "queue_bound": [que], "mixed": [dev, que]}[scenario]


@pytest.mark.parametrize("scenario", ["device_bound", "queue_bound", "mixed"])
def test_batcher_controllers_take_the_same_path(scenario, monkeypatch):
    """Both packages' MicroBatchers, their controllers and windows on
    injected clocks, fed the same stamped queue waits and device steps:
    the same max_wait / max_batch after every tick."""
    from reporter_tpu.serve.service import MicroBatcher as RefBatcher
    from reporter_tpu_torch.serve.service import MicroBatcher as PortBatcher

    monkeypatch.delenv("REPORTER_ADAPTIVE", raising=False)
    kw = dict(max_batch=64, max_wait_ms=10.0, max_inflight=1, watchdog_s=0)
    # no batch is ever formed: the test drives the controllers itself
    bs = (RefBatcher(object(), **kw), PortBatcher(object(), **kw))
    clocks = (Clock(), Clock())
    try:
        for b, c in zip(bs, clocks):
            for obj in (b._wait_ctl, b._batch_ctl, b._h_qwait, b._h_dstep):
                obj._clock = c
        rng = np.random.default_rng(11)
        paths = ([], [])
        for ticks, (q_lo, q_hi), (d_lo, d_hi), fill in _batcher_phases(scenario):
            for _ in range(ticks):
                dt = float(rng.uniform(0.05, 0.4))
                waits = rng.uniform(q_lo, q_hi, 8).tolist()
                step = float(rng.uniform(d_lo, d_hi))
                for k, b in enumerate(bs):
                    clocks[k].tick(dt)
                    for w in waits:
                        b._h_qwait.observe(w)
                    b._h_dstep.observe(step)
                    b._adapt_wait(min(fill, b.max_batch))
                    paths[k].append((b.max_wait, b.max_batch, b._wait_ctl.value,
                                     b._batch_ctl.value))
    finally:
        bs[1].close()  # the JAX package's batcher has no close: daemon threads
    assert paths[1] == paths[0]
    waits = {p[0] for p in paths[0]}
    widths = [p[1] for p in paths[0]]
    assert len(waits) > 1  # the fill window moved
    if scenario != "queue_bound":
        assert min(widths) == 16  # a host-bound finish narrows to a quarter
    if scenario == "mixed":
        assert widths[-1] > 16  # and the queue-bound phase widens it again


def _sampler(i):
    return {"queue_depth": i % 7, "admitted_total": 100.0 * i, "shed_total": 3.0 * (i // 4),
            "points_total": 2500.0 * i,
            "device_step": (list(r_metrics.LATENCY_BUCKETS_S),
                            [i, 2 * i, 3 * i, i, 0, 0, 0, 0, 0, 0, 0, 0]),
            "max_batch": 64.0, "burn": {"availability": 0.5 + 0.1 * (i % 5)},
            "max_burn": 0.5 + 0.1 * (i % 5), "sessions": 5 + i,
            "session_tiers": {"hot": i, "cold": 1, "host": 4}}


def _no_paths(v):
    """``v`` without its "path" keys (each package writes its own file)."""
    if isinstance(v, dict):
        return {k: _no_paths(x) for k, x in v.items() if k != "path"}
    if isinstance(v, (list, tuple)):
        return [_no_paths(x) for x in v]
    return v


def test_economics_engine_equal(tmp_path):
    out = []
    for name, mod in (("ref", r_econ), ("port", p_econ)):
        clk, wall = Clock(), Clock(5000.0)
        e = mod.EconomicsEngine("rep-t", chips=2, spec={"price_per_chip_hour": 3.0},
                                history_path=str(tmp_path / name / "rep-t.jsonl"),
                                clock=clk, wall=wall)
        i = [0]

        def sampler():
            i[0] += 1
            return _sampler(i[0])
        e._sampler = sampler
        for step in range(40):
            clk.tick(1.0)
            wall.tick(1.0)
            if step == 5:
                e.ledger.note_active(True)
            if step == 20:
                e.ledger.set_degraded(True)
            if step == 25:
                e.ledger.set_degraded(False)
                e.ledger.note_active(False)
            if step == 35:
                e.ledger.set_draining(True)
            e.tick()
        out.append(_no_paths((e.cost_report(), e.summary(),
                              e.history_report(window_s=20.0))))
        e.stop()
    assert out[1] == out[0]
    assert p_econ.resolve_price({"price_per_chip_hour": 2.0}) == r_econ.resolve_price(
        {"price_per_chip_hour": 2.0})
    rows = [r_econ.read_ring(str(tmp_path / "ref" / "rep-t.jsonl")),
            p_econ.read_ring(str(tmp_path / "port" / "rep-t.jsonl"))]
    assert rows[1] == rows[0]


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "sparse"])
def grid(request):
    """Both packages' matchers on one 6 x 6 grid, dense or with the
    sparse-gap model on (the 50 s traces then take the sparse oracle), and
    seeded traces."""
    ra = ref_build_graph_arrays(ref_grid_city(6, 6, 150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(6, 6, 150.0), cell_size=100.0)
    kw = dict(length_buckets=[16, 32], quality_aux=True, sparse=request.param)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=2000.0),
                     config=RefConfig(**kw), backend="jax")
    port = SegmentMatcher(arrays=pa, config=MatcherConfig(ubodt_delta=2000.0, **kw),
                          device="cpu")
    synth = TraceSynthesizer(pa, seed=21)
    rng = np.random.default_rng(21)
    traces = []
    for i in range(8):
        tr = synth.synthesize(int(rng.integers(8, 28)), dt=float(rng.choice([5.0, 50.0])),
                              sigma=float(rng.choice([4.0, 25.0])), uuid="q-%d" % i,
                              max_tries=400).trace
        traces.append(tr)
    return ref, port, traces


def test_quality_engines_agree(grid):
    ref_m, port_m, traces = grid
    engines = []
    for mod, m in ((r_quality, ref_m), (p_quality, port_m)):
        clk = Clock()
        fed = []
        eng = mod.QualityEngine(m, sample_every=1, window_s=600.0, target=0.95,
                                slo_feed=lambda v, w, fed=fed: fed.append((v, w)),
                                clock=clk, start_worker=False)
        fracs = []
        for tr in traces:
            clk.tick(5.0)
            q = m.match_many([tr])[0]["_quality"]
            fracs.append(eng.compare(tr, q["edge"]))
        engines.append((eng, fracs, fed))
    (r_eng, r_fr, r_fed), (p_eng, p_fr, p_fed) = engines
    assert p_fr == r_fr and all(f is not None for f in p_fr)
    assert p_fed == r_fed
    assert p_eng.report() == r_eng.report()
    assert p_eng.summary() == r_eng.summary()
