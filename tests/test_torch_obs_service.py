"""The port's serving observability against the JAX package's service, on
the CPU: both services on one 5 x 5 grid over HTTP take the same request
sequence (windowed reports, one under ``?debug=1``, an invalid one, a
batch, streaming submits and one poisoned by the dispatch fault), then
answer the same ``ACTIONS``, the same ``/metrics`` family names and label
sets (the families of the router, fleet and federation modules are not
ported and are listed below; the stream, batch, retry and connection-pool
modules' families are, and both packages' modules are imported here so
each registry holds them whichever files ran before in the process), equal
deltas of the deterministic counters, the same ``/statusz`` keys, the
same structure of ``/debug/traces``, ``/debug/slo``, ``/debug/cost`` and
``/debug/history``, the same ``?debug=1`` breakdown keys, and every
response echoes ``X-Reporter-Trace``.  The documentation check reads
docs/observability.md through tools/check_metrics.py."""

import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

# the stream, batch, anonymise and egress modules of both packages: their
# families register at import, so /metrics carries them in every process
import reporter_tpu.batch.pipeline  # noqa: F401
import reporter_tpu.stream.checkpoint  # noqa: F401
import reporter_tpu.stream.topology  # noqa: F401
import reporter_tpu_torch.batch.pipeline  # noqa: F401
import reporter_tpu_torch.stream.checkpoint  # noqa: F401
import reporter_tpu_torch.stream.topology  # noqa: F401
from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.obs import attrib as ref_attrib
from reporter_tpu.obs import metrics as ref_metrics
from reporter_tpu.serve import service as ref_service_mod
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.obs import attrib as port_attrib
from reporter_tpu_torch.obs import metrics as port_metrics
from reporter_tpu_torch.serve import service as service_mod
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MO = {"mode": "auto", "report_levels": [0, 1, 2], "transition_levels": [0, 1, 2]}
KW = dict(length_buckets=[16, 32])
JSON_H = {"Content-Type": "application/json"}

# the families of modules this port does not carry yet: the fleet router
# and autoscaler and metrics federation
OUT_OF_SCOPE = {
    "reporter_federation_pulls_total", "reporter_federation_snapshot_age_seconds",
    "reporter_federation_snapshot_stale", "reporter_fleet_autoscale_replicas",
    "reporter_fleet_quality_agreement", "reporter_fleet_respawn_backoff_seconds",
    "reporter_fleet_scale_events_total", "reporter_fleet_slo_burn_rate",
    "reporter_fleet_slo_error_budget_remaining", "reporter_fleet_slo_latency_seconds",
    "reporter_fleet_slo_masking_debt", "reporter_fleet_slo_objective_ok",
    "reporter_fleet_slo_ok", "reporter_fleet_slo_requests_total",
    "reporter_router_affinity_remaps_total", "reporter_router_ejections_total",
    "reporter_router_failovers_total", "reporter_router_geo_requests_total",
    "reporter_router_hedge_wins_total", "reporter_router_hedges_total",
    "reporter_router_inflight", "reporter_router_probe_failures_total",
    "reporter_router_replica_requests_total", "reporter_router_replicas",
    "reporter_router_request_seconds", "reporter_router_requests_total",
    "reporter_router_session_handoffs_total", "reporter_router_shed_total",
}
# counters whose deltas the request sequence fixes exactly
DETERMINISTIC = (
    "reporter_requests_total", "reporter_traces_matched_total",
    "reporter_points_matched_total", "reporter_transition_breaks_total",
    "reporter_dispatch_total", "reporter_dispatch_cohort_total",
    "reporter_compile_total", "reporter_sessions_total",
    "reporter_session_points_total", "reporter_faults_injected_total",
    "reporter_poison_isolated_total", "reporter_quarantine_rejected_total",
    "reporter_requests_shed_total", "reporter_requests_expired_total",
    "reporter_drain_refused_total", "reporter_degraded_requests_total",
    "reporter_candidates_radius_clamped_total", "reporter_sparse_dispatch_total",
    "reporter_interpolated_traces_total", "reporter_session_dedup_points_total",
)


def _check_metrics():
    spec = importlib.util.spec_from_file_location(
        "check_metrics", os.path.join(REPO, "tools", "check_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in list(os.environ):
        if var.startswith(("REPORTER_FAULT_", "REPORTER_QUALITY_", "REPORTER_SLO_")):
            monkeypatch.delenv(var, raising=False)
    for var in ("REPORTER_WIRE", "REPORTER_MAX_QUEUE", "REPORTER_DEADLINE_MS",
                "REPORTER_SPARSE", "REPORTER_CALIBRATION", "REPORTER_INTERPOLATE",
                "REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP", "REPORTER_VITERBI",
                "REPORTER_UBODT_HOT_BYTES", "REPORTER_OBS_PROBE_EVERY",
                "REPORTER_ADAPTIVE", "REPORTER_SESSION_ARENA", "REPORTER_HISTORY_DIR"):
        monkeypatch.delenv(var, raising=False)


def _serve(service):
    server = service.make_server("127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return server, th, "http://127.0.0.1:%d" % server.server_address[1]


def _call(url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _samples(registry):
    """{(family, label values): value} of every counter sample."""
    out = {}
    for name, fam in registry.snapshot().items():
        if fam["type"] == "counter":
            for lv, v in fam["samples"]:
                out[(name, tuple(lv))] = v
    return out


def _delta(before, after, names):
    return {k: after[k] - before.get(k, 0.0) for k in after
            if k[0] in names and after[k] != before.get(k, 0.0)}


def _requests(traces):
    """(name, path, body, headers) of the request sequence, in order."""
    seq = []
    for i in range(6):
        seq.append(("report-%d" % i, "/report", traces[i], {}))
    seq.append(("debug", "/report?debug=1", traces[6], {}))
    seq.append(("invalid", "/report", {"trace": traces[0]["trace"],
                                       "match_options": MO}, {}))
    seq.append(("batch", "/trace_attributes_batch",
                {"traces": [traces[7], traces[8], traces[9]]}, {}))
    for step in range(2):
        for v in range(2):
            pts = traces[v]["trace"][4 * step: 4 * step + 4]
            seq.append(("stream-%d-%d" % (v, step), "/report",
                        {"uuid": "stream-%d" % v, "stream": True, "trace": pts,
                         "match_options": MO}, {}))
    poison = dict(traces[9], uuid="poison-veh")
    seq.append(("poison", "/report", poison, {"fault": "uuid:poison-veh"}))
    return seq


@pytest.fixture(scope="module")
def runs():
    """Both services after the same request sequence: each one's answers,
    its counter deltas, and its GET endpoints' answers.  Neither package
    holds an attribution capture while they answer: the newest capture is
    process-global, and a file that ran earlier in the same process (the
    JAX package's attribution tests, or the port's) leaves one behind,
    which adds its keys to that side's /statusz ``attrib`` line only.  The
    captures come back afterwards."""
    saved = []
    for mod in (ref_attrib, port_attrib):
        with mod._LAST_LOCK:
            saved.append(mod._LAST)
            mod._LAST = None
    ra = ref_build_graph_arrays(ref_grid_city(5, 5, 150.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(5, 5, 150.0), cell_size=100.0)
    ref = RefMatcher(arrays=ra, ubodt=ref_build_ubodt(ra, delta=2000.0),
                     config=RefConfig(**KW), backend="jax")
    port = SegmentMatcher(arrays=pa, config=MatcherConfig(ubodt_delta=2000.0, **KW),
                          device="cpu")
    synth = TraceSynthesizer(pa, seed=17)
    rng = np.random.default_rng(17)
    traces = []
    for i in range(10):
        tr = synth.synthesize(int(rng.integers(9, 30)), dt=5.0, sigma=4.0,
                              uuid="obs-%d" % i, max_tries=400).trace
        tr["match_options"] = dict(MO)
        traces.append(tr)
    out = {}
    for name, svc, registry in (
            ("ref", ref_service_mod.ReporterService(ref, max_wait_ms=20.0,
                                                    robustness={"watchdog_s": 0}),
             ref_metrics.REGISTRY),
            ("port", service_mod.ReporterService(port, max_wait_ms=20.0,
                                                 robustness={"watchdog_s": 0}),
             port_metrics.REGISTRY)):
        server, th, url = _serve(svc)
        before = _samples(registry)
        answers = {}
        for tag, path, body, extra in _requests(traces):
            if "fault" in extra:
                os.environ["REPORTER_FAULT_DISPATCH"] = extra["fault"]
            try:
                answers[tag] = _call(url + path, json.dumps(body).encode(),
                                     dict(JSON_H, **{"X-Reporter-Trace": "trace-" + tag}))
            finally:
                os.environ.pop("REPORTER_FAULT_DISPATCH", None)
        after = _samples(registry)
        gets = {}
        for path in ("/metrics", "/statusz", "/debug/traces?n=512", "/debug/slo",
                     "/debug/cost", "/debug/history", "/debug/attrib", "/health",
                     "/debug/traces?id=trace-invalid", "/nope"):
            gets[path] = _call(url + path, headers={"X-Reporter-Trace": "get-probe"})
        gets["anon"] = _call(url + "/health")
        server.shutdown()
        server.server_close()
        th.join(10)
        out[name] = {"answers": answers, "delta": _delta(before, after, DETERMINISTIC),
                     "gets": gets, "svc": svc}
    yield out
    out["port"]["svc"].close()
    for mod, last in zip((ref_attrib, port_attrib), saved):
        with mod._LAST_LOCK:
            mod._LAST = last


def test_actions_equal():
    assert service_mod.ACTIONS == ref_service_mod.ACTIONS


def test_answers_and_trace_echo(runs):
    for side in ("ref", "port"):
        for tag, (code, hdrs, _body) in runs[side]["answers"].items():
            assert hdrs.get("X-Reporter-Trace") == "trace-" + tag, (side, tag)
        for path, (code, hdrs, _body) in runs[side]["gets"].items():
            tid = hdrs.get("X-Reporter-Trace")
            assert tid == "get-probe" if path != "anon" else tid, (side, path)
    for tag in runs["ref"]["answers"]:
        assert runs["port"]["answers"][tag][0] == runs["ref"]["answers"][tag][0], tag
    assert runs["port"]["answers"]["poison"][0] == 500
    assert runs["port"]["answers"]["invalid"][0] == 400


def _families(text):
    """{family: kind} of a Prometheus text exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _h, _t, name, kind = line.split(" ")
            out[name] = kind
    return out


def test_metrics_families_and_labels(runs):
    cm = _check_metrics()
    ref_all = cm.registered_labels()
    in_scope = {n: l for n, l in ref_all.items() if n not in OUT_OF_SCOPE}
    assert OUT_OF_SCOPE <= set(ref_all)
    port_reg = cm.registered_labels(pkg_dir=os.path.join(REPO, "reporter_tpu_torch"))
    assert port_reg == in_scope
    code, hdrs, body = runs["port"]["gets"]["/metrics"]
    assert code == 200 and hdrs["Content-Type"].startswith("text/plain")
    fams = _families(body.decode())
    assert set(fams) == set(in_scope)
    ref_fams = _families(runs["ref"]["gets"]["/metrics"][2].decode())
    assert {n: k for n, k in fams.items()} == {n: ref_fams[n] for n in fams}
    snap = port_metrics.REGISTRY.snapshot()
    ref_snap = ref_metrics.REGISTRY.snapshot()
    for name in in_scope:
        assert snap[name]["labelnames"] == ref_snap[name]["labelnames"], name


def test_deterministic_counters_equal(runs):
    port, ref = runs["port"]["delta"], runs["ref"]["delta"]
    assert port == ref
    assert port[("reporter_requests_total", ("report", "ok"))] == 7
    assert port[("reporter_requests_total", ("report", "invalid"))] == 1
    assert port[("reporter_requests_total", ("report_stream", "ok"))] == 4
    assert port[("reporter_requests_total", ("trace_attributes_batch", "ok"))] == 1
    assert port[("reporter_faults_injected_total", ("dispatch",))] >= 1


def test_statusz_and_debug_structure(runs):
    def body(side, path):
        code, _h, raw = runs[side]["gets"][path]
        return code, json.loads(raw)

    for path in ("/statusz", "/debug/slo", "/debug/cost", "/debug/history",
                 "/debug/attrib", "/debug/traces?n=512"):
        (pc, p), (rc, r) = body("port", path), body("ref", path)
        assert pc == rc == 200, path
        assert set(p) == set(r), path
    (_c, p), (_c2, r) = body("port", "/statusz"), body("ref", "/statusz")
    for block in ("robustness", "adaptive", "flight", "slo", "economics", "sessions"):
        assert set(p[block]) == set(r[block]), block
    # the JAX package's attribution line also names its newest archived
    # on-chip capture, which the port does not carry
    assert {"captured", "host"} <= set(p["attrib"])
    assert set(r["attrib"]) - set(p["attrib"]) <= {"last_onchip"}
    assert p["adaptive"]["enabled"] is True
    (_c, p), (_c2, r) = body("port", "/debug/traces?n=512"), body("ref", "/debug/traces?n=512")
    assert set(p["summary"]) == set(r["summary"])
    for side, rows in (("port", p["traces"]), ("ref", r["traces"])):
        kept = {t["trace_id"]: t for t in rows}
        # errored requests are retained by right
        for tag in ("invalid", "poison"):
            assert kept["trace-" + tag]["status"] != "ok", (side, tag)
    assert body("port", "/debug/traces?id=trace-invalid")[0] == 200
    (_c, p), (_c2, r) = body("port", "/debug/slo"), body("ref", "/debug/slo")
    assert [o["name"] for o in p["objectives"]] == [o["name"] for o in r["objectives"]]
    assert set(p["routes"]) >= {"report", "report_stream", "trace_attributes_batch"}
    assert p["routes"]["report"]["good"] >= 7 and p["routes"]["report"]["bad"] >= 1
    assert runs["port"]["gets"]["/nope"][0] == 400


def test_debug_breakdown_keys(runs):
    p = json.loads(runs["port"]["answers"]["debug"][2])["debug"]
    r = json.loads(runs["ref"]["answers"]["debug"][2])["debug"]
    assert set(p) == set(r)
    assert set(p["timings"]) == set(r["timings"])
    assert p["match_options"] == r["match_options"]
    assert p["trace_id"] == "trace-debug"


def test_documented_families():
    cm = _check_metrics()
    doc = cm.documented_labels()
    port = cm.registered_labels(pkg_dir=os.path.join(REPO, "reporter_tpu_torch"))
    for name, labels in port.items():
        assert doc.get(name) == labels, name
