"""The reference's default host plane through the port's service, on the
CPU: a binary (RPTC) /trace_attributes_batch and /report pack through the
``"_columns"`` side channel with no walk of their point dicts (counted)
and answer as their JSON twins; no response body, /debug/traces entry,
flight dump or shadow sample holds ``_columns``; ``serve.__main__.main``
leaves neither $REPORTER_WIRE nor $REPORTER_HOST_PACK behind; and the
reference's whole ``MatcherConfig`` loads without a dropped key."""

import dataclasses
import json
import logging
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher, columnar
from reporter_tpu_torch.matching import config as config_mod
from reporter_tpu_torch.obs import flight as obs_flight
from reporter_tpu_torch.serve import wire
from reporter_tpu_torch.serve.service import ReporterService
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city

MO = {"mode": "auto", "report_levels": [0, 1, 2], "transition_levels": [0, 1, 2]}
JSON_H = {"Content-Type": "application/json"}
BIN_H = {"Content-Type": wire.CONTENT_TYPE}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REPORTER_WIRE", "REPORTER_HOST_PACK", "REPORTER_SPARSE",
                "REPORTER_QUALITY_AUX", "REPORTER_LONG_PRECOMPUTE", "REPORTER_VITERBI"):
        monkeypatch.delenv(var, raising=False)


class _Samples:
    """Stands in for the shadow-oracle sampler: keeps what it is offered."""

    def __init__(self):
        self.traces = []

    def maybe_sample(self, trace, _q):
        self.traces.append(trace)
        return False


@pytest.fixture(scope="module")
def world():
    """A port service over HTTP on the 5 x 5 grid (quality diagnostics on,
    so every answer offers a shadow sample) and seeded traces of 6-40
    points, two of them past the top bucket (the long path)."""
    pa = build_graph_arrays(grid_city(5, 5, 150.0), cell_size=100.0)
    port = SegmentMatcher(arrays=pa, device="cpu",
                          config=MatcherConfig(ubodt_delta=2000.0, length_buckets=[16, 32],
                                               quality_aux=True))
    rng = np.random.default_rng(4)
    synth = TraceSynthesizer(pa, seed=4)
    traces = []
    for i in range(10):
        n = 40 if i < 2 else int(rng.integers(6, 30))
        tr = synth.synthesize(n, dt=5.0, sigma=4.0, uuid="veh-%d" % i, max_tries=400).trace
        if i % 3 == 0:
            for p in tr["trace"]:
                p["time"] = int(round(p["time"]))
        tr["match_options"] = dict(MO)
        traces.append(tr)
    svc = ReporterService(port, max_wait_ms=2.0)
    svc.quality = _Samples()
    server = svc.make_server("127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield {"svc": svc, "traces": traces,
           "url": "http://127.0.0.1:%d" % server.server_address[1]}
    server.shutdown()
    server.server_close()
    th.join(10)
    svc.close()


def _post(url, data, headers):
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("path", ["/trace_attributes_batch", "/report"])
def test_binary_ingress_packs_from_the_side_channel(world, path, tmp_path, monkeypatch):
    # a recorder that retains every request, so the dump holds these
    monkeypatch.setattr(obs_flight, "RECORDER", obs_flight.FlightRecorder(sample_every=1))
    traces = world["traces"]
    body = {"traces": traces} if path == "/trace_attributes_batch" else traces[4]
    n = len(traces) if path == "/trace_attributes_batch" else 1
    code, js = _post(world["url"] + path, json.dumps(body).encode(), JSON_H)
    assert code == 200
    before = dict(columnar.COUNTS)
    code, raw = _post(world["url"] + path, wire.encode_request(body), BIN_H)
    assert code == 200
    assert columnar.COUNTS["side_channel"] - before["side_channel"] == n
    assert columnar.COUNTS["walked"] - before["walked"] == 0
    assert json.loads(raw) == json.loads(js)
    assert b"_columns" not in raw and b"_columns" not in js
    code, traced = _post(world["url"] + "/debug/traces?n=512", None, {})
    assert code == 200 and b"_columns" not in traced
    dump = obs_flight.RECORDER.dump(str(tmp_path / "flight.json"))
    assert dump and "_columns" not in open(dump).read()
    offered = world["svc"].quality.traces
    assert offered and not any("_columns" in t for t in offered)


def test_cli_env_defaults_restored(tmp_path, monkeypatch):
    """The serve entry point's $REPORTER_WIRE / $REPORTER_HOST_PACK
    defaults do not outlive main(); an operator's own value stays."""
    import reporter_tpu_torch.serve.__main__ as cli

    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"network": {"type": "file",
                                            "path": str(tmp_path / "missing.json")},
                                "warmup": False}))
    seen = {}
    real = cli.parse_service_config

    def spy(path):
        seen.update({k: os.environ.get(k) for k in ("REPORTER_WIRE", "REPORTER_HOST_PACK")})
        return real(path)

    monkeypatch.setattr(cli, "parse_service_config", spy)
    assert cli.main([str(conf), "127.0.0.1:0", "--device", "cpu"]) == 1
    assert seen == {"REPORTER_WIRE": "1", "REPORTER_HOST_PACK": "1"}
    assert "REPORTER_WIRE" not in os.environ and "REPORTER_HOST_PACK" not in os.environ
    monkeypatch.setenv("REPORTER_WIRE", "0")
    cli.main([str(conf), "127.0.0.1:0", "--device", "cpu"])
    assert os.environ["REPORTER_WIRE"] == "0" and "REPORTER_HOST_PACK" not in os.environ


def test_reference_config_loads_without_a_dropped_key(monkeypatch, caplog):
    """Every field of the JAX package's MatcherConfig is the port's:
    from_dict of the whole reference config warns about nothing and
    carries host_pack and long_precompute."""
    monkeypatch.setattr(config_mod, "_WARNED", set())
    ref = dataclasses.replace(RefConfig(), host_pack=False, long_precompute=False)
    with caplog.at_level(logging.WARNING, logger=config_mod.__name__):
        cfg = MatcherConfig.from_dict(dataclasses.asdict(ref))
    assert [r.getMessage() for r in caplog.records] == []
    assert set(RefConfig.__dataclass_fields__) <= set(MatcherConfig.__dataclass_fields__)
    assert cfg.host_pack is False and cfg.long_precompute is False
    assert MatcherConfig().host_pack is True and MatcherConfig().long_precompute is True
