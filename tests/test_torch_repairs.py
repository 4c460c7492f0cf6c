"""Two faults of the port against the JAX package, repaired and held there:
route-consistent interpolation (``match_options.interpolate``,
``cfg.interpolate``, ``$REPORTER_INTERPOLATE``) answers as the reference
does, through ``match_many`` and through both services; and
``MatcherConfig.from_dict`` and the service's "batch" block name, once
per process, each reference key the port drops, the list derived from
the reference's own dataclass."""

import dataclasses
import functools
import json
import logging

import numpy as np
import pytest

from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu.serve.service import ReporterService as RefService
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.matching import config as config_mod
from reporter_tpu_torch.serve import ReporterService
from reporter_tpu_torch.serve.service import batch_options
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt
from test_fuzz_differential import _canon

MO = {"mode": "auto", "report_levels": [0, 1], "transition_levels": [0, 1]}
KW = dict(length_buckets=[16, 32])


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REPORTER_INTERPOLATE", "REPORTER_SPARSE", "REPORTER_CALIBRATION",
                "REPORTER_UBODT_LAYOUT", "REPORTER_PROBE_DEDUP", "REPORTER_VITERBI",
                "REPORTER_UBODT_HOT_BYTES", "REPORTER_OBS_PROBE_EVERY"):
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=1)
def _world():
    """The 6 x 6 grid city (arterials at 70 km/h, side streets at 40, so
    free-flow and distance shares differ) in both packages, and traces at
    a fix a minute: 12 points (bucketed) and 40 (long: two windows of 32),
    each gap spanning several segments."""
    ra = ref_arrays(ref_grid_city(rows=6, cols=6, spacing_m=200.0), cell_size=100.0)
    pa = build_graph_arrays(grid_city(6, 6, spacing_m=200.0), cell_size=100.0)
    ru, pu = ref_build_ubodt(ra, delta=3000.0), build_ubodt(pa, delta=3000.0)
    synth = TraceSynthesizer(pa, seed=6)
    traces = [synth.synthesize(n, dt=60.0, uuid="t%d" % i, max_tries=400).trace
              for i, n in enumerate([12, 12, 12, 40])]
    return ra, ru, pa, pu, traces


def _pair(**kw):
    ra, ru, pa, pu, _t = _world()
    return (RefMatcher(arrays=ra, ubodt=ru, backend="jax", config=RefConfig(**KW, **kw)),
            SegmentMatcher(arrays=pa, ubodt=pu, device="cpu", config=MatcherConfig(**KW, **kw)))


def _with(traces, value):
    return [dict(t, match_options=dict(MO, interpolate=value)) for t in traces]


@pytest.mark.parametrize("how", ["config", "request", "env", "request_off"])
def test_interpolate_equals_jax(how, monkeypatch):
    """Bucketed and long traces with interpolation on (in the config, per
    request, by $REPORTER_INTERPOLATE) and off per request under a config
    that turns it on: the port's answers equal the JAX package's, and
    interpolation moved boundary times where it is on."""
    _ra, _ru, _pa, _pu, traces = _world()
    if how == "env":
        monkeypatch.setenv("REPORTER_INTERPOLATE", "1")
    ref, port = _pair(interpolate=how in ("config", "request_off"))
    tr = {"request": _with(traces, True), "request_off": _with(traces, False)}.get(how, traces)
    want = [_canon(r) for r in ref.match_many(tr)]
    assert [_canon(r) for r in port.match_many(tr)] == want
    monkeypatch.delenv("REPORTER_INTERPOLATE", raising=False)
    classic = [_canon(r) for r in _pair()[1].match_many(traces)]
    assert (want != classic) == (how != "request_off")
    for a, b in zip(want, classic):  # re-timed, never re-routed
        assert [s.get("segment_id") for s in a["segments"]] == \
            [s.get("segment_id") for s in b["segments"]]


def test_services_answer_interpolate_alike():
    """The same /report bodies to both services: the same status and
    body, the reference's 400 for a non-boolean interpolate included."""
    _ra, _ru, _pa, _pu, traces = _world()
    ref, port = _pair()
    svc, ref_svc = ReporterService(port, max_wait_ms=1.0), RefService(ref, max_wait_ms=1.0)
    try:
        for value in (True, False, None, "yes", 1, 0.0):
            mo = dict(MO) if value is None else dict(MO, interpolate=value)
            body = {"uuid": "veh", "trace": traces[0]["trace"], "match_options": mo}
            code, out = svc.handle_report(json.loads(json.dumps(body)))
            rcode, rout = ref_svc.handle_report(json.loads(json.dumps(body)))
            assert (code, json.loads(json.dumps(out))) == (rcode, json.loads(json.dumps(rout))), \
                value
            assert (code == 400) == (value is not None and not isinstance(value, bool))
    finally:
        svc.close()  # the reference service's batcher threads are daemons


def _dropped_reference_keys():
    """The reference config's fields the port's lacks, from the two
    dataclasses themselves."""
    return sorted(set(RefConfig.__dataclass_fields__) - set(MatcherConfig.__dataclass_fields__))


def test_from_dict_warns_once_per_dropped_reference_key(monkeypatch, caplog):
    """The port carries every field of the reference's config (the
    columnar packer's host_pack and the legacy long program's
    long_precompute were the last two), so the whole reference config
    loads with no warning and every carried field set; a key that neither
    config has is named in one warning per process."""
    monkeypatch.setattr(config_mod, "_WARNED", set())
    ref = RefConfig()
    assert _dropped_reference_keys() == []
    full = {k: getattr(ref, k) for k in RefConfig.__dataclass_fields__}
    carried = dict(interpolate=True, ubodt_hot_bytes=4096, ubodt_shard="1/4",
                   session_arena_bytes=1000, session_arena_cold_bytes=2000,
                   devices=8, graph_devices=4, cpu_fallback=False, host_pack=False,
                   long_precompute=False)
    assert set(carried) <= set(MatcherConfig.__dataclass_fields__)
    with caplog.at_level(logging.WARNING, logger=config_mod.__name__):
        cfg = MatcherConfig.from_dict(dict(full, **carried))
        assert caplog.records == []
        MatcherConfig.from_dict(dict(full, not_a_reference_key=1))
        MatcherConfig.from_dict(dict(full, not_a_reference_key=2))
    for k, v in carried.items():
        assert getattr(cfg, k) == v
    assert [r.getMessage() for r in caplog.records] == [
        "matcher config key 'not_a_reference_key' is not carried by this port; ignored"]


def test_batch_block_warns_once_per_dropped_key(monkeypatch, caplog):
    """The service config's "batch" block: every key of the reference's
    (max_inflight too) becomes a ReporterService argument; a key the port
    lacks (here max_queue, which belongs in "robustness") is named in one
    warning per process."""
    monkeypatch.setattr(config_mod, "_WARNED", set())
    conf = {"batch": {"max_batch": 8, "max_wait_ms": 3.0, "session_max_batch": 32,
                      "session_wait_ms": 1.5, "max_inflight": 4, "max_queue": 16}}
    with caplog.at_level(logging.WARNING, logger=config_mod.__name__):
        opts = batch_options(conf)
        assert batch_options(conf) == opts
    assert opts == {"max_batch": 8, "max_wait_ms": 3.0, "max_inflight": 4,
                    "session_max_batch": 32, "session_wait_ms": 1.5}
    assert [r.getMessage() for r in caplog.records] == [
        "batch config key 'max_queue' is not carried by this port; ignored"]
    assert batch_options({}) == {"max_batch": 64, "max_wait_ms": 10.0, "max_inflight": None,
                                 "session_max_batch": 256, "session_wait_ms": 2.0}
    assert np.isfinite(opts["max_wait_ms"])


def test_new_fields_round_trip():
    """The five fields the port now carries keep the reference's defaults."""
    ref, port = RefConfig(), MatcherConfig()
    for k in ("interpolate", "ubodt_hot_bytes", "ubodt_shard", "session_arena_bytes",
              "session_arena_cold_bytes"):
        assert getattr(port, k) == getattr(ref, k), k
    assert dataclasses.replace(port, interpolate=True).interpolate is True
