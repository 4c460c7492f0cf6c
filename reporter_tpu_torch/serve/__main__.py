"""CLI: python -m reporter_tpu_torch.serve [--device cuda|cpu] <config.json> [host:port]

Serves /report, /trace_attributes_batch and /health from the PyTorch/CUDA
port.  The config has the shape of the reference service's
(deploy/config.service.json): "network" (grid, file or tiles), "matcher"
(MatcherConfig fields or meili keys), "backend", "batch" (max_batch,
max_wait_ms, max_inflight, session_max_batch, session_wait_ms) and
"robustness" (max_queue, deadline_ms, watchdog_s, quarantine_after,
quarantine_ttl_s, reattach_probe_s, session_checkpoint_s / _sync / _dir;
each has a $REPORTER_* variable over it, serve/service.py), "slo" (the
SLO engine's objectives; $REPORTER_SLO_* tune the defaults), "quality"
(the shadow-oracle sampler: sample_every, queue_max, window_s, target,
margin_keep; $REPORTER_QUALITY_* over them, off unless sample_every > 0)
and "economics" (price_per_chip_hour, history_dir and the capacity
window; $REPORTER_COST_PER_CHIP_HOUR, $REPORTER_HISTORY_* over them).
$REPORTER_LOG_FORMAT=json|text and $REPORTER_LOG_LEVEL set the log
format, and $REPORTER_FLIGHT_DUMP names where the flight recorder's
traces are written when the drain ends.  The device defaults to cuda and the
command fails when CUDA is absent unless --device cpu is given.  A
"backend": "cpu" config serves from the CPU baseline on the host instead
(no device; "jax", the default, is the port's device program).

As in the reference's serve entrypoint, three library defaults are turned
on here.  Per-trace confidence diagnostics ($REPORTER_QUALITY_AUX=0 turns
them off).  The sparse-gap model: a trace (or session step) whose median
gap is at least sparse_gap_s (40 s) decodes with the time-adaptive
transitions and gap-conditioned breakage, per cohort from the
CALIBRATION.json that $REPORTER_CALIBRATION (or the matcher config's
"calibration") names, else from the config's sparse family
($REPORTER_SPARSE=0 reverts every trace to the dense model).  And the
device-resident session arena: streaming sessions keep their carried
beams in a device slab between submits ($REPORTER_SESSION_ARENA=0 keeps
them on the host, with the same answers).

The UBODT memory system keeps the library defaults, as in the reference:
the cuckoo layout and no probe dedup.  The config's matcher
"ubodt_layout" / "probe_dedup", or $REPORTER_UBODT_LAYOUT=wide32 and
$REPORTER_PROBE_DEDUP=1, change them (same answers);
$REPORTER_OBS_PROBE_EVERY=N samples the probe-outcome diagnostic on every
Nth dense bucketed dispatch.

The tiered UBODT: $REPORTER_UBODT_HOT_BYTES (or the matcher's
"ubodt_hot_bytes") > 0 keeps only that many bytes of hot bucket rows on
the card and reads the cold ones in place from pinned host memory (same
answers); $REPORTER_UBODT_SHARD=i/N seeds the hot set with bucket range
i of N.  $REPORTER_SESSION_ARENA_BYTES / _COLD_BYTES budget the session
slab and its pinned host cold tier.  $REPORTER_INTERPOLATE=1 (or the
matcher's "interpolate", or a request's match_options.interpolate) times
segment boundaries by free-flow speed.  The matcher's "devices" and
"graph_devices" (or $REPORTER_DEVICES / $REPORTER_GRAPH_DEVICES) spread
it over a dp x gp mesh of the visible cards (same answers; more cards
than are visible raises).

The first SIGTERM or SIGINT drains: new /report and
/trace_attributes_batch requests answer 503 "draining" with Retry-After,
/health answers 503 "draining", inflight requests finish (waited for up to
$REPORTER_DRAIN_GRACE_S, 30), open sessions get up to
$REPORTER_DRAIN_LINGER_S (1.5) for a handoff through GET
/sessions?export=1, then the server closes and the process exits 0.  A
second signal kills.  ``main`` restores the signal handlers it replaced
before it returns.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time

from ..obs import flight as obs_flight
from ..obs import log as obs_log
from .service import ReporterService, batch_options, build_matcher, parse_service_config


def serving_defaults(cfg):
    """Turn on, in a MatcherConfig, what the serve entry point turns on by
    default (see the module docstring); returns ``cfg``."""
    off = ("0", "false", "off", "no")
    if os.environ.get("REPORTER_QUALITY_AUX", "").strip().lower() not in off:
        cfg.quality_aux = True
    if os.environ.get("REPORTER_SESSION_ARENA", "").strip().lower() not in off:
        cfg.session_arena = True
    # the matcher's sparse model reads $REPORTER_SPARSE first: an explicit
    # off there still wins over this default
    cfg.sparse = True
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.serve",
        description="Serve /report and /trace_attributes_batch from the "
        "PyTorch/CUDA port, the sparse-gap "
        "model on ($REPORTER_SPARSE=0 turns it off, $REPORTER_CALIBRATION "
        "names per-cohort parameters).  The UBODT table is cuckoo without "
        "probe dedup unless the config's matcher ubodt_layout/probe_dedup or "
        "$REPORTER_UBODT_LAYOUT=wide32 / $REPORTER_PROBE_DEDUP=1 say "
        "otherwise; $REPORTER_OBS_PROBE_EVERY=N samples the UBODT "
        "probe-outcome diagnostic every Nth dispatch.")
    ap.add_argument("config", help="service config JSON (network, matcher, batch)")
    ap.add_argument("address", nargs="?", default=None,
                    help="host:port (default $MATCHER_BIND_ADDR:$MATCHER_LISTEN_PORT "
                         "or 0.0.0.0:8002)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    # the shared log switch ($REPORTER_LOG_FORMAT, $REPORTER_LOG_LEVEL) and
    # the flight recorder's dump when the drain ends
    obs_log.configure()
    obs_flight.install_shutdown_dump()
    try:
        cfg, conf = parse_service_config(args.config)
    except Exception as e:  # noqa: BLE001 - reported, exit 1
        sys.stderr.write("Problem with config file: %s\n" % (e,))
        return 1
    serving_defaults(cfg)
    if args.address:
        host, _, port = args.address.rpartition(":")
        host = host or "0.0.0.0"
    else:
        host = os.environ.get("MATCHER_BIND_ADDR", "0.0.0.0")
        port = os.environ.get("MATCHER_LISTEN_PORT", "8002")
    matcher = build_matcher(cfg, conf, device=args.device)
    service = ReporterService(matcher, robustness=conf.get("robustness", {}),
                              slo=conf.get("slo"), quality=conf.get("quality"),
                              economics=conf.get("economics"),
                              **batch_options(conf))
    server = service.make_server(host, int(port))
    # the drain joins the handler threads when the server closes
    server.daemon_threads = False
    server.block_on_close = True
    # the bound port (port 0 lets the system pick one)
    logging.info("serving /report and /trace_attributes_batch on %s:%d (device %s)",
                 host, server.server_address[1], matcher.device)
    grace = _env_seconds("REPORTER_DRAIN_GRACE_S", 30.0)
    linger = _env_seconds("REPORTER_DRAIN_LINGER_S", 1.5)
    signalled = threading.Event()

    def drain_then_stop():
        service.begin_drain()
        deadline = time.monotonic() + max(0.0, grace)
        while not service.idle() and time.monotonic() < deadline:
            time.sleep(0.05)
        if not service.idle():
            logging.warning("drain grace (%.1fs) expired with requests still inflight; "
                            "closing anyway", grace)
        # open sessions: linger for the handoff's export before closing
        if len(service.session_store) > 0 and linger > 0:
            until = min(time.monotonic() + linger, deadline)
            while time.monotonic() < until:
                time.sleep(0.05)
        server.shutdown()
        # a request that slipped past the last idle() sample finishes
        # before the idle keep-alive connections are cut
        until = time.monotonic() + 2.0
        while not service.idle() and time.monotonic() < until:
            time.sleep(0.05)
        server.close_lingering()

    def on_stop_signal(signum, _frame):
        # the drain runs on a thread of its own, not in signal context;
        # disarmed, so a second signal kills
        signal.signal(signum, signal.SIG_DFL)
        if not signalled.is_set():
            signalled.set()
            threading.Thread(target=drain_then_stop, daemon=True, name="drain").start()

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, on_stop_signal)
        except ValueError:  # not the main thread: no drain on signals
            pass
    try:
        server.serve_forever()
        if signalled.is_set():
            logging.info("drained; exiting")
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
        # the flight recorder's retained traces, once nothing records
        obs_flight.shutdown_dump()
        for sig, handler in previous.items():
            if handler is not None:
                signal.signal(sig, handler)
    return 0


def _env_seconds(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


if __name__ == "__main__":
    sys.exit(main())
