"""CLI: python -m reporter_tpu_torch.serve [--device cuda|cpu] <config.json> [host:port]

Serves /report and /health from the PyTorch/CUDA port.  The config has the
shape of the reference service's (deploy/config.service.json): "network"
(grid or file), "matcher" (MatcherConfig fields or meili keys) and "batch"
(max_batch, max_wait_ms).  The device defaults to cuda and the command
fails when CUDA is absent unless --device cpu is given.

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
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .service import ReporterService, build_matcher, parse_service_config


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
        description="Serve /report from the PyTorch/CUDA port, the sparse-gap "
        "model on ($REPORTER_SPARSE=0 turns it off, $REPORTER_CALIBRATION "
        "names per-cohort parameters).")
    ap.add_argument("config", help="service config JSON (network, matcher, batch)")
    ap.add_argument("address", nargs="?", default=None,
                    help="host:port (default $MATCHER_BIND_ADDR:$MATCHER_LISTEN_PORT "
                         "or 0.0.0.0:8002)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=os.environ.get("REPORTER_LOG_LEVEL", "INFO"))
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
    batch = conf.get("batch", {})
    service = ReporterService(matcher, max_batch=int(batch.get("max_batch", 64)),
                              max_wait_ms=float(batch.get("max_wait_ms", 10.0)))
    server = service.make_server(host, int(port))
    logging.info("serving /report on %s:%s (device %s)", host, port, matcher.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
