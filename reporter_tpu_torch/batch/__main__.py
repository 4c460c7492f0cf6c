"""Batch pipeline CLI -- the simple_reporter.py equivalent, on the card.

    python -m reporter_tpu_torch.batch \
        --src /archive/dir            (or s3://bucket) \
        --match-config conf.json \
        --dest dir:/out               (or s3://bucket, http://...) \
        --privacy 2 --quantisation 3600 --source-id smpl_rprt \
        [--device cuda|cpu] [--backend jax|cpu] [--warmup] [--metrics]

Resume: --trace-dir skips gathering, --match-dir skips matching
(simple_reporter.py:350-363).  ``--device`` (default cuda) places the
matcher; without a card, ``cuda`` raises rather than running on the CPU.
"""

import argparse
import multiprocessing
import sys


def check_box(bbox: str):
    try:
        b = [float(x) for x in bbox.split(",")]
    except ValueError:
        raise argparse.ArgumentTypeError("%s is not a valid bbox" % bbox)
    if len(b) != 4:
        raise argparse.ArgumentTypeError(
            "bbox needs exactly 4 values (min_lat,min_lon,max_lat,max_lon), got %d" % len(b)
        )
    if b[0] < -90 or b[1] < -180 or b[2] > 90 or b[3] > 180 or b[0] >= b[2] or b[1] >= b[3]:
        raise argparse.ArgumentTypeError("%s is not a valid bbox" % bbox)
    return b


def int_set(ints: str):
    return set(int(i) for i in ints.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m reporter_tpu_torch.batch",
                                 description=__doc__)
    ap.add_argument("--src", help="archive: a directory or s3://bucket")
    ap.add_argument("--src-prefix", default="")
    ap.add_argument("--src-key-regex", default=".*")
    ap.add_argument("--src-valuer", default=None,
                    help="lambda line -> (uuid, time, lat, lon, accuracy)")
    ap.add_argument("--src-time-pattern", default="%Y-%m-%d %H:%M:%S",
                    help="strptime pattern; empty string means epoch seconds")
    ap.add_argument("--match-config", required=True,
                    help="service config JSON (network + matcher + backend)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the matcher's device "
                         "program runs")
    ap.add_argument("--backend", choices=["jax", "cpu"], default=None,
                    help="override the config's matcher backend: the device "
                         "program (jax, the configs' word for it) or the CPU "
                         "baseline, for segment-for-segment diffing of the "
                         "same backfill")
    ap.add_argument("--mode", default="auto")
    ap.add_argument("--report-levels", type=int_set, default={0, 1})
    ap.add_argument("--transition-levels", type=int_set, default={0, 1})
    ap.add_argument("--quantisation", type=int, default=3600)
    ap.add_argument("--inactivity", type=int, default=120)
    ap.add_argument("--privacy", type=int, default=2)
    ap.add_argument("--source-id", default="smpl_rprt")
    ap.add_argument("--dest", default=None, help="dir:/path, s3://bucket, or http url")
    ap.add_argument("--concurrency", type=int, default=multiprocessing.cpu_count())
    ap.add_argument("--microbatch", type=int, default=256)
    ap.add_argument("--bbox", type=check_box, default=[-90.0, -180.0, 90.0, 180.0])
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--match-dir", default=None)
    ap.add_argument("--no-cleanup", action="store_true")
    ap.add_argument("--metrics", action="store_true",
                    help="on exit, print ONE merged JSON metrics snapshot "
                         "covering this process and every fan-out worker")
    ap.add_argument("--warmup", action="store_true",
                    help="pre-dispatch every configured (batch rung, length "
                         "bucket, viterbi kernel) shape plus the carry-chain "
                         "programs before phase 2 starts matching, so the "
                         "kernels' build and first launches land in a visible "
                         "warmup pass instead of the first micro-batches")
    args = ap.parse_args(argv)

    # the shared log switch (REPORTER_LOG_FORMAT=json|text,
    # REPORTER_LOG_LEVEL) + flight-recorder dump on SIGTERM/fatal
    from ..obs import flight as obs_flight
    from ..obs import log as obs_log
    from ..utils.shutdown import on_shutdown

    obs_log.configure()
    obs_flight.install_shutdown_dump()
    on_shutdown(obs_flight.shutdown_dump)

    from ..device import resolve_device
    from ..serve.service import build_matcher, parse_service_config
    from .pipeline import run_pipeline

    cfg, conf = parse_service_config(args.match_config)
    if args.backend is not None:
        conf = dict(conf, backend=args.backend)
    if conf.get("backend", "jax") == "jax":
        # before anything is read: no card means no run, not a CPU run
        resolve_device(args.device)
    matcher = build_matcher(cfg, conf, device=args.device)
    if args.warmup:
        matcher.warmup(carry_chain=True)
    trace_dir, match_dir = run_pipeline(
        matcher,
        archive_spec=args.src,
        dest_store=args.dest,
        trace_dir=args.trace_dir,
        match_dir=args.match_dir,
        cleanup=not args.no_cleanup,
        prefix=args.src_prefix,
        key_regex=args.src_key_regex,
        valuer=args.src_valuer,
        time_pattern=args.src_time_pattern or None,
        bbox=args.bbox,
        concurrency=args.concurrency,
        mode=args.mode,
        report_levels=args.report_levels,
        transition_levels=args.transition_levels,
        quantisation=args.quantisation,
        inactivity=args.inactivity,
        source=args.source_id,
        privacy=args.privacy,
        microbatch=args.microbatch,
    )
    if trace_dir or match_dir:
        print("trace_dir=%s match_dir=%s" % (trace_dir, match_dir))
    if args.metrics:
        # one snapshot covering all processes: the head's registry (phase 2
        # runs in-process) merged with every fan-out worker's dump
        import json

        from ..obs import metrics as obs
        from .pipeline import WORKER_SNAPSHOTS

        print(json.dumps(
            obs.merge(obs.REGISTRY.snapshot(), *WORKER_SNAPSHOTS),
            separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
