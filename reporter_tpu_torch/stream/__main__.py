"""Streaming runtime CLI -- the ``reporter-kafka`` equivalent
(Reporter.java:43-136's option surface).

    python -m reporter_tpu_torch.stream \
        --format ',sv,\\|,1,9,10,0,5,yyyy-MM-dd HH:mm:ss' \
        --reporter-url http://localhost:8002/report \
        --privacy 2 --quantisation 3600 --flush-interval 300 \
        --source TEST --output /results \
        [--bootstrap host:9092 --topic raw | reads stdin]
"""

import argparse
import logging
import os
import sys
import time

from .client import HttpMatcherClient
from .topology import build_pipeline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--format", required=True, help="formatter mini-DSL string")
    ap.add_argument("--reporter-url", required=True, help="matcher /report endpoint")
    ap.add_argument("--privacy", type=int, required=True)
    ap.add_argument("--quantisation", type=int, required=True)
    ap.add_argument("--flush-interval", type=int, default=300, help="seconds")
    ap.add_argument("--source", required=True)
    ap.add_argument("--output", required=True, help="dir, http(s) url, or s3://bucket")
    ap.add_argument("--mode", default="auto")
    # container knobs exactly like the reference (README.md:419-422,
    # docker-compose.yml:13-14): env sets the default, the flag overrides
    ap.add_argument("--reports", default=os.environ.get("REPORT_LEVELS", "0,1"),
                    help="report levels csv (env REPORT_LEVELS)")
    ap.add_argument("--transitions",
                    default=os.environ.get("TRANSITION_LEVELS", "0,1"),
                    help="transition levels csv (env TRANSITION_LEVELS)")
    ap.add_argument("--microbatch", type=int, default=16)
    ap.add_argument("--bootstrap", default=None, help="kafka bootstrap servers")
    ap.add_argument("--topic", default="raw")
    ap.add_argument("--duration", type=float, default=None, help="seconds to run")
    ap.add_argument("--checkpoint", default=None,
                    help="state snapshot file: restored at boot, written on "
                         "an interval and at close (the Kafka state-store "
                         "durability equivalent; single-instance)")
    ap.add_argument("--checkpoint-interval", type=float, default=60.0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="PARTITION-scoped snapshot directory shared by all "
                         "instances of the consumer group (NFS/shared disk): "
                         "in-flight vehicle state follows partitions across "
                         "rebalances, so N instances scale out like the "
                         "reference's Kafka Streams stores.  Kafka mode only; "
                         "mutually exclusive with --checkpoint")
    args = ap.parse_args(argv)

    # the shared log switch (REPORTER_LOG_FORMAT=json|text,
    # REPORTER_LOG_LEVEL) + flight-recorder dump on SIGTERM/fatal
    from ..obs import flight as obs_flight
    from ..obs import log as obs_log
    from ..utils.shutdown import on_shutdown

    obs_log.configure()
    obs_flight.install_shutdown_dump()
    on_shutdown(obs_flight.shutdown_dump)

    pipeline = build_pipeline(
        format_config=args.format,
        client=HttpMatcherClient(args.reporter_url),
        privacy=args.privacy,
        quantisation=args.quantisation,
        output=args.output,
        source=args.source,
        mode=args.mode,
        report_levels=[int(x) for x in args.reports.split(",") if x != ""],
        transition_levels=[int(x) for x in args.transitions.split(",") if x != ""],
        flush_interval_sec=args.flush_interval,
        microbatch_size=args.microbatch,
    )

    from .checkpoint import Checkpointer, PartitionedStreamRunner, load_file

    if args.checkpoint and args.checkpoint_dir:
        ap.error("--checkpoint and --checkpoint-dir are mutually exclusive")
    if args.checkpoint_dir and not args.bootstrap:
        ap.error("--checkpoint-dir needs the Kafka transport (--bootstrap)")

    ckpt = Checkpointer(pipeline, args.checkpoint, args.checkpoint_interval)
    if args.checkpoint:
        load_file(pipeline, args.checkpoint)

    if args.bootstrap:
        from .kafka_io import run_pipeline

        runner = (
            PartitionedStreamRunner(pipeline, args.checkpoint_dir)
            if args.checkpoint_dir else None
        )
        run_pipeline(
            pipeline, args.topic, args.bootstrap, duration_sec=args.duration,
            on_tick=ckpt.maybe_save,
            # the final (post-close) snapshot happens inside run_pipeline so
            # its offset commit can be conditioned on the snapshot landing
            on_close=ckpt.save,
            # coordinate offset commits with snapshots so a crash replays
            # from the restored state instead of dropping the gap
            manual_commit=bool(args.checkpoint),
            runner=runner,
        )
    else:
        # stdin transport: a stop signal (docker SIGTERM, Ctrl-C) must still
        # flush half-grown state, and it must do so WITHOUT interrupting a
        # pipeline mutation mid-flight (the kafka path's documented hazard:
        # a raise-based handler could snapshot half-applied state).  The
        # handler only sets a flag; the read loop polls it between records
        # via a selectors timeout -- a pure flag never wakes a blocking
        # readline (PEP 475 retries it), so stdin is read non-blockingly.
        # close()+save run only on a CLEAN stop (flag/EOF/duration): a crash
        # must not overwrite the last good snapshot with drained state.
        import selectors

        from ..utils.shutdown import StopFlag

        flag = StopFlag().install()
        # an embedder may have replaced sys.stdin with a non-file object
        # (the finally-block below exists for exactly such callers): only
        # take the raw-fd fast path when the real buffer is there, else
        # fall back to plain line iteration with the flag polled per line
        raw_stdin = getattr(getattr(sys.stdin, "buffer", None), "raw", None)
        sel = None
        try:
            start = time.time()
            if raw_stdin is None:
                it = iter(sys.stdin)
                while True:
                    try:
                        line = next(it)
                    except StopIteration:
                        break
                    except UnicodeDecodeError:
                        continue  # strict embedder wrapper; raw path
                        # substitutes U+FFFD -- skip, don't abort the stream
                    # feed BEFORE the stop checks: a line already consumed
                    # from the iterator must not be dropped on shutdown
                    now_ms = int(time.time() * 1000)
                    pipeline.feed(line.rstrip("\n").rstrip("\r"), now_ms)
                    ckpt.maybe_save(now_ms)
                    if flag.requested or (
                            args.duration is not None
                            and time.time() - start > args.duration):
                        break
            else:
                fd = raw_stdin.fileno()
                # epoll cannot watch REGULAR files (EPERM on
                # `cli < probes.sv`); file reads never block indefinitely,
                # so the selector -- needed for pipe liveness under a stop
                # signal -- is skipped for them
                try:
                    sel = selectors.DefaultSelector()
                    sel.register(raw_stdin, selectors.EVENT_READ)
                except (PermissionError, ValueError):
                    if sel is not None:
                        sel.close()
                    sel = None
                buf = b""
                eof = False
                while not (flag.requested or eof):
                    now = time.time()
                    if args.duration is not None and now - start > args.duration:
                        break
                    if sel is not None and not sel.select(timeout=0.5):
                        ckpt.maybe_save(int(now * 1000))
                        continue
                    chunk = os.read(fd, 1 << 16)
                    if not chunk:
                        eof = True
                    else:
                        buf += chunk
                    now_ms = int(time.time() * 1000)
                    *lines, buf = buf.split(b"\n")
                    for raw in lines:
                        pipeline.feed(raw.decode("utf-8", "replace").rstrip("\r"), now_ms)
                    ckpt.maybe_save(now_ms)
                if buf and eof:  # trailing record without newline
                    pipeline.feed(buf.decode("utf-8", "replace").rstrip("\r"),
                                  int(time.time() * 1000))
            if flag.requested:
                logging.info("stop signal: flushing before exit")
            pipeline.close(int(time.time() * 1000))
            ckpt.save()
        finally:
            # embedders may call main() repeatedly: give back the signal
            # handlers and the selector fd (close/save above run only on a
            # clean stop -- a crash must not overwrite the last snapshot)
            flag.restore()
            if sel is not None:
                sel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
