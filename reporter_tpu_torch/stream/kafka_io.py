"""Kafka transport, kept behind an import guard.

Equivalents of the reference's Kafka-facing pieces:
  - ``produce_file``: cat_to_kafka.py -- pipe a file/stdin into a topic with
    user-supplied key/value/filter expressions (lambda source strings,
    cat_to_kafka.py:38-40)
  - ``run_pipeline``: the consumer side of Reporter.java's topology -- drive
    a StreamPipeline from a raw topic
  - ``print_topic``: PrintConsumer.java debug helper

kafka-python is optional; every entry point raises a clear error when it is
missing so the rest of the framework works without it.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Optional

log = logging.getLogger(__name__)


def _require_kafka():
    try:
        import kafka  # type: ignore

        return kafka
    except ImportError as e:
        raise RuntimeError(
            "kafka-python is not installed; the Kafka transport is unavailable "
            "(the in-process StreamPipeline and the batch pipeline do not need it)"
        ) from e


def compile_lambda(source: Optional[str], default: Callable) -> Callable:
    """User-supplied record accessors, e.g. "lambda line: line.split('|')[1]"
    (cat_to_kafka.py:38-40; same power, but via eval of a lambda expression
    only)."""
    if not source:
        return default
    fn = eval(source, {"__builtins__": __builtins__}, {})  # noqa: S307
    if not callable(fn):
        raise ValueError("expected a lambda expression, got %r" % (source,))
    return fn


def produce_file(
    lines: Iterable[str],
    topic: str,
    bootstrap: str,
    key_with: Optional[str] = None,
    value_with: Optional[str] = None,
    send_if: Optional[str] = None,
    log_every: int = 10000,
) -> int:
    kafka = _require_kafka()
    producer = kafka.KafkaProducer(bootstrap_servers=bootstrap)
    keyer = compile_lambda(key_with, lambda line: None)
    valuer = compile_lambda(value_with, lambda line: line)
    sender = compile_lambda(send_if, lambda line: True)
    produced = 0
    for line in lines:
        line = line.rstrip("\n")
        if not sender(line):
            continue
        key = keyer(line)
        producer.send(
            topic,
            key=key.encode() if isinstance(key, str) else key,
            value=valuer(line).encode(),
        )
        produced += 1
        if produced % log_every == 0:
            log.info("produced %d messages", produced)
    producer.flush()
    return produced


def run_pipeline(
    pipeline,
    topic: str,
    bootstrap: str,
    group: str = "reporter-tpu",
    duration_sec: Optional[float] = None,
    tick_sec: float = 30.0,
    on_tick: Optional[Callable[[int], None]] = None,
    on_close: Optional[Callable[[], bool]] = None,
    manual_commit: bool = False,
    runner=None,
) -> None:
    """Consume a raw topic and drive the StreamPipeline until duration (or
    forever).

    ``manual_commit=True`` turns off auto-commit and commits offsets only
    *after* each ``on_tick`` (i.e. after a state snapshot lands): on crash
    the consumer replays from the last snapshot's offsets instead of losing
    the window between auto-commit and snapshot -- at-least-once, the same
    guarantee Kafka Streams changelogs give the reference.

    ``on_close`` is the un-gated final snapshot (e.g. Checkpointer.save):
    after ``pipeline.close`` the loop takes one last snapshot and commits
    only when it lands, so the committed offsets always correspond to the
    state on disk -- including on graceful shutdown, where an interval-gated
    ``on_tick`` may decline to snapshot.

    ``runner`` (checkpoint.PartitionedStreamRunner) turns on MULTI-INSTANCE
    mode: the consumer subscribes with a rebalance listener, per-vehicle
    state is scoped to the source partition, and when a rebalance revokes a
    partition its in-flight state is checkpointed to the runner's shared
    directory (and the partition's offsets committed) so the next owner
    adopts it -- no lost or duplicated segment observations across the move.
    ``on_tick``/``on_close`` are ignored in this mode (the runner owns
    snapshots); manual_commit is forced on."""
    kafka = _require_kafka()
    if runner is not None:
        manual_commit = True
        on_tick = on_close = None
    consumer = kafka.KafkaConsumer(
        *([] if runner is not None else [topic]),
        bootstrap_servers=bootstrap,
        group_id=group,
        value_deserializer=lambda b: b.decode("utf-8", "replace"),
        enable_auto_commit=not manual_commit,
        # short poll bound so that on an idle topic (a) wall-clock ticks
        # still fire (the reference's punctuate is time-driven) and (b) a
        # SIGTERM shutdown flag is noticed well inside docker's 10 s grace
        consumer_timeout_ms=int(min(tick_sec, 1.0) * 1000),
    )
    if runner is not None:
        class _Listener(kafka.ConsumerRebalanceListener):
            def on_partitions_revoked(self, revoked):
                saved = runner.on_revoked([tp.partition for tp in revoked])
                offs = {}
                for tp in revoked:
                    if tp.partition not in saved:
                        continue  # snapshot failed: let the records replay
                    try:
                        offs[tp] = kafka.OffsetAndMetadata(consumer.position(tp), "")
                    except Exception:  # noqa: BLE001 - no position fetched yet
                        pass
                if offs:
                    consumer.commit(offs)

            def on_partitions_assigned(self, assigned):
                runner.on_assigned([tp.partition for tp in assigned])

        consumer.subscribe([topic], listener=_Listener())
    # Graceful shutdown (docker stop SIGTERM, Ctrl-C SIGINT) must reach the
    # final snapshot+commit below -- but a signal must never interrupt
    # pipeline.feed mid-mutation and then have the half-applied state
    # snapshotted and committed past.  So the handlers only SET A FLAG
    # (utils/shutdown.StopFlag; escalate means a second signal
    # force-terminates a wedged drain); the loop checks it between
    # messages, making shutdown deterministic.  Handler installation
    # no-ops off the main thread; there a raised KeyboardInterrupt still
    # exits, but lands in the no-commit path.
    from ..utils.shutdown import StopFlag

    stop_flag = StopFlag().install()

    start = time.time()
    last_tick = start
    graceful = False
    try:
        while True:
            for msg in consumer:
                ts_ms = msg.timestamp if msg.timestamp and msg.timestamp > 0 else int(
                    time.time() * 1000
                )
                pipeline.feed(msg.value, ts_ms, partition=msg.partition)
                if stop_flag.requested or time.time() - last_tick >= tick_sec:
                    break
            if stop_flag.requested:
                log.info("shutdown requested; flushing final state")
                break
            now = time.time()
            if now - last_tick >= tick_sec:
                if runner is not None:
                    # runner.tick snapshots every owned partition; commit
                    # only when all snapshots landed
                    if runner.tick(int(now * 1000)) and manual_commit:
                        consumer.commit()
                else:
                    pipeline.tick(int(now * 1000))
                    saved = on_tick(int(now * 1000)) if on_tick is not None else None
                    # commit only when a snapshot actually landed: on crash
                    # the consumer replays exactly from the restored state
                    if manual_commit and (on_tick is None or saved):
                        consumer.commit()
                last_tick = now
            if duration_sec is not None and now - start > duration_sec:
                break
        graceful = True
    except KeyboardInterrupt:
        # async interrupt (no flag handler installed, e.g. a non-main
        # thread): the current message may be half-applied.  Snapshotting
        # now would overwrite the last CONSISTENT interval snapshot with the
        # half-mutated state, so treat it exactly like a crash: no close, no
        # snapshot, no commit -- reboot restores the last good snapshot and
        # replays from its offsets (dupes allowed, loss and corruption not).
        log.info("async interrupt; exiting without snapshot or commit")
    finally:
        stop_flag.restore()
        if graceful:
            if runner is not None:
                # hand-off shutdown: snapshot owned partitions (the next
                # owner adopts the in-flight vehicles -- close() must NOT
                # force-report them), flush this instance's tiles, commit
                # only when every snapshot landed
                if runner.close(int(time.time() * 1000)) and manual_commit:
                    consumer.commit()
            else:
                pipeline.close(int(time.time() * 1000))
                # final snapshot AFTER close (close may flush tiles / mutate
                # state), then commit only if it landed: persisted state and
                # committed offsets stay in lockstep.  A crash commits
                # nothing.
                saved = on_close() if on_close is not None else None
                if manual_commit and (on_close is None or saved):
                    consumer.commit()
        consumer.close()


def print_topic(topic: str, bootstrap: str, limit: Optional[int] = None) -> None:
    kafka = _require_kafka()
    consumer = kafka.KafkaConsumer(topic, bootstrap_servers=bootstrap)
    for i, msg in enumerate(consumer):
        print("%s %s" % (msg.key, msg.value))
        if limit is not None and i + 1 >= limit:
            break
