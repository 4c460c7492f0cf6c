"""The streaming topology: format -> key -> batch -> match -> anonymise.

The reference wires three Kafka Streams processors over the topics
``raw -> formatted -> batched`` (Reporter.java:151-181).  Here the same
pipeline is an in-process runtime object that any transport can drive:

  - tests / embedded: call ``feed(raw_record, timestamp_ms)`` directly
  - Kafka: ``reporter_tpu_torch.stream.kafka_io`` consumes a raw topic and drives
    the same object (kept behind an import guard -- kafka-python is not a
    hard dependency)

Per-vehicle ordering is the only thing Kafka partitioning guarantees the
reference (README.md:169-173: uuid-keyed partitions); feeding records
through one StreamPipeline preserves exactly that.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..obs import metrics as obs
from .anonymiser import AnonymisingProcessor
from .batcher import BatchingProcessor
from .formatter import Formatter

log = logging.getLogger(__name__)

C_FORMATTED = obs.counter(
    "reporter_stream_points_formatted_total",
    "Raw records successfully formatted into points")
C_DROPPED = obs.counter(
    "reporter_stream_points_dropped_total",
    "Raw records dropped as unparseable")


class StreamPipeline:
    def __init__(
        self,
        formatter: Formatter,
        batcher: BatchingProcessor,
        anonymiser: AnonymisingProcessor,
        log_every: int = 10000,
    ):
        self.formatter = formatter
        self.batcher = batcher  # its sink must already point downstream
        self.anonymiser = anonymiser
        self.formatted = 0
        self.dropped = 0
        self.log_every = log_every

    def feed(self, raw: str, timestamp_ms: int, partition: int = 0) -> None:
        """One raw probe record (swallow-and-log on parse failure,
        KeyedFormattingProcessor.java:39-41).  ``partition`` is the source
        topic partition the record arrived on -- the unit of state hand-off
        between consumer-group members (checkpoint.PartitionedStreamRunner);
        transports without partitions leave it 0."""
        try:
            uuid, point = self.formatter.format(raw)
        except Exception as e:
            self.dropped += 1
            C_DROPPED.inc()
            log.debug("unparseable record %r: %s", raw, e)
            return
        self.formatted += 1
        C_FORMATTED.inc()
        if self.formatted % self.log_every == 0:
            log.info("formatted %d messages", self.formatted)
        self.batcher.process(uuid, point, timestamp_ms, partition=partition)
        self.anonymiser.maybe_punctuate(timestamp_ms)

    def tick(self, timestamp_ms: int) -> None:
        """Periodic housekeeping: evict stale sessions, flush tiles."""
        self.batcher.flush_ready()
        self.batcher.punctuate(timestamp_ms)
        self.anonymiser.maybe_punctuate(timestamp_ms)

    def close(self, timestamp_ms: Optional[int] = None) -> None:
        """Drain everything: final relaxed reports + tile flush."""
        self.batcher.flush_ready()
        if timestamp_ms is None:
            timestamp_ms = max(
                (b.last_update for b in self.batcher.store.values()), default=0
            ) + 2 * self.batcher.session_gap_ms
        self.batcher.punctuate(timestamp_ms)
        self.anonymiser.punctuate()


def build_pipeline(
    format_config: str,
    client,
    privacy: int,
    quantisation: int,
    output: str,
    source: str,
    mode: str = "auto",
    report_levels=(0, 1),
    transition_levels=(0, 1),
    flush_interval_sec: int = 300,
    microbatch_size: int = 16,
) -> StreamPipeline:
    """Assemble the full pipeline from flat options (Reporter.java:43-136's
    option surface, minus the Kafka-specific ones)."""
    formatter = Formatter.from_config(format_config)
    anonymiser = AnonymisingProcessor(
        privacy=privacy,
        quantisation=quantisation,
        output=output,
        source=source,
        mode=mode,
        flush_interval_sec=flush_interval_sec,
    )
    batcher = BatchingProcessor(
        client=client,
        sink=anonymiser.process,
        mode=mode,
        report_levels=report_levels,
        transition_levels=transition_levels,
        microbatch_size=microbatch_size,
    )
    return StreamPipeline(formatter, batcher, anonymiser)
