"""Per-vehicle windowing: accumulate points, flush ready batches to the
matcher, forward segment observations downstream.

Behavioral port of BatchingProcessor.java with one structural change: ready
batches are *pooled* and flushed together through ``client.report_many`` so
the device matches a [B, T] micro-batch instead of one trace per POST
(``microbatch_size=1`` reproduces the reference's per-point synchronous
behavior exactly).

Semantics preserved:
  - report gate: >= 500 m spread, >= 10 points, >= 60 s elapsed
    (BatchingProcessor.java:26-29)
  - stale sessions (no update for > session_gap) are evicted on punctuate
    and given a last chance to report with relaxed thresholds (0 m, 2
    points, 0 s) (BatchingProcessor.java:96-103)
  - each datastore report becomes a Segment forwarded with key
    "id next_id" so downstream partitions see whole tiles
    (BatchingProcessor.java:108-141); invalid segments are logged + dropped
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from ..obs import metrics as obs
from .batch import Batch
from .point import Point
from .segment import Segment

log = logging.getLogger(__name__)

C_FLUSHES = obs.counter(
    "reporter_stream_batches_emitted_total",
    "Pooled micro-batch flushes sent to the matcher")
C_FORWARDED = obs.counter(
    "reporter_stream_segments_forwarded_total",
    "Valid segment pairs forwarded to the anonymiser")
C_EVICTED = obs.counter(
    "reporter_stream_sessions_evicted_total",
    "Stale vehicle sessions evicted on punctuate")

REPORT_TIME = 60  # seconds
REPORT_COUNT = 10  # points
REPORT_DIST = 500  # meters
SESSION_GAP_MS = 60000


class BatchingProcessor:
    def __init__(
        self,
        client,
        sink: Callable[[str, Segment], None],
        mode: str = "auto",
        report_levels=(0, 1),
        transition_levels=(0, 1),
        report_dist: float = REPORT_DIST,
        report_count: int = REPORT_COUNT,
        report_time: float = REPORT_TIME,
        session_gap_ms: int = SESSION_GAP_MS,
        microbatch_size: int = 1,
    ):
        self.client = client
        self.sink = sink
        self.mode = mode
        self.report_levels = tuple(report_levels)
        self.transition_levels = tuple(transition_levels)
        self.report_dist = report_dist
        self.report_count = report_count
        self.report_time = report_time
        self.session_gap_ms = session_gap_ms
        self.microbatch_size = max(1, microbatch_size)
        self.store: Dict[str, Batch] = {}
        self._ready: List[str] = []  # uuids awaiting a micro-batch flush
        # source partition per uuid: the unit of state hand-off between
        # consumer-group members (the reference gets this scoping for free
        # from Kafka Streams' per-partition state stores,
        # BatchingProcessor.java:19-22; here checkpoint.snapshot_partition
        # selects on it during a rebalance)
        self.partitions: Dict[str, int] = {}
        self.reported_pairs = 0

    # -- stream hooks ------------------------------------------------------

    def process(self, key: str, point: Point, timestamp_ms: int,
                partition: int = 0) -> None:
        self.partitions[key] = partition
        batch = self.store.get(key)
        if batch is None:
            batch = Batch(point)
            self.store[key] = batch
            batch.last_update = timestamp_ms
        else:
            batch.update(point)
            batch.last_update = timestamp_ms
            if batch.meets(self.report_dist, self.report_count, self.report_time):
                if key not in self._ready:
                    self._ready.append(key)
                if len(self._ready) >= self.microbatch_size:
                    # may consume the batch entirely and drop it from the store
                    self.flush_ready()

    def punctuate(self, timestamp_ms: int) -> None:
        """Evict stale sessions, giving each a relaxed final report."""
        stale = [
            k
            for k, b in self.store.items()
            if timestamp_ms - b.last_update > self.session_gap_ms
        ]
        requests, keys = [], []
        for k in stale:
            batch = self.store.pop(k)
            self.partitions.pop(k, None)
            if k in self._ready:
                self._ready.remove(k)
            if batch.meets(0, 2, 0):
                log.debug("evicting %s with a final report", k)
                requests.append(
                    batch.request(k, self.mode, self.report_levels, self.transition_levels)
                )
                keys.append(k)
            else:
                log.debug("evicting %s (too little data)", k)
        C_EVICTED.inc(len(stale))
        for resp in self.client.report_many(requests):
            self._forward(resp)

    def flush_ready(self) -> None:
        """Flush the pooled ready batches as one micro-batch."""
        if not self._ready:
            return
        keys = [k for k in self._ready if k in self.store]
        self._ready.clear()
        keys = [
            k
            for k in keys
            if self.store[k].meets(self.report_dist, self.report_count, self.report_time)
        ]
        if not keys:
            return
        requests = [
            self.store[k].request(k, self.mode, self.report_levels, self.transition_levels)
            for k in keys
        ]
        C_FLUSHES.inc()
        responses = self.client.report_many(requests)
        for k, resp in zip(keys, responses):
            batch = self.store[k]
            before = len(batch.points)
            batch.apply_response(resp)
            if len(batch.points) != before:
                log.debug("%s trimmed %d -> %d", k, before, len(batch.points))
            if not batch.points:
                del self.store[k]
                self.partitions.pop(k, None)
            self._forward(resp)

    # -- downstream --------------------------------------------------------

    def _forward(self, response: Optional[dict]) -> int:
        if not isinstance(response, dict):
            return 0
        reports = (response.get("datastore") or {}).get("reports")
        if reports is None:
            log.error("unusable report %r", response)
            return 0
        n = 0
        for rep in reports:
            try:
                seg = Segment(
                    id=int(rep["id"]),
                    next_id=None if rep.get("next_id") is None else int(rep["next_id"]),
                    min=float(rep["t0"]),
                    max=float(rep["t1"]),
                    length=int(rep["length"]),
                    queue=int(rep["queue_length"]),
                )
            except Exception as e:
                log.error("unusable reported segment pair %r (%s)", rep, e)
                continue
            if seg.valid():
                self.sink("%d %d" % (seg.id, seg.next_id), seg)
                n += 1
            else:
                log.warning("got back invalid segment: %r", seg)
        self.reported_pairs += n
        C_FORWARDED.inc(n)
        return n

    # -- partition state hand-off -----------------------------------------

    def take_partition(self, partition: int):
        """Remove and return this partition's in-flight state:
        (batches: {uuid: Batch}, ready: [uuid]).  Used when a rebalance
        revokes the partition -- the state travels to the next owner via a
        partition checkpoint (checkpoint.PartitionCheckpointer)."""
        uuids = [k for k, p in self.partitions.items() if p == partition]
        batches = {}
        ready = []
        for k in uuids:
            b = self.store.pop(k, None)
            if b is not None:
                batches[k] = b
            self.partitions.pop(k, None)
            if k in self._ready:
                self._ready.remove(k)
                ready.append(k)
        return batches, ready

    def put_partition(self, partition: int, batches, ready) -> None:
        """Adopt a partition's in-flight state (inverse of take_partition)."""
        for k, b in batches.items():
            self.store[k] = b
            self.partitions[k] = partition
        for k in ready:
            if k in self.store and k not in self._ready:
                self._ready.append(k)
