"""Stream-state checkpoint/restore.

The reference's streaming state -- in-flight per-vehicle batches and the
anonymiser's tile slices -- lives in Kafka Streams state stores and survives
restarts via changelog topics (SURVEY.md §5 checkpoint/resume:
BatchingProcessor.java:20-22, AnonymisingProcessor.java:47-59).  This
framework's stream runtime is broker-agnostic (stdin or Kafka transport), so
durability is a local snapshot instead: the same binary serdes the wire
format uses (Batch.pack / Segment.pack, the Batch.java:92-146 and
Segment.java:76-129 layouts) wrapped in a JSON envelope, written atomically.

Wire-up: ``python -m reporter_tpu_torch.stream --checkpoint state.ckpt
[--checkpoint-interval 60]`` restores at boot when the file exists and
snapshots on every interval tick and at close.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import time as _time
from typing import Optional

from ..obs import metrics as obs
from .batch import Batch
from .segment import pack_list, unpack_list

log = logging.getLogger(__name__)

C_CHECKPOINTS = obs.counter(
    "reporter_stream_checkpoints_total",
    "Successful stream-state snapshots to disk")
G_CHECKPOINT_TS = obs.gauge(
    "reporter_stream_checkpoint_unix_seconds",
    "Wall clock of the last successful snapshot; checkpoint lag at scrape "
    "time is time() - this")

VERSION = 1


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode())


def snapshot(pipeline) -> dict:
    """Serialise a StreamPipeline's mutable state."""
    batcher = pipeline.batcher
    anon = pipeline.anonymiser
    return {
        "version": VERSION,
        "formatted": pipeline.formatted,
        "dropped": pipeline.dropped,
        "batcher": {
            "store": {k: _b64(b.pack()) for k, b in batcher.store.items()},
            "ready": list(batcher._ready),
            "reported_pairs": batcher.reported_pairs,
        },
        "anonymiser": {
            "map": [[list(tile), idx] for tile, idx in anon.map.items()],
            "slices": {name: _b64(pack_list(segs)) for name, segs in anon.slices.items()},
            "last_flush_ms": anon._last_flush_ms,
            "tiles_flushed": anon.tiles_flushed,
        },
    }


def restore(pipeline, state: dict) -> None:
    """Load a snapshot into a freshly-built StreamPipeline (in place)."""
    if state.get("version") != VERSION:
        raise ValueError("unsupported checkpoint version %r" % (state.get("version"),))
    pipeline.formatted = int(state.get("formatted", 0))
    pipeline.dropped = int(state.get("dropped", 0))

    b = state.get("batcher", {})
    batcher = pipeline.batcher
    batcher.store = {k: Batch.unpack(_unb64(v)) for k, v in b.get("store", {}).items()}
    batcher._ready = [k for k in b.get("ready", []) if k in batcher.store]
    batcher.reported_pairs = int(b.get("reported_pairs", 0))

    a = state.get("anonymiser", {})
    anon = pipeline.anonymiser
    anon.map = {tuple(tile): int(idx) for tile, idx in a.get("map", [])}
    anon.slices = {
        name: unpack_list(_unb64(v)) for name, v in a.get("slices", {}).items()
    }
    anon._last_flush_ms = a.get("last_flush_ms")
    anon.tiles_flushed = int(a.get("tiles_flushed", 0))


def save_file(pipeline, path: str) -> None:
    """Atomic snapshot-to-disk (tmp + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snapshot(pipeline), f, separators=(",", ":"))
    os.replace(tmp, path)
    log.debug("checkpointed stream state to %s", path)


def _set_aside(path: str) -> str:
    """Move a bad checkpoint out of the boot path, preserving it for
    post-mortem.  Returns where it went (or a marker when even the rename
    fails)."""
    aside = path + ".corrupt"
    try:
        os.replace(path, aside)
    except OSError:
        aside = "<unmovable>"
    return aside


def load_file(pipeline, path: str) -> bool:
    """Restore from ``path`` if it exists.  Returns True when state was
    loaded.

    A corrupt or incompatible file must NOT crash-loop the boot (a
    container restart policy can never escape it, while live traffic
    keeps flowing past): any parse/restore failure rolls the pipeline
    back to its pre-load state, sets the bad file aside as
    ``<path>.corrupt`` for post-mortem, and boots clean -- the same
    loss profile as having no checkpoint.  ``restore`` itself stays
    strict for programmatic callers."""
    if not os.path.exists(path):
        return False
    # drift-proof rollback: capture the pre-load state with the same serde
    # restore() consumes, so a mid-restore failure can never leave behind a
    # field this code forgot to save (snapshot/restore own the field list)
    prior = snapshot(pipeline)
    try:
        with open(path) as f:
            state = json.load(f)
        restore(pipeline, state)
    except Exception:  # noqa: BLE001 - boot seam: log, preserve, continue
        restore(pipeline, prior)
        aside = _set_aside(path)
        log.exception(
            "stream checkpoint %s is unreadable; set aside as %s, booting "
            "clean (in-flight windows from the previous run are lost)",
            path, aside)
        return False
    log.info(
        "restored stream state from %s: %d in-flight vehicles, %d tile slices",
        path, len(pipeline.batcher.store), len(pipeline.anonymiser.slices),
    )
    return True


class Checkpointer:
    """Interval-driven snapshots for the stream CLI loop."""

    def __init__(self, pipeline, path: Optional[str], interval_sec: float = 60.0):
        self.pipeline = pipeline
        self.path = path
        self.interval_ms = int(interval_sec * 1000)
        self._last_ms: Optional[int] = None

    def maybe_save(self, timestamp_ms: int) -> bool:
        """Snapshot if the interval elapsed.  Returns True when a snapshot
        landed (the Kafka loop commits offsets only then)."""
        if not self.path:
            return False
        if self._last_ms is None or timestamp_ms - self._last_ms >= self.interval_ms:
            self._last_ms = timestamp_ms
            return self.save()
        return False

    def save(self) -> bool:
        """Best-effort: a failed snapshot (full disk, lost mount) must not
        take the stream down -- log and keep running, like the anonymiser's
        store failures."""
        if not self.path:
            return False
        try:
            save_file(self.pipeline, self.path)
            C_CHECKPOINTS.inc()
            G_CHECKPOINT_TS.set(_time.time())
            return True
        except Exception:
            # not just OSError: serialisation of corrupt in-flight state
            # (struct.error, TypeError from json.dump) must not kill the
            # stream either -- the offsets simply stay uncommitted
            log.exception("stream checkpoint to %s failed; continuing", self.path)
            return False


# ---------------------------------------------------------------------------
# partition-scoped checkpoints (multi-instance streaming)
#
# The reference runs N `reporter-kafka` instances in one consumer group;
# Kafka Streams scopes each state store to a topic partition and migrates it
# (via changelog topics) when a rebalance moves the partition
# (BatchingProcessor.java:19-22, README.md:169-173).  The equivalent here:
# per-partition snapshot files in a directory every group member can reach
# (shared disk / NFS / object-store mount).  On revoke the member snapshots
# the partition's in-flight vehicle batches and drops them locally; on
# assign the next owner loads the file.  Tile-slice (anonymiser) state stays
# instance-local by design: segment observations already forwarded belong to
# the instance that produced them, and tile filenames are uuid4-suffixed so
# concurrent writers never collide -- the same split the reference gets from
# the separate `batched` topic.


def snapshot_partition(pipeline, partition: int) -> dict:
    """Extract (destructively) one partition's in-flight batcher state."""
    batches, ready = pipeline.batcher.take_partition(partition)
    return {
        "version": VERSION,
        "partition": partition,
        "store": {k: _b64(b.pack()) for k, b in batches.items()},
        "ready": ready,
    }


def restore_partition(pipeline, state: dict) -> int:
    """Adopt a partition snapshot produced by snapshot_partition."""
    if state.get("version") != VERSION:
        raise ValueError("unsupported checkpoint version %r" % (state.get("version"),))
    part = int(state["partition"])
    batches = {k: Batch.unpack(_unb64(v)) for k, v in state.get("store", {}).items()}
    pipeline.batcher.put_partition(part, batches, state.get("ready", []))
    return len(batches)


class PartitionCheckpointer:
    """Directory of per-partition snapshot files (part-<n>.ckpt)."""

    def __init__(self, pipeline, directory: str):
        self.pipeline = pipeline
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, partition: int) -> str:
        return os.path.join(self.dir, "part-%05d.ckpt" % partition)

    def save(self, partition: int) -> bool:
        """Snapshot + drop the partition's local state.  Best-effort like
        Checkpointer.save: a failed write logs and returns False (offsets
        for the partition then stay uncommitted, so the records replay)."""
        try:
            state = snapshot_partition(self.pipeline, partition)
            tmp = self._path(partition) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f, separators=(",", ":"))
            os.replace(tmp, self._path(partition))
            log.info("checkpointed partition %d (%d vehicles) to %s",
                     partition, len(state["store"]), self._path(partition))
            return True
        except Exception:
            log.exception("partition %d checkpoint failed; continuing", partition)
            return False

    def save_keep(self, partition: int) -> bool:
        """Interval snapshot that KEEPS the local state (the partition is
        still owned): snapshot_partition is destructive, so re-adopt."""
        try:
            state = snapshot_partition(self.pipeline, partition)
            restore_partition(self.pipeline, state)
            tmp = self._path(partition) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f, separators=(",", ":"))
            os.replace(tmp, self._path(partition))
            return True
        except Exception:
            log.exception("partition %d checkpoint failed; continuing", partition)
            return False

    def load(self, partition: int) -> int:
        """Adopt the partition's snapshot if one exists.  Returns vehicles
        restored.

        Same corrupt-file seam as load_file: a bad snapshot must not
        crash-loop the rebalance (every reassignment of the partition
        would re-raise, fleet-wide); it is set aside as .corrupt and the
        partition boots clean.  restore_partition parses the whole
        snapshot before its single put_partition mutation, so there is no
        partial state to roll back."""
        path = self._path(partition)
        if not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                state = json.load(f)
            n = restore_partition(self.pipeline, state)
        except Exception:  # noqa: BLE001 - rebalance seam: log + continue
            aside = _set_aside(path)
            log.exception(
                "partition %d checkpoint %s is unreadable; set aside as %s, "
                "booting the partition clean", partition, path, aside)
            return 0
        log.info("restored partition %d (%d vehicles) from %s", partition, n, path)
        return n


class PartitionedStreamRunner:
    """Transport-agnostic consumer-group member: owns the rebalance
    protocol around a StreamPipeline.  The Kafka loop (kafka_io) wires its
    callbacks to a ConsumerRebalanceListener; the fake-broker test drives
    them directly -- same code path either way."""

    def __init__(self, pipeline, ckpt_dir: str):
        self.pipeline = pipeline
        self.ckpt = PartitionCheckpointer(pipeline, ckpt_dir)
        self.assigned: set = set()

    def on_assigned(self, partitions) -> None:
        for p in partitions:
            if p not in self.assigned:
                self.ckpt.load(p)
                self.assigned.add(p)

    def on_revoked(self, partitions) -> "list[int]":
        """Flush pending micro-batches (their responses may trim in-flight
        state), snapshot each revoked partition, drop it locally.  Returns
        the partitions whose snapshot landed -- the caller commits offsets
        only for those."""
        self.pipeline.batcher.flush_ready()
        saved = []
        for p in partitions:
            if p in self.assigned:
                if self.ckpt.save(p):
                    saved.append(p)
                self.assigned.discard(p)
        return saved

    def feed(self, raw: str, timestamp_ms: int, partition: int) -> None:
        self.pipeline.feed(raw, timestamp_ms, partition=partition)

    def tick(self, timestamp_ms: int) -> bool:
        """Periodic housekeeping + interval snapshots of every owned
        partition.  Returns True when all snapshots landed (commit gate)."""
        self.pipeline.tick(timestamp_ms)
        self.pipeline.batcher.flush_ready()
        return all(self.ckpt.save_keep(p) for p in sorted(self.assigned))

    def close(self, timestamp_ms: int) -> bool:
        """Graceful shutdown: final snapshots BEFORE close's drain (the
        drain force-reports leftover batches; vehicles still unreportable
        belong to the next owner), then drain and flush tiles."""
        self.pipeline.batcher.flush_ready()
        ok = all(self.ckpt.save(p) for p in sorted(self.assigned))
        self.assigned.clear()
        self.pipeline.close(timestamp_ms)
        return ok
