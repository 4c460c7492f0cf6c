"""The three batch phases (behavioral port of py/simple_reporter.py).

Phase 1  get_traces   -- crawl an archive (local dir, or S3 when boto3 is
                         importable), parse each record with a user valuer,
                         bbox-filter, and append to uuid-hash shard files
                         (3 hex chars of sha1, simple_reporter.py:116) so one
                         vehicle's points land in one file.  Fans out over
                         ``concurrency`` processes on hash-partitioned key
                         lists (split(), simple_reporter.py:70-79).
Phase 2  make_matches -- per shard file: group by uuid, sort by time, split
                         traces at inactivity gaps (>120 s default,
                         simple_reporter.py:149-163), then match ALL windows
                         of the file in pooled [B, T] device micro-batches,
                         run report(), keep usable segments, and fan them
                         across quantised time buckets into tile files
                         (simple_reporter.py:176-196).  One process drives
                         the card; batching replaces process fan-out.
Phase 3  report_tiles -- sort each tile file, cull segment pairs seen fewer
                         than ``privacy`` times, upload CSV with header
                         (simple_reporter.py:211-254).

Resumable exactly like the reference: pass trace_dir to skip phase 1,
match_dir to skip phases 1+2 (simple_reporter.py:350-363).

Deviation (deliberate): the privacy cull groups correctly; the reference's
in-place range cull merges a trailing under-count group into a passing
predecessor (simple_reporter.py:220-239) -- a privacy leak not replicated.
"""

from __future__ import annotations

import calendar
import functools
import gzip
import hashlib
import json
import logging
import math
import multiprocessing
import os
import re
import tempfile
import time
import uuid as uuidlib
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from ..anonymise.storage import make_store
from ..utils import journal
from ..obs import flight as obs_flight
from ..obs import metrics as obs
from ..obs import trace as obs_trace
from ..anonymise.tiles import (
    CSV_HEADER,
    SegmentObservation,
    observations_for_report,
    privacy_cull,
    usable_report,
)
from ..native import parse_shard_bytes
from ..report.reporter import report as report_fn

log = logging.getLogger("reporter_tpu_torch.batch")

# per-phase counters.  Phases 1 and 3 fan out over spawn processes, each
# with its own default registry: workers dump a snapshot file on exit and
# the parent collects them into WORKER_SNAPSHOTS, which the batch head's
# --metrics flag merges (obs.metrics.merge) with the parent registry into
# ONE snapshot covering every process.
C_SRC_FILES = obs.counter(
    "reporter_batch_source_files_total",
    "Archive source files processed in phase 1", ("status",))
C_GATHERED = obs.counter(
    "reporter_batch_points_gathered_total",
    "Probe points written to uuid-hash shards (post bbox filter)")
C_ROWS_SKIPPED = obs.counter(
    "reporter_batch_rows_skipped_total",
    "Malformed shard rows skipped by the phase-2 parser")
C_WINDOWS = obs.counter(
    "reporter_batch_windows_matched_total",
    "Trace windows matched and reported in phase 2")
C_REPORT_FAIL = obs.counter(
    "reporter_batch_report_failures_total",
    "Trace windows whose match or report failed in phase 2")
C_TILES_UP = obs.counter(
    "reporter_batch_tiles_uploaded_total",
    "Phase-3 tile uploads", ("status",))
C_CULLED = obs.counter(
    "reporter_batch_segments_culled_total",
    "Tile rows dropped by the phase-3 privacy cull (incl. malformed rows)")
C_REQUEUED = obs.counter(
    "reporter_batch_shard_requeues_total",
    "Work units (phase-1 source files / phase-3 tile files) a dead fan-out "
    "worker left unfinished, requeued once onto the surviving parent "
    "(docs/robustness.md)",
    ("phase",))

# snapshots collected from fan-out workers this process spawned (appended
# by get_traces/report_tiles; merged by the batch head's --metrics dump)
WORKER_SNAPSHOTS: List[dict] = []


def _dump_registry(snap_path: Optional[str]) -> None:
    """Worker-side: persist this process's registry for the parent."""
    if not snap_path:
        return
    try:
        with open(snap_path, "w") as f:
            json.dump(obs.REGISTRY.snapshot(), f, separators=(",", ":"))
    except Exception:  # noqa: BLE001 - metrics must never fail the phase
        log.exception("could not write metrics snapshot %s", snap_path)


def _collect_worker_snaps(snap_dir: str) -> None:
    """Parent-side: read every worker snapshot written under snap_dir."""
    import shutil

    for name in sorted(os.listdir(snap_dir)):
        try:
            with open(os.path.join(snap_dir, name)) as f:
                WORKER_SNAPSHOTS.append(json.load(f))
        except Exception:  # noqa: BLE001 - a dead worker may have written none
            log.warning("unreadable worker metrics snapshot %s", name)
    shutil.rmtree(snap_dir, ignore_errors=True)


# per-unit done-file journaling + fan-out helpers: the shared contract of
# utils/journal
_mark_done = journal.mark_done
_unfinished_units = journal.unfinished_units
split = journal.split

DEFAULT_VALUER = (
    'lambda l: (lambda c: (c[1], c[0], c[9], c[10], c[5]))(l.split("|"))'
)


def compile_valuer(source: Optional[str]) -> Callable:
    """The record-extraction lambda: line -> (uuid, time, lat, lon, accuracy)
    (simple_reporter.py:337,357 -- same power, eval of an expression only)."""
    fn = eval(source or DEFAULT_VALUER, {"functools": functools}, {})  # noqa: S307
    if not callable(fn):
        raise ValueError("valuer must be a lambda expression")
    return fn


# -- archives --------------------------------------------------------------


class LocalArchive:
    """A directory (or glob) of probe files, possibly gzipped."""

    def __init__(self, path: str):
        self.path = path

    def keys(self, prefix: str = "", key_regex: str = ".*") -> List[str]:
        pat = re.compile(key_regex)
        root = os.path.join(self.path, prefix) if prefix else self.path
        found = []
        for r, _dirs, files in os.walk(root):
            for f in files:
                full = os.path.join(r, f)
                rel = os.path.relpath(full, self.path)
                if pat.match(rel):
                    found.append(rel)
        return sorted(found)

    def open(self, key: str):
        full = os.path.join(self.path, key)
        if key.endswith(".gz"):
            return gzip.open(full, "rt")
        return open(full, "r")


class S3Archive:
    """boto3-gated S3 source (simple_reporter.py:256-276)."""

    def __init__(self, bucket: str):
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "boto3 is not installed; use a local archive directory instead"
            ) from e
        self.bucket = bucket
        self._client = boto3.session.Session().client("s3")

    def keys(self, prefix: str = "", key_regex: str = ".*") -> List[str]:
        pat = re.compile(key_regex)
        keys: List[str] = []
        token = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": prefix}
            if token:
                kw["ContinuationToken"] = token
            objects = self._client.list_objects_v2(**kw)
            keys.extend(o["Key"] for o in objects.get("Contents", []))
            token = objects.get("NextContinuationToken")
            if not token:
                break
        return [k for k in keys if pat.match(k)]

    def open(self, key: str):
        import io

        body = self._client.get_object(Bucket=self.bucket, Key=key)["Body"].read()
        if key.endswith(".gz"):
            return io.TextIOWrapper(gzip.GzipFile(fileobj=io.BytesIO(body)))
        return io.TextIOWrapper(io.BytesIO(body))


def make_archive(spec: str):
    if spec.startswith("s3://"):
        return S3Archive(spec[5:].strip("/"))
    return LocalArchive(spec)


# -- phase 1: gather -------------------------------------------------------


def _gather(archive_spec, keys, valuer_src, time_pattern, bbox, dest_dir,
            snap_path=None, done_path=None):
    archive = make_archive(archive_spec)
    valuer = compile_valuer(valuer_src)
    try:
        for key in keys:
            try:
                shards = {}
                with archive.open(key) as f:
                    for line in f:
                        uuid, tm, lat, lon, acc = valuer(line.rstrip("\n"))
                        lat = float(lat)
                        lon = float(lon)
                        # bbox is [min_lat, min_lon, max_lat, max_lon]
                        if lat < bbox[0] or lat > bbox[2] or lon < bbox[1] or lon > bbox[3]:
                            continue
                        if time_pattern:
                            tm = calendar.timegm(time.strptime(str(tm), time_pattern))
                        else:
                            tm = int(tm)
                        acc = min(int(math.ceil(float(acc))), 1000)
                        shard = hashlib.sha1(str(uuid).encode()).hexdigest()[:3]
                        shards.setdefault(shard, []).append(
                            "%s,%d,%s,%s,%d\n" % (uuid, tm, lat, lon, acc)
                        )
                for shard, rows in shards.items():
                    with open(os.path.join(dest_dir, shard), "a") as sf:
                        sf.write("".join(rows))
                    C_GATHERED.inc(len(rows))
                C_SRC_FILES.labels("ok").inc()
                log.info("gathered traces from %s", key)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                C_SRC_FILES.labels("error").inc()
                log.error("%s was not processed: %s", key, e)
            # journalled AFTER the shard appends land: a crash mid-key
            # replays the whole key (at-least-once), never skips it
            _mark_done(done_path, key)
    finally:
        _dump_registry(snap_path)


def get_traces(
    archive_spec: str,
    prefix: str = "",
    key_regex: str = ".*",
    valuer: Optional[str] = None,
    time_pattern: Optional[str] = "%Y-%m-%d %H:%M:%S",
    bbox: Sequence[float] = (-90.0, -180.0, 90.0, 180.0),
    concurrency: int = 1,
    dest_dir: Optional[str] = None,
) -> str:
    """Phase 1: archive -> uuid-hash shard files.  Returns the shard dir."""
    archive = make_archive(archive_spec)
    keys = archive.keys(prefix, key_regex)
    if dest_dir is None:
        dest_dir = tempfile.mkdtemp(prefix="traces_")
    os.makedirs(dest_dir, exist_ok=True)
    log.info("gathering %d source files into %s", len(keys), dest_dir)
    if concurrency <= 1 or len(keys) <= 1:
        _gather(archive_spec, keys, valuer, time_pattern, list(bbox), dest_dir)
    else:
        # spawn, not fork: the parent process usually holds a CUDA context
        # (the matcher's tables live on the card), and a CUDA context does
        # not survive fork; forking a multithreaded process can deadlock too
        import shutil

        ctx = multiprocessing.get_context("spawn")
        snap_dir = tempfile.mkdtemp(prefix="obs_gather_")
        done_dir = tempfile.mkdtemp(prefix="gather_done_")
        procs = []
        chunks = split(keys, concurrency)
        for i, chunk in enumerate(chunks):
            p = ctx.Process(
                target=_gather,
                args=(archive_spec, chunk, valuer, time_pattern, list(bbox),
                      dest_dir, os.path.join(snap_dir, "w%d.json" % i),
                      os.path.join(done_dir, "w%d.done" % i)),
            )
            p.start()
            procs.append(p)
        dead = _join_checked(procs)
        _collect_worker_snaps(snap_dir)
        if dead:
            # a crashed worker must not fail the whole phase: requeue its
            # unfinished source files ONCE onto the surviving parent (the
            # done-journal scopes the re-run to what never processed; a
            # second failure here does fail the phase)
            remaining = _unfinished_units(chunks, procs, done_dir)
            shutil.rmtree(done_dir, ignore_errors=True)
            C_REQUEUED.labels("gather").inc(len(remaining))
            log.warning(
                "%d gather worker(s) died; requeueing %d unfinished source "
                "file(s) in the parent", dead, len(remaining))
            _gather(archive_spec, remaining, valuer, time_pattern,
                    list(bbox), dest_dir)
        else:
            shutil.rmtree(done_dir, ignore_errors=True)
    log.info("done gathering traces")
    return dest_dir


# -- phase 2: match --------------------------------------------------------


def _iter_shard_chunks(file_name: str, chunk_bytes: int = 1 << 26):
    """Yield (uuids, time, lat, lon, acc, line_count) per newline-aligned
    chunk of the shard file."""
    with open(file_name, "rb") as f:
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry.strip():
                    parsed = parse_shard_bytes(carry)
                    yield (*parsed, carry.count(b"\n") + (0 if carry.endswith(b"\n") else 1))
                return
            data = carry + block
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            chunk, carry = data[: cut + 1], data[cut + 1 :]
            parsed = parse_shard_bytes(chunk)
            yield (*parsed, chunk.count(b"\n"))


def _windows(points: List[dict], inactivity: float) -> Iterable[List[dict]]:
    """Split a sorted point list at inactivity gaps; drop <2-point windows
    (simple_reporter.py:149-163)."""
    starts = [
        i
        for i, p in enumerate(points)
        if i == 0 or p["time"] - points[i - 1]["time"] > inactivity
    ]
    for idx, i in enumerate(starts):
        j = starts[idx + 1] if idx + 1 < len(starts) else len(points)
        if j - i >= 2:
            yield points[i:j]


def make_matches(
    trace_dir: str,
    matcher,
    mode: str = "auto",
    report_levels=frozenset((0, 1)),
    transition_levels=frozenset((0, 1)),
    quantisation: int = 3600,
    inactivity: float = 120.0,
    source: str = "smpl_rprt",
    threshold_sec: int = 15,
    dest_dir: Optional[str] = None,
    microbatch: int = 256,
) -> str:
    """Phase 2: shard files -> tile files of observation rows.

    All windows of a shard file are matched in pooled device micro-batches
    (up to ``microbatch`` traces per match_many call)."""
    if dest_dir is None:
        dest_dir = tempfile.mkdtemp(prefix="matches_")
    os.makedirs(dest_dir, exist_ok=True)
    file_names = sorted(
        os.path.join(r, f) for r, _d, fs in os.walk(trace_dir) for f in fs
    )
    log.info("matching traces from %d files into %s", len(file_names), dest_dir)
    report_levels = set(report_levels)
    transition_levels = set(transition_levels)

    for file_name in file_names:
        # the native parser skips torn rows (concurrent phase-1 appends can
        # tear a line mid-write); so does its Python fallback.  Shards are
        # read in bounded chunks so a multi-GB archive doesn't spike memory.
        traces: dict = {}
        skipped = 0
        for uuids, tms, lats, lons, accs, chunk_lines in _iter_shard_chunks(file_name):
            skipped += chunk_lines - len(uuids)
            for i in range(len(uuids)):
                traces.setdefault(uuids[i], []).append(
                    {
                        "lat": float(lats[i]),
                        "lon": float(lons[i]),
                        "time": int(tms[i]),
                        "accuracy": int(accs[i]),
                    }
                )
        if skipped:
            C_ROWS_SKIPPED.inc(skipped)
            log.warning("skipped %d malformed row(s) in %s", skipped, file_name)

        # build every match request up front; competing phase-1 appends are
        # repaired by the sort (simple_reporter.py:145-146)
        requests = []
        for uuid, points in traces.items():
            points.sort(key=lambda v: v["time"])
            for window in _windows(points, inactivity):
                requests.append(
                    {"uuid": uuid, "trace": window, "match_options": {"mode": mode}}
                )

        tiles: dict = {}
        matched = 0
        for lo in range(0, len(requests), microbatch):
            chunk = requests[lo : lo + microbatch]
            # one trace per device micro-batch: the span binds the context
            # (so matcher compile events carry its id), lands in the flight
            # recorder, and failed chunks are always retained for
            # post-mortem -- the batch-path equivalent of a served request
            span = obs_trace.Span("batch_microbatch")
            span.meta["file"] = os.path.basename(file_name)
            span.meta["n_traces"] = len(chunk)
            try:
                with obs_trace.bind(span):
                    t0 = time.monotonic()
                    matches = matcher.match_many(chunk)
                    span.mark("match_s", time.monotonic() - t0)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                C_REPORT_FAIL.inc(len(chunk))
                span.fail(e)
                obs_flight.record(span)
                log.error("match micro-batch failed in %s: %s", file_name, e)
                continue
            t0 = time.monotonic()
            n_fail = 0
            for request, match in zip(chunk, matches):
                try:
                    rep = report_fn(
                        match, request, threshold_sec, report_levels, transition_levels, mode
                    )
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception:
                    C_REPORT_FAIL.inc()
                    n_fail += 1
                    log.error(
                        "failed to report trace with uuid %s from file %s",
                        request["uuid"], file_name,
                    )
                    continue
                matched += 1
                C_WINDOWS.inc()
                _bucket_reports(
                    rep, request, quantisation, source, mode, tiles, file_name
                )
            span.mark("report_fn_s", time.monotonic() - t0)
            if n_fail:
                span.fail("%d/%d windows failed report()" % (n_fail, len(chunk)),
                          status="partial")
            obs_flight.record(span)

        for tile_file, rows in tiles.items():
            path = os.path.join(dest_dir, tile_file)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as f:
                f.write("".join(rows))
        log.info("finished matching %d windows in %s", matched, file_name)
    log.info("done matching trace data files")
    return dest_dir


def _bucket_reports(rep, request, quantisation, source, mode, tiles, file_name):
    """Fan one report()'s usable segments across quantised time buckets
    (simple_reporter.py:176-196), via the shared tiling helpers so the batch
    and streaming paths can't drift."""
    points = request["trace"]
    max_buckets = (points[-1]["time"] - points[0]["time"]) // quantisation + 1
    for r in rep["datastore"]["reports"]:
        if not usable_report(r):
            continue
        emitted = False
        for tile, obs in observations_for_report(
            r, quantisation, source, vehicle_type=mode.upper(), max_buckets=max_buckets
        ):
            tiles.setdefault(tile.path(quantisation), []).append(obs.csv_row() + "\n")
            emitted = True
        if not emitted:
            log.error(
                "segment spans more than %d buckets for uuid %s in %s",
                max_buckets, request["uuid"], file_name,
            )


# -- phase 3: anonymise + upload ------------------------------------------


def _cull_lines(lines: List[str], privacy: int) -> List[str]:
    """Drop (segment_id, next_id) groups under the privacy count, via the
    shared privacy_cull (grouping is exact; see module docstring re the
    reference's trailing-group leak).  Unparseable rows are dropped."""
    observations = []
    for line in lines:
        try:
            observations.append(SegmentObservation.from_csv_row(line))
        except Exception:
            log.warning("dropping malformed tile row %r", line[:80])
    kept = privacy_cull(observations, privacy)
    return [o.csv_row() + "\n" for o in kept]


def _report_files(match_dir, file_names, store_spec, privacy, fail_counter=None,
                  snap_path=None, done_path=None):
    """Cull + upload a list of tile files.  Returns the number of failed
    uploads (also added to ``fail_counter`` when given, for fan-out)."""
    store = make_store(store_spec)
    failures = 0
    try:
        for file_name in file_names:
            with open(file_name) as f:
                lines = [l for l in f.readlines() if l.strip()]
            kept = _cull_lines(lines, privacy)
            C_CULLED.inc(len(lines) - len(kept))
            if not kept:
                log.info("no segments for %s after anonymising", file_name)
                _mark_done(done_path, file_name)
                continue
            rel = os.path.relpath(file_name, match_dir)
            # a fresh suffix per run so overlapping backfills accumulate instead
            # of overwriting (the stream anonymiser names tiles the same way)
            key = rel.replace(os.sep, "/") + "/" + uuidlib.uuid4().hex
            log.info("writing %d segments to %s", len(kept), key)
            try:
                store.put(key, CSV_HEADER + "\n" + "".join(kept))
                C_TILES_UP.labels("ok").inc()
            except Exception as e:
                failures += 1
                C_TILES_UP.labels("error").inc()
                log.error("failed to upload %s: %s", key, e)
            # journalled after the upload attempt: a crash mid-put replays
            # the file (at-least-once; tile keys are uuid4-suffixed so a
            # replayed upload accumulates instead of clobbering)
            _mark_done(done_path, file_name)
        if fail_counter is not None and failures:
            with fail_counter.get_lock():
                fail_counter.value += failures
    finally:
        _dump_registry(snap_path)
    return failures


def report_tiles(
    match_dir: str,
    store_spec: str,
    privacy: int = 2,
    concurrency: int = 1,
) -> int:
    """Phase 3: cull + upload every tile file under match_dir.  Returns the
    number of failed uploads (0 == everything shipped)."""
    file_names = sorted(
        os.path.join(r, f) for r, _d, fs in os.walk(match_dir) for f in fs
    )
    log.info("reporting %d anonymised time tiles", len(file_names))
    if concurrency <= 1 or len(file_names) <= 1:
        failures = _report_files(match_dir, file_names, store_spec, privacy)
    else:
        import shutil

        ctx = multiprocessing.get_context("spawn")  # see get_traces: CUDA vs fork
        fail_counter = ctx.Value("i", 0)
        snap_dir = tempfile.mkdtemp(prefix="obs_report_")
        done_dir = tempfile.mkdtemp(prefix="report_done_")
        procs = []
        chunks = split(file_names, concurrency)
        for i, chunk in enumerate(chunks):
            p = ctx.Process(
                target=_report_files,
                args=(match_dir, chunk, store_spec, privacy, fail_counter,
                      os.path.join(snap_dir, "w%d.json" % i),
                      os.path.join(done_dir, "w%d.done" % i)),
            )
            p.start()
            procs.append(p)
        dead = _join_checked(procs)
        _collect_worker_snaps(snap_dir)
        failures = fail_counter.value
        if dead:
            # requeue a dead worker's unfinished tile files once in the
            # parent instead of counting the whole worker as failed; only
            # uploads that then fail (or a second crash) count
            remaining = _unfinished_units(chunks, procs, done_dir)
            C_REQUEUED.labels("report").inc(len(remaining))
            log.warning(
                "%d report worker(s) died; requeueing %d unfinished tile "
                "file(s) in the parent", dead, len(remaining))
            failures += _report_files(match_dir, remaining, store_spec, privacy)
        shutil.rmtree(done_dir, ignore_errors=True)
    log.info("done reporting tiles (%d upload failures)", failures)
    return failures


_join_checked = journal.join_checked


# -- all three phases ------------------------------------------------------


def run_pipeline(
    matcher,
    archive_spec: Optional[str] = None,
    dest_store: Optional[str] = None,
    trace_dir: Optional[str] = None,
    match_dir: Optional[str] = None,
    cleanup: bool = True,
    **kw,
) -> Tuple[Optional[str], Optional[str]]:
    """All three phases with the reference's resume semantics."""
    phase1 = {
        k: kw[k]
        for k in ("prefix", "key_regex", "valuer", "time_pattern", "bbox", "concurrency")
        if k in kw
    }
    phase2 = {
        k: kw[k]
        for k in (
            "mode", "report_levels", "transition_levels", "quantisation",
            "inactivity", "source", "threshold_sec", "microbatch",
        )
        if k in kw
    }
    made_traces = made_matches = False
    if not trace_dir and not match_dir:
        if not archive_spec:
            raise ValueError("need an archive (or trace_dir/match_dir to resume)")
        trace_dir = get_traces(archive_spec, **phase1)
        made_traces = True
    if not match_dir:
        match_dir = make_matches(trace_dir, matcher, **phase2)
        made_matches = True
    failures = 0
    uploaded = False
    if dest_store:
        failures = report_tiles(
            match_dir, dest_store,
            privacy=kw.get("privacy", 2),
            concurrency=kw.get("concurrency", 1),
        )
        uploaded = failures == 0
    if cleanup:
        import shutil

        # never destroy output that hasn't shipped: the match dir survives
        # when there was no destination or any upload failed, so the run can
        # resume with --match-dir
        if made_traces and trace_dir and made_matches:
            shutil.rmtree(trace_dir, ignore_errors=True)
            trace_dir = None
        if made_matches and match_dir and uploaded:
            shutil.rmtree(match_dir, ignore_errors=True)
            match_dir = None
        if match_dir:
            log.warning(
                "keeping match dir %s (%s); resume phase 3 with --match-dir",
                match_dir,
                "no destination given" if not dest_store else "%d upload failures" % failures,
            )
    return trace_dir, match_dir
