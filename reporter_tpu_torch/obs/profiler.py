"""On-demand ``torch.profiler`` capture (backs ``GET /debug/profile`` and
the attribution windows of ``obs/attrib.py``).

The capture is synchronous in the calling (handler) thread: the device
keeps serving from the other threads while the trace records.  One
capture at a time — the profiler is process-global, so a second
concurrent request (either endpoint, any kind) gets ``ProfilerBusy``
carrying the in-flight capture's trace_id (HTTP 409) instead of
corrupting the first.  A window records the host (CPU activity) and, when
CUDA is available, the card (CUDA activity through CUPTI, which sees the
hand-written kernels), on every thread, and is written as a Chrome trace
``reporter.trace.json`` into the capture directory.  Recording every
thread needs PyTorch's ``profile_all_threads``: without it a capture on
the card raises (the serving threads' launches would fall outside their
stage ranges), and on host cores it records the capturing thread alone,
with a warning.  torch is imported
lazily: the obs package stays importable without it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time

MAX_SECONDS = 60.0
MIN_SECONDS = 0.05
TRACE_NAME = "reporter.trace.json"

log = logging.getLogger(__name__)

_capture_lock = threading.Lock()
# metadata of the capture currently holding the lock (read without the
# lock on the 409 path: a fresh reader may see the previous capture's
# block for an instant, which is still an honest "busy with <id>")
_inflight: "dict | None" = None


def _all_threads(cuda: bool) -> dict:
    """The profile's keyword that records every thread's host events (the
    serving threads' stage ranges, not only the capturing thread's).
    Raises on the card where this PyTorch lacks it."""
    import torch

    try:
        return {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError) as e:
        if cuda:
            raise RuntimeError(
                "torch %s cannot profile all threads (%s): the batchers' "
                "launches would go unattributed" % (torch.__version__, e)) from e
        log.warning("torch %s cannot profile all threads: the capture "
                    "records the capturing thread only", torch.__version__)
        return {}


class ProfilerBusy(RuntimeError):
    """A capture is already in flight.  ``inflight`` describes it:
    {"kind", "trace_id", "started_unix", "seconds"} (seconds only for
    fixed-window /debug/profile captures)."""

    def __init__(self, msg: str, inflight: "dict | None" = None):
        super().__init__(msg)
        self.inflight = inflight


def inflight() -> "dict | None":
    return dict(_inflight) if _inflight else None


@contextlib.contextmanager
def session(kind: str, trace_id: "str | None" = None,
            out_dir: "str | None" = None, seconds: "float | None" = None):
    """Single-flight ``torch.profiler`` window: acquires the process-global
    capture lock (non-blocking; raises ProfilerBusy with the in-flight
    capture's metadata), profiles the host and, when CUDA is available,
    the card, yields the capture directory and writes the Chrome trace
    there on exit (after the card's queued work finished).  ``trace_id``
    defaults to the caller's bound span so a 409 can name the request that
    owns the capture."""
    global _inflight
    if trace_id is None:
        from . import trace as obs_trace

        trace_id = obs_trace.current_trace_id()
    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy(
            "a profiler capture is already running", inflight())
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        _inflight = {"kind": kind, "trace_id": trace_id,
                     "started_unix": round(time.time(), 3),
                     "seconds": seconds}
        d = out_dir or tempfile.mkdtemp(prefix="reporter_torch_trace_")
        os.makedirs(d, exist_ok=True)
        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts, **_all_threads(cuda)) as prof:
            try:
                yield d
            finally:
                if cuda:
                    torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(d, TRACE_NAME))
    finally:
        _inflight = None
        _capture_lock.release()


def capture(seconds: float, out_dir: str = None) -> "tuple[str, float]":
    """Record a profiler trace for ~``seconds`` (clamped to
    [MIN_SECONDS, MAX_SECONDS]).  Returns (trace_dir, seconds_recorded)."""
    seconds = min(max(float(seconds), MIN_SECONDS), MAX_SECONDS)
    with session("profile", out_dir=out_dir, seconds=seconds) as d:
        time.sleep(seconds)
    return d, seconds
