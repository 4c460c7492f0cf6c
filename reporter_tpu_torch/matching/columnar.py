"""Columnar host packing: trace dicts -> padded device batches, vectorized.

The legacy matcher fills the padded [B, T] arrays one trace at a time
(``SegmentMatcher._fill_rows`` with ``cols=None``): per row, list
comprehensions over the point dicts, a projection call and four slice
assignments.  This module is the JAX package's columnar plane, numpy
only:

  1. ``extract_columns`` walks the point dicts once per ``match_many``
     call (three flat per-column list comprehensions over the chained
     point lists) into flat float64 lat / lon / time columns and
     per-trace lengths.  A trace that carries a ``"_columns"`` side
     channel (the binary wire's decode, serve/wire.py) contributes its
     arrays as they are and costs no per-point Python.
  2. ``TraceColumns.pack`` scatters any index group into padded [B, T]
     arrays with one fancy-indexed assignment per column: ragged row
     starts by cumsum, flat source and destination indices by np.repeat,
     no per-trace work.  The projection runs once over every point
     (``LocalProjection.to_xy`` is elementwise, so one batched call is
     bit-identical to per-trace calls), and the time rebase is the legacy
     loop's float64 subtract before the float32 cast.

The output is bit-identical to the legacy loop, which
``REPORTER_HOST_PACK=0`` / ``MatcherConfig.host_pack=False`` keeps as the
differential reference.

``PackedTimes`` carries each row's epoch-second times to association as
flat arrays; it behaves like the legacy list of lists for every consumer,
and ``fill_abs`` gives ``_associate_and_store`` one scatter in place of
its per-row loop.
"""

from __future__ import annotations

import threading
from itertools import chain
from typing import List, Optional, Sequence

import numpy as np


class PackedTimes:
    """Per-row epoch-second times as flat columns.

    Behaves like the legacy list of lists (``len(times)``, ``times[row]``
    -> list of floats); ``fill_abs`` is the vectorized form
    ``_associate_and_store`` uses in place of its per-row loop.
    """

    __slots__ = ("flat", "lens", "offsets")

    def __init__(self, flat: np.ndarray, lens: np.ndarray,
                 offsets: np.ndarray):
        self.flat = flat          # float64 [sum(lens)]
        self.lens = lens          # int64 [B]
        self.offsets = offsets    # int64 [B] starts into flat

    def __len__(self) -> int:
        return len(self.lens)

    def __getitem__(self, row: int) -> List[float]:
        o, n = int(self.offsets[row]), int(self.lens[row])
        return self.flat[o:o + n].tolist()

    def fill_abs(self, abs_tm: np.ndarray, n_pts: np.ndarray) -> None:
        """Scatter the epoch times into abs_tm [B, T] float64 and the row
        counts into n_pts: the legacy ``abs_tm[row, :n] = times[row]``
        loop in one assignment."""
        B, T = abs_tm.shape
        lens = self.lens[:B]
        n_pts[:B] = lens
        if not lens.sum():
            return
        src, dst = _ragged_index(self.offsets[:B], lens, T)
        abs_tm.reshape(-1)[dst] = self.flat[src]


class TraceColumns:
    """Flat per-point columns over a whole trace batch and the vectorized
    group packer.  Built once per ``match_many`` call; ``pack`` serves
    every (bucket, long group, session step) group of that call."""

    __slots__ = ("lens", "offsets", "lat", "lon", "time", "_x", "_y")

    def __init__(self, lens: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                 time: np.ndarray):
        self.lens = lens
        self.offsets = np.zeros(len(lens), np.int64)
        if len(lens) > 1:
            np.cumsum(lens[:-1], out=self.offsets[1:])
        self.lat = lat
        self.lon = lon
        self.time = time
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None

    def ensure_xy(self, proj) -> None:
        """Project every point once (``to_xy`` is elementwise, so the
        batched call is bit-identical to per-trace calls)."""
        if self._x is None:
            self._x, self._y = proj.to_xy(self.lat, self.lon)

    def pack(self, proj, idxs: Sequence[int], T: int,
             t0: Optional[np.ndarray] = None):
        """Scatter traces[idxs] into padded [B, T] arrays.

        Returns (px, py, tm, valid, times) as the legacy ``_fill_rows``
        does: px / py / tm float32, valid bool, times a ``PackedTimes``.
        ``t0``: per-row float64 rebase epochs (the session path rebases on
        each session's own t0, not the window's first point).
        """
        self.ensure_xy(proj)
        idxs = np.asarray(idxs, np.int64)
        B = len(idxs)
        lens = self.lens[idxs]
        total = int(lens.sum())
        px = np.zeros((B, T), np.float32)
        py = np.zeros((B, T), np.float32)
        tm = np.zeros((B, T), np.float32)
        valid = np.zeros((B, T), bool)
        offs = self.offsets[idxs]
        starts = np.cumsum(lens) - lens
        if not total:
            return px, py, tm, valid, PackedTimes(np.zeros(0, np.float64), lens, starts)
        if t0 is None:
            # each trace's first point, as the legacy loop rebases; a
            # zero-length trace's offset may sit at the end of the flat
            # columns, so the gather is clamped (its t0 is never used)
            t0 = self.time[np.minimum(offs, len(self.time) - 1)]
        src, dst = _ragged_index(offs, lens, T)
        times = PackedTimes(self.time[src], lens, starts)
        # float64 -> float32 element casts, as the legacy slice assignments
        px.reshape(-1)[dst] = self._x[src]
        py.reshape(-1)[dst] = self._y[src]
        tm.reshape(-1)[dst] = self.time[src] - np.repeat(
            np.asarray(t0, np.float64), lens)
        valid.reshape(-1)[dst] = True
        return px, py, tm, valid, times


def _ragged_index(offs, lens, T: int):
    """(src, dst): the flat indices of rows of ``lens`` points that start
    at ``offs`` in the flat columns, and of the same points in a padded
    [len(lens), T] array, row after row."""
    starts = np.cumsum(lens) - lens
    within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(starts, lens)
    return (np.repeat(offs, lens) + within,
            np.repeat(np.arange(len(lens), dtype=np.int64) * T, lens) + within)


# traces extract_columns took from a "_columns" side channel and traces
# whose point dicts it walked (read by the smoke run and the tests)
COUNTS = {"side_channel": 0, "walked": 0}
_count_lock = threading.Lock()


def extract_columns(traces: Sequence[dict],
                    key: str = "trace") -> TraceColumns:
    """One pass over every point dict of ``traces`` -> TraceColumns.

    Three flat per-column list comprehensions over the chained point
    lists.  A trace carrying a ``"_columns"`` dict (float64 lat / lon /
    time arrays from the binary wire's decode, serve/wire.py) contributes
    those arrays by reference: no per-point Python for binary ingress.
    """
    n = len(traces)
    lens = np.zeros(n, np.int64)
    cols = [None] * n          # per-trace (lat, lon, time) arrays or None
    plain: List[int] = []      # traces whose point dicts are walked
    for i, tr in enumerate(traces):
        c = tr.get("_columns") if isinstance(tr, dict) else None
        if c is not None:
            lens[i] = len(c["lat"])
            cols[i] = (c["lat"], c["lon"], c["time"])
        else:
            lens[i] = len(tr[key])
            plain.append(i)
    with _count_lock:
        COUNTS["side_channel"] += n - len(plain)
        COUNTS["walked"] += len(plain)
    if len(plain) == n:        # the common all-JSON case: one flat walk
        flat = list(chain.from_iterable(tr[key] for tr in traces))
        lat = np.array([p["lat"] for p in flat], np.float64)
        lon = np.array([p["lon"] for p in flat], np.float64)
        time = np.array([float(p["time"]) for p in flat], np.float64)
        return TraceColumns(lens, lat, lon, time)
    for i in plain:
        pts = traces[i][key]
        cols[i] = (np.array([p["lat"] for p in pts], np.float64),
                   np.array([p["lon"] for p in pts], np.float64),
                   np.array([float(p["time"]) for p in pts], np.float64))
    parts = [c for c in cols if c is not None and len(c[0])]
    if parts:
        lat = np.concatenate([c[0] for c in parts])
        lon = np.concatenate([c[1] for c in parts])
        time = np.concatenate([np.asarray(c[2], np.float64) for c in parts])
    else:
        lat = lon = np.zeros(0, np.float64)
        time = np.zeros(0, np.float64)
    return TraceColumns(lens, lat, lon, np.asarray(time, np.float64))
