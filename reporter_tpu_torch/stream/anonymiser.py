"""Streaming anonymiser: segment observations -> privacy-culled CSV tiles.

Behavioral port of AnonymisingProcessor.java.  Observations accumulate per
(time bucket, tile id) in bounded *slices* of at most ``SLICE_SIZE`` entries
-- the reference's workaround for Kafka's 1 MB message ceiling
(AnonymisingProcessor.java:32-45); the slice structure is kept so a Kafka
changelog transport can bound its message sizes the same way.  On each
flush interval every tile's slices are concatenated, sorted by (id,
next_id), groups observed fewer than ``privacy`` times are culled, and the
survivors ship as one CSV file named
``{bucket_start}_{bucket_end}/{level}/{tile_index}/{source}.{uuid4}``
(AnonymisingProcessor.java:177-220) to a dir / HTTP / S3 backend.

Deviation (deliberate): the reference's in-place range cull lets a trailing
under-count group survive when it follows a passing group
(AnonymisingProcessor.java:155-175 -- when the scan reaches the last element
it advances ``i`` past the end and the whole [start, i) range, which spans
*two* groups, is kept if its combined size passes).  That is a privacy leak;
this implementation culls every group independently.
"""

from __future__ import annotations

import logging
import uuid as uuidlib
from typing import Callable, Dict, List, Optional, Tuple

from ..anonymise.storage import make_store
from ..obs import metrics as obs
from .segment import Segment

log = logging.getLogger(__name__)

C_TILES = obs.counter(
    "reporter_stream_tiles_flushed_total",
    "Anonymised CSV tiles shipped to the store")
C_CULLED = obs.counter(
    "reporter_stream_segments_culled_total",
    "Segment observations dropped by the privacy cull")

SLICE_SIZE = 20000

TileKey = Tuple[int, int]  # (time_range_start, tile_id)


def quantised_tiles(segment: Segment, quantisation: int) -> List[TileKey]:
    """Every time bucket a segment's [min, max] touches
    (TimeQuantisedTile.java:26-35)."""
    lo = int(segment.min) // quantisation
    hi = int(segment.max) // quantisation
    return [(i * quantisation, segment.tile_id()) for i in range(lo, hi + 1)]


def cull(segments: List[Segment], privacy: int) -> List[Segment]:
    """Drop (id, next_id) groups with fewer than ``privacy`` observations.
    Input must be sorted by (id, next_id)."""
    out: List[Segment] = []
    i = 0
    while i < len(segments):
        j = i
        while j < len(segments) and segments[j].sort_key() == segments[i].sort_key():
            j += 1
        if j - i >= privacy:
            out.extend(segments[i:j])
        i = j
    return out


class AnonymisingProcessor:
    def __init__(
        self,
        privacy: int,
        quantisation: int,
        output: str,
        source: str,
        mode: str = "auto",
        flush_interval_sec: int = 300,
        store=None,
        slice_size: int = SLICE_SIZE,
    ):
        if privacy < 1:
            raise ValueError("need a privacy parameter of 1 or more")
        if quantisation < 60:
            raise ValueError("need quantisation parameter of 60 or more")
        self.privacy = privacy
        self.quantisation = quantisation
        self.mode = mode.upper()
        self.source = source
        self.flush_interval_ms = 1000 * flush_interval_sec
        self.store = store if store is not None else make_store(output)
        self.slice_size = slice_size
        # tile -> highest slice number; "{start}_{tile}.{slice}" -> segments
        self.map: Dict[TileKey, int] = {}
        self.slices: Dict[str, List[Segment]] = {}
        self.tiles_flushed = 0
        self._last_flush_ms: Optional[int] = None

    @staticmethod
    def _slice_name(tile: TileKey, idx: int) -> str:
        return "%d_%d.%d" % (tile[0], tile[1], idx)

    def process(self, key: str, segment: Segment) -> None:
        for tile in quantised_tiles(segment, self.quantisation):
            slice_idx = self.map.get(tile)
            if slice_idx is None:
                slice_idx = 0
                self.map[tile] = slice_idx
                log.info("starting quantised tile slice %s.0", tile)
            name = self._slice_name(tile, slice_idx)
            segs = self.slices.setdefault(name, [])
            segs.append(segment)
            if len(segs) >= self.slice_size:
                self.map[tile] = slice_idx + 1
                log.info("starting quantised tile slice %s.%d", tile, slice_idx + 1)

    def maybe_punctuate(self, timestamp_ms: int) -> None:
        if self._last_flush_ms is None:
            self._last_flush_ms = timestamp_ms
            return
        if timestamp_ms - self._last_flush_ms >= self.flush_interval_ms:
            self._last_flush_ms = timestamp_ms
            self.punctuate()

    def punctuate(self) -> None:
        """Flush every tile: concat slices, sort, cull, ship CSV."""
        tiles = list(self.map.items())
        self.map.clear()
        for tile, max_slice in tiles:
            segments: List[Segment] = []
            for i in range(max_slice + 1):
                sl = self.slices.pop(self._slice_name(tile, i), None)
                if sl is not None:
                    segments.extend(sl)
                elif i < max_slice:
                    # the top slice legitimately may not exist yet (rollover
                    # bumps the index before the first segment arrives)
                    log.warning("missing quantised tile slice %s.%d", tile, i)
            segments.sort(key=Segment.sort_key)
            kept = cull(segments, self.privacy)
            C_CULLED.inc(len(segments) - len(kept))
            log.info(
                "anonymised quantised tile %s from %d to %d segments",
                tile, len(segments), len(kept),
            )
            if kept:
                self._ship(tile, kept)
        # unreferenced slices would otherwise leak
        for name in list(self.slices):
            log.warning("deleting unreferenced quantised tile slice %s", name)
            del self.slices[name]

    def _ship(self, tile: TileKey, segments: List[Segment]) -> None:
        start, tile_id = tile
        tile_name = "%d_%d/%d/%d" % (
            start,
            start + self.quantisation - 1,
            tile_id & 0x7,
            (tile_id >> 3) & 0x3FFFFF,
        )
        file_name = "%s.%s" % (self.source, uuidlib.uuid4())
        body = Segment.column_layout() + "".join(
            "\n" + s.csv_row(self.mode, self.source) for s in segments
        )
        key = tile_name + "/" + file_name
        try:
            log.info("writing tile to %s with %d segments", key, len(segments))
            self.store.put(key, body)
            self.tiles_flushed += 1
            C_TILES.inc()
        except Exception as e:
            log.error("couldn't flush tile %s: %s", key, e)
