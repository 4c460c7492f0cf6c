"""Time-quantised geographic tiles + privacy culling.

A datastore report (report()'s output rows) becomes one or more
*observations* in time-quantised tiles: the key is (time-bucket start,
tile id) where the tile id comes from the low 25 bits of the segment id and
the bucket is ``floor(t / quantisation)``.  A report spanning several buckets
lands in each (reference: TimeQuantisedTile.java:26-35;
simple_reporter.py:178-196).

Anonymisation: within one tile, observations are sorted and any
(segment_id, next_segment_id) group with fewer than ``privacy`` entries is
dropped before the tile ships (AnonymisingProcessor.java:155-175 ==
simple_reporter.py:220-239).

CSV layout (header simple_reporter.py:252; row order Segment.java:55-74):
segment_id,next_segment_id,duration,count,length,queue_length,
minimum_timestamp,maximum_timestamp,source,vehicle_type
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ..tiles.segment_id import INVALID_SEGMENT_ID, get_tile_id, get_tile_level, get_tile_index

CSV_HEADER = (
    "segment_id,next_segment_id,duration,count,length,queue_length,"
    "minimum_timestamp,maximum_timestamp,source,vehicle_type"
)


@dataclass(frozen=True, order=True)
class TimeQuantisedTile:
    time_start: int  # bucket start epoch seconds
    tile_id: int  # low 25 bits: level + tile index

    @property
    def level(self) -> int:
        return get_tile_level(self.tile_id)

    @property
    def tile_index(self) -> int:
        return get_tile_index(self.tile_id)

    def path(self, quantisation: int) -> str:
        """Relative tile path {start}_{end}/{level}/{tile_index}
        (simple_reporter.py:191; AnonymisingProcessor.java:184-188)."""
        return "%d_%d/%d/%d" % (
            self.time_start,
            self.time_start + quantisation - 1,
            self.level,
            self.tile_index,
        )


@dataclass
class SegmentObservation:
    segment_id: int
    next_segment_id: int  # INVALID_SEGMENT_ID when absent
    duration: int
    count: int
    length: float
    queue_length: float
    min_timestamp: int
    max_timestamp: int
    source: str
    vehicle_type: str

    def csv_row(self) -> str:
        return ",".join(
            str(v)
            for v in (
                self.segment_id,
                self.next_segment_id,
                self.duration,
                self.count,
                self.length,
                self.queue_length,
                self.min_timestamp,
                self.max_timestamp,
                self.source,
                self.vehicle_type,
            )
        )

    def sort_key(self) -> Tuple[int, int, int]:
        return (self.segment_id, self.next_segment_id, self.min_timestamp)

    @classmethod
    def from_csv_row(cls, row: str) -> "SegmentObservation":
        p = row.strip().split(",")
        return cls(
            segment_id=int(p[0]),
            next_segment_id=int(p[1]),
            duration=int(p[2]),
            count=int(p[3]),
            length=float(p[4]),
            queue_length=float(p[5]),
            min_timestamp=int(p[6]),
            max_timestamp=int(p[7]),
            source=p[8],
            vehicle_type=p[9],
        )


def usable_report(r: dict) -> bool:
    """The batch pipeline's filter for reports worth tiling
    (simple_reporter.py:177): positive times, >0.5 s duration, positive
    length, non-negative queue."""
    return (
        r.get("t0", 0) > 0
        and r.get("t1", 0) > 0
        and (r["t1"] - r["t0"]) > 0.5
        and r.get("length", 0) > 0
        and r.get("queue_length", -1) >= 0
    )


def observations_for_report(
    r: dict,
    quantisation: int,
    source: str,
    vehicle_type: str = "AUTO",
    max_buckets: Optional[int] = None,
) -> Iterable[Tuple[TimeQuantisedTile, SegmentObservation]]:
    """Expand one datastore report across its time buckets
    (simple_reporter.py:178-196).  max_buckets guards against reports whose
    span exceeds the window that produced them."""
    # Java Math.round semantics (half-up, floor(x + 0.5)) to stay on the
    # reference's wire for exact-half durations -- Python's banker's round
    # would write 26 where the reference writes 27 (test_parity_fixtures)
    duration = int(math.floor((r["t1"] - r["t0"]) + 0.5))
    start = int(math.floor(r["t0"]))
    end = int(math.ceil(r["t1"]))
    min_bucket = start // quantisation
    max_bucket = end // quantisation
    if max_buckets is not None and (max_bucket - min_bucket) > max_buckets:
        return
    obs = SegmentObservation(
        segment_id=r["id"],
        next_segment_id=r.get("next_id", INVALID_SEGMENT_ID),
        duration=duration,
        count=1,
        length=r["length"],
        queue_length=r["queue_length"],
        min_timestamp=start,
        max_timestamp=end,
        source=source,
        vehicle_type=vehicle_type,
    )
    tile_id = get_tile_id(r["id"])
    for b in range(min_bucket, max_bucket + 1):
        yield TimeQuantisedTile(b * quantisation, tile_id), obs


def privacy_cull(observations: List[SegmentObservation], privacy: int) -> List[SegmentObservation]:
    """Drop (segment_id, next_segment_id) groups observed fewer than
    ``privacy`` times.  Sorts first, like both reference implementations."""
    rows = sorted(observations, key=SegmentObservation.sort_key)
    out: List[SegmentObservation] = []
    i = 0
    while i < len(rows):
        j = i
        while j < len(rows) and (
            rows[j].segment_id == rows[i].segment_id
            and rows[j].next_segment_id == rows[i].next_segment_id
        ):
            j += 1
        if j - i >= privacy:
            out.extend(rows[i:j])
        i = j
    return out


def tile_csv(observations: List[SegmentObservation], with_header: bool = True) -> str:
    lines = [CSV_HEADER] if with_header else []
    lines.extend(o.csv_row() for o in observations)
    return "\n".join(lines) + "\n"
