"""Segment-pair histogram entry with fixed 40-byte binary serde.

Mirrors the reference's Segment (Segment.java): one observation of a vehicle
traversing segment ``id`` (optionally onto ``next_id``) during [min, max]
epoch seconds, with length/queue in meters.  The CSV row layout and the
40-byte big-endian wire layout (long, long, double, double, int32, int32 --
Segment.java:76-129) are preserved.

The list serde here is count-prefixed and actually round-trips; the
reference's ListSerder deserialises zero items (loop over an empty list's
size, Segment.java:164-168) -- a known bug not replicated.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

INVALID_SEGMENT_ID = 0x3FFFFFFFFFFF  # 46 bits (Segment.java:16)

_FMT = ">qqddii"
SIZE = struct.calcsize(_FMT)  # 40
assert SIZE == 40


@dataclass
class Segment:
    id: int
    next_id: Optional[int]  # stored as INVALID_SEGMENT_ID when absent
    min: float  # epoch seconds
    max: float
    length: int  # meters
    queue: int  # meters

    def __post_init__(self):
        if self.next_id is None:
            self.next_id = INVALID_SEGMENT_ID

    def tile_id(self) -> int:
        """3-bit level + 22-bit tile index (Segment.java:34-36)."""
        return self.id & 0x1FFFFFF

    def valid(self) -> bool:
        return self.min > 0 and self.max > 0 and self.max > self.min \
            and self.length > 0 and self.queue >= 0

    def sort_key(self):
        return (self.id, self.next_id)

    def csv_row(self, mode: str, source: str) -> str:
        """One histogram CSV row (Segment.java:59-74); next_id empty when
        invalid, duration rounded, min floored, max ceiled.  Duration uses
        Java's Math.round -- floor(x + 0.5), half-up -- NOT Python's
        banker's round: a 26.5 s duration is 27 on the reference's wire
        (the reference's golden-bytes fixtures pin it)."""
        import math

        next_s = "" if self.next_id == INVALID_SEGMENT_ID else str(self.next_id)
        return "%d,%s,%d,1,%d,%d,%d,%d,%s,%s" % (
            self.id,
            next_s,
            int(math.floor((self.max - self.min) + 0.5)),
            self.length,
            self.queue,
            int(math.floor(self.min)),
            int(math.ceil(self.max)),
            source,
            mode,
        )

    @staticmethod
    def column_layout() -> str:
        return (
            "segment_id,next_segment_id,duration,count,length,queue_length,"
            "minimum_timestamp,maximum_timestamp,source,vehicle_type"
        )

    def pack(self) -> bytes:
        return struct.pack(
            _FMT, self.id, self.next_id, self.min, self.max, self.length, self.queue
        )

    @classmethod
    def unpack(cls, data: bytes, offset: int = 0) -> "Segment":
        sid, nid, mn, mx, ln, q = struct.unpack_from(_FMT, data, offset)
        return cls(sid, nid, mn, mx, ln, q)


def pack_list(segments: List[Segment]) -> bytes:
    out = [struct.pack(">i", len(segments))]
    out.extend(s.pack() for s in segments)
    return b"".join(out)


def unpack_list(data: bytes) -> List[Segment]:
    (n,) = struct.unpack_from(">i", data, 0)
    return [Segment.unpack(data, 4 + i * SIZE) for i in range(n)]
