"""Per-vehicle rolling point batch.

Mirrors the reference's Batch (Batch.java): a list of points plus the
maximum equirectangular separation from the first point (the "did this
vehicle actually move" gate, Batch.java:35-41) and the stream time it was
last touched.  After a successful match, the response's ``shape_used`` tells
how many leading points the matcher consumed; those are trimmed and the
separation recomputed over the surviving tail (Batch.java:73-80) -- the
incremental-matching contract for unbounded streams.

Unlike the reference, building the request and applying the response are
separate steps so that a pool of ready batches can be flushed to the device
in one micro-batch call.
"""

from __future__ import annotations

import struct
from typing import List, Optional

from ..geo import equirectangular_m as _equirect
from .point import Point, SIZE as POINT_SIZE

_HDR = ">ifq"
_HDR_SIZE = struct.calcsize(_HDR)


def equirectangular_m(a: Point, b: Point) -> float:
    """Spread between two probe points (geo.py carries the parity-critical
    constant from Batch.java:35-41)."""
    return float(_equirect(a.lat, a.lon, b.lat, b.lon))


class Batch:
    __slots__ = ("points", "max_separation", "last_update")

    def __init__(self, point: Optional[Point] = None):
        self.points: List[Point] = [point] if point is not None else []
        self.max_separation = 0.0
        self.last_update = 0

    def update(self, p: Point) -> None:
        if self.points:
            self.max_separation = max(
                self.max_separation, equirectangular_m(p, self.points[0])
            )
        self.points.append(p)

    def meets(self, min_dist: float, min_size: int, min_elapsed: float) -> bool:
        """The report-worthiness gate (Batch.java:51-53)."""
        return not (
            self.max_separation < min_dist
            or len(self.points) < min_size
            or self.points[-1].time - self.points[0].time < min_elapsed
        )

    def request(
        self,
        uuid: str,
        mode: str = "auto",
        report_levels=(0, 1),
        transition_levels=(0, 1),
    ) -> dict:
        """The /report request body (Batch.java:56-66)."""
        return {
            "uuid": uuid,
            "match_options": {
                "mode": mode,
                "report_levels": list(report_levels),
                "transition_levels": list(transition_levels),
            },
            "trace": [p.to_dict() for p in self.points],
        }

    def apply_response(self, response: Optional[dict]) -> None:
        """Trim consumed points per ``shape_used``; on an unusable response
        drop everything (Batch.java:73-87)."""
        if not isinstance(response, dict):
            self.max_separation = 0.0
            self.points.clear()
            return
        trim_to = response.get("shape_used")
        if trim_to is None:
            trim_to = len(self.points)
        del self.points[: int(trim_to)]
        self.max_separation = 0.0
        for p in self.points[1:]:
            self.max_separation = max(
                self.max_separation, equirectangular_m(p, self.points[0])
            )

    # -- binary serde (Batch.java:92-146: count, max_separation, last_update,
    #    then the packed points) ------------------------------------------

    def pack(self) -> bytes:
        out = [struct.pack(_HDR, len(self.points), self.max_separation, self.last_update)]
        out.extend(p.pack() for p in self.points)
        return b"".join(out)

    @classmethod
    def unpack(cls, data: bytes) -> "Batch":
        n, sep, last = struct.unpack_from(_HDR, data, 0)
        b = cls()
        b.max_separation = sep
        b.last_update = last
        b.points = [Point.unpack(data, _HDR_SIZE + i * POINT_SIZE) for i in range(n)]
        return b
