"""GPS probe point value type with fixed 20-byte binary serde.

Mirrors the reference's Point (Point.java:15-18): lat/lon as float32,
accuracy in integer meters, time in epoch seconds.  The wire layout is the
same 20-byte big-endian record (float, float, int32, int64 --
Point.java:50-58) so recorded streams are interchangeable.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

_FMT = ">ffiq"
SIZE = struct.calcsize(_FMT)  # 20
assert SIZE == 20


def fmt_float(v: float) -> str:
    """Up to 6 decimals, no trailing zeros (DecimalFormat "###.######")."""
    s = "%.6f" % float(v)
    s = s.rstrip("0").rstrip(".")
    if s in ("-0", ""):
        return "0"
    return s


@dataclass
class Point:
    lat: float
    lon: float
    accuracy: int
    time: int  # epoch seconds

    def pack(self) -> bytes:
        return struct.pack(_FMT, self.lat, self.lon, self.accuracy, self.time)

    @classmethod
    def unpack(cls, data: bytes, offset: int = 0) -> "Point":
        lat, lon, acc, t = struct.unpack_from(_FMT, data, offset)
        return cls(lat, lon, acc, t)

    def to_json(self) -> str:
        """The trace-point JSON the matcher consumes (Point.java:59-65)."""
        return '{"lat":%s,"lon":%s,"time":%d,"accuracy":%d}' % (
            fmt_float(self.lat),
            fmt_float(self.lon),
            self.time,
            self.accuracy,
        )

    def to_dict(self) -> dict:
        return {
            "lat": float(self.lat),
            "lon": float(self.lon),
            "time": int(self.time),
            "accuracy": int(self.accuracy),
        }
