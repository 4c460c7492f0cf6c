"""Geodesy: the local equirectangular projection every device array uses.

A copy of the part of the reference's ``geo`` module this path needs:
``LocalProjection``, the projection behind ``GraphArrays.proj.to_xy``.  Points project to metres around a fixed origin in
float64 and are cast to float32 for the device, exactly as the reference
does, so both packages see the same float32 coordinates.
"""

from __future__ import annotations

import math

import numpy as np

EARTH_RADIUS_M = 6371000.0
DEG = math.pi / 180.0


class LocalProjection:
    """Equirectangular projection to metres around a fixed origin.

    x = R * (lon - lon0) * cos(lat0), y = R * (lat - lat0).  Longitude
    deltas are wrapped to (-180, 180] so regions straddling the
    antimeridian project contiguously.
    """

    def __init__(self, lat0: float, lon0: float):
        self.lat0 = float(lat0)
        self.lon0 = (float(lon0) + 180.0) % 360.0 - 180.0
        self.coslat0 = math.cos(lat0 * DEG)

    @classmethod
    def for_bbox(cls, min_lat, min_lon, max_lat, max_lon) -> "LocalProjection":
        if min_lon > max_lon:  # the bbox straddles the antimeridian
            max_lon += 360.0
        return cls(0.5 * (min_lat + max_lat), 0.5 * (min_lon + max_lon))

    def to_xy(self, lat, lon):
        lat = np.asarray(lat, dtype=np.float64)
        lon = np.asarray(lon, dtype=np.float64)
        dlon = np.mod(lon - self.lon0 + 180.0, 360.0) - 180.0
        x = EARTH_RADIUS_M * dlon * DEG * self.coslat0
        y = EARTH_RADIUS_M * (lat - self.lat0) * DEG
        return x, y

    def to_latlon(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        lon = x / (EARTH_RADIUS_M * DEG * self.coslat0) + self.lon0
        lat = y / (EARTH_RADIUS_M * DEG) + self.lat0
        return lat, lon
