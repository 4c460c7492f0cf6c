"""Geodesy: the local equirectangular projection every device array uses,
and the host distances of the CPU baseline and the network model.

A copy of the host (numpy) part of the reference's ``geo`` module:
``LocalProjection``, the projection behind ``GraphArrays.proj.to_xy``.
Points project to metres around a fixed origin in float64 and are cast to
float32 for the device, exactly as the reference does, so both packages
see the same float32 coordinates.  ``haversine_m`` (edge lengths),
``equirectangular_m`` (the reference's Batch.java spread check) and the
point-to-segment distances the CPU baseline ranks candidates by
(``point_segment_distance_f32``, with ``jnp.hypot``'s expansion as
numpy computes it, unflushed, as in the reference).
"""

from __future__ import annotations

import math

import numpy as np

EARTH_RADIUS_M = 6371000.0
DEG = math.pi / 180.0


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle distance in metres.  Accepts scalars or numpy arrays."""
    lat1, lon1, lat2, lon2 = (np.asarray(a, dtype=np.float64) for a in (lat1, lon1, lat2, lon2))
    dlat = (lat2 - lat1) * DEG
    dlon = (lon2 - lon1) * DEG
    a = np.sin(dlat / 2.0) ** 2 + np.cos(lat1 * DEG) * np.cos(lat2 * DEG) * np.sin(dlon / 2.0) ** 2
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.minimum(a, 1.0)))


# metres per degree from half the WGS84 equatorial circumference, as the
# reference's Batch.java:35-36 derives it (not from EARTH_RADIUS_M)
METERS_PER_DEG = 20037581.187 / 180.0


def equirectangular_m(lat1, lon1, lat2, lon2):
    """Equirectangular approximation of Batch.java:34-41 (dx scaled by the
    cosine of the mean latitude)."""
    lat1, lon1, lat2, lon2 = (np.asarray(a, dtype=np.float64) for a in (lat1, lon1, lat2, lon2))
    x = (lon2 - lon1) * METERS_PER_DEG * np.cos(0.5 * (lat1 + lat2) * DEG)
    y = (lat2 - lat1) * METERS_PER_DEG
    return np.sqrt(x * x + y * y)


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


def point_segment_distance_np(px, py, ax, ay, bx, by):
    """Distance from point (px, py) to segment (a, b) and the clamped
    projection parameter t in [0, 1], in float64."""
    px, py, ax, ay, bx, by = (np.asarray(v, dtype=np.float64) for v in (px, py, ax, ay, bx, by))
    dx = bx - ax
    dy = by - ay
    seg_len2 = dx * dx + dy * dy
    t = np.where(seg_len2 > 0.0, ((px - ax) * dx + (py - ay) * dy)
                 / np.where(seg_len2 > 0.0, seg_len2, 1.0), 0.0)
    t = np.clip(t, 0.0, 1.0)
    cx = ax + t * dx
    cy = ay + t * dy
    return np.hypot(px - cx, py - cy), t


def point_segment_distance_f32(px, py, ax, ay, bx, by):
    """The candidate sweep's projection in float32, with the same
    operation order, so near ties (the forward and reverse shape segments
    of a two-way road, equidistant in float64) resolve as on the device."""
    f32 = np.float32
    px, py, ax, ay, bx, by = (np.asarray(v, dtype=f32) for v in (px, py, ax, ay, bx, by))
    dx = bx - ax
    dy = by - ay
    seg_len2 = dx * dx + dy * dy
    pos = seg_len2 > 0
    t = np.where(pos, ((px - ax) * dx + (py - ay) * dy) / np.where(pos, seg_len2, f32(1.0)), f32(0.0))
    t = np.clip(t, f32(0.0), f32(1.0)).astype(f32)
    cx = ax + t * dx
    cy = ay + t * dy
    return _hypot_f32_like_jax(px - cx, py - cy), t


def _hypot_f32_like_jax(u, v):
    """``jnp.hypot``'s float32 expansion m * sqrt(1 + (n/m)^2), not libm's
    hypotf (the two round differently in the last ulps).  Subnormal legs
    and results are kept, as the reference's helper keeps them."""
    f32 = np.float32
    a = np.abs(u)
    b = np.abs(v)
    m = np.maximum(a, b)
    n = np.minimum(a, b)
    safe = np.where(m == 0, f32(1.0), m)
    r = n / safe
    return np.where(m == 0, m, m * np.sqrt(f32(1.0) + r * r))
