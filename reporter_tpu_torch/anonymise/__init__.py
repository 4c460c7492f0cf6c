"""Time-quantised tiles, the privacy cull and the tile stores (the port's
copy of the JAX package's package of the same name)."""

from .tiles import SegmentObservation, TimeQuantisedTile, observations_for_report, privacy_cull, CSV_HEADER
from .storage import DirStore, HttpStore, S3Store, make_store

__all__ = [
    "SegmentObservation",
    "TimeQuantisedTile",
    "observations_for_report",
    "privacy_cull",
    "CSV_HEADER",
    "DirStore",
    "HttpStore",
    "S3Store",
    "make_store",
]
