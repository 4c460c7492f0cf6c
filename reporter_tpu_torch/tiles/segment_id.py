"""OSMLR segment-id bit layout.

A segment id is a 64-bit integer packing (low to high):
    level          : 3 bits   (0 = highway, 1 = arterial, 2 = local)
    tile index     : 22 bits  (row-major index within the level's world grid)
    segment index  : 21 bits  (index within the tile)
"""

from __future__ import annotations

LEVEL_BITS = 3
TILE_INDEX_BITS = 22
SEGMENT_INDEX_BITS = 21

LEVEL_MASK = (1 << LEVEL_BITS) - 1
TILE_INDEX_MASK = (1 << TILE_INDEX_BITS) - 1
SEGMENT_INDEX_MASK = (1 << SEGMENT_INDEX_BITS) - 1

# All-ones across the 46 used bits; identical to the reference's
# INVALID_SEGMENT_ID (simple_reporter.py:43) and Segment.java:16's
# INVALID_SEGMENT_ID = 0x3fffffffffffL.
INVALID_SEGMENT_ID = (
    (SEGMENT_INDEX_MASK << (TILE_INDEX_BITS + LEVEL_BITS))
    | (TILE_INDEX_MASK << LEVEL_BITS)
    | LEVEL_MASK
)


def pack_segment_id(level: int, tile_index: int, segment_index: int) -> int:
    if not 0 <= level <= LEVEL_MASK:
        raise ValueError("level out of range: %r" % (level,))
    if not 0 <= tile_index <= TILE_INDEX_MASK:
        raise ValueError("tile index out of range: %r" % (tile_index,))
    if not 0 <= segment_index <= SEGMENT_INDEX_MASK:
        raise ValueError("segment index out of range: %r" % (segment_index,))
    return (segment_index << (TILE_INDEX_BITS + LEVEL_BITS)) | (tile_index << LEVEL_BITS) | level


def unpack_segment_id(segment_id: int):
    return (
        segment_id & LEVEL_MASK,
        (segment_id >> LEVEL_BITS) & TILE_INDEX_MASK,
        (segment_id >> (TILE_INDEX_BITS + LEVEL_BITS)) & SEGMENT_INDEX_MASK,
    )


def get_tile_level(segment_id: int) -> int:
    return segment_id & LEVEL_MASK


def get_tile_index(segment_id: int) -> int:
    return (segment_id >> LEVEL_BITS) & TILE_INDEX_MASK


def get_segment_index(segment_id: int) -> int:
    return (segment_id >> (TILE_INDEX_BITS + LEVEL_BITS)) & SEGMENT_INDEX_MASK


def get_tile_id(segment_id: int) -> int:
    """Low 25 bits: level + tile index together (Segment.java:34-36)."""
    return segment_id & ((1 << (LEVEL_BITS + TILE_INDEX_BITS)) - 1)
