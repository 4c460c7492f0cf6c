"""OSMLR segment-id bit layout (the part of the reference's module the
port uses: packing an id).

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


def pack_segment_id(level: int, tile_index: int, segment_index: int) -> int:
    if not 0 <= level <= LEVEL_MASK:
        raise ValueError("level out of range: %r" % (level,))
    if not 0 <= tile_index <= TILE_INDEX_MASK:
        raise ValueError("tile index out of range: %r" % (tile_index,))
    if not 0 <= segment_index <= SEGMENT_INDEX_MASK:
        raise ValueError("segment index out of range: %r" % (segment_index,))
    return (segment_index << (TILE_INDEX_BITS + LEVEL_BITS)) | (tile_index << LEVEL_BITS) | level
