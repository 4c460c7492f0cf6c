"""World tile hierarchy: 3 levels of fixed-size lat/lon grids.

Level 2 ("local")    0.25 degree tiles
Level 1 ("arterial") 1    degree tiles
Level 0 ("highway")  4    degree tiles

A copy of the reference's ``tiles/hierarchy.py``: row/column math,
tile-file naming (digits grouped in threes as directories) and the
antimeridian-crossing bbox split of valhalla's tilehierarchy, as the
Open Traffic reporter's py/get_tiles.py:30-102,143-157 has them.  Segment
ids pack the level's tile index of an edge's start (tiles/osm.py,
tiles/network.py ``grid_city``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

WORLD_MIN_X = -180.0
WORLD_MIN_Y = -90.0
WORLD_MAX_X = 180.0
WORLD_MAX_Y = 90.0

LEVEL_SIZES = {0: 4.0, 1: 1.0, 2: 0.25}


@dataclass(frozen=True)
class BoundingBox:
    min_x: float  # lon
    min_y: float  # lat
    max_x: float
    max_y: float


class TileSet:
    """One level's world-spanning grid of square tiles."""

    def __init__(self, size: float, bbox: BoundingBox = BoundingBox(WORLD_MIN_X, WORLD_MIN_Y, WORLD_MAX_X, WORLD_MAX_Y)):
        self.bbox = bbox
        self.tilesize = float(size)
        self.ncolumns = int(math.ceil((bbox.max_x - bbox.min_x) / self.tilesize))
        self.nrows = int(math.ceil((bbox.max_y - bbox.min_y) / self.tilesize))
        self.max_tile_id = self.ncolumns * self.nrows - 1

    def row(self, y: float) -> int:
        if y < self.bbox.min_y or y > self.bbox.max_y:
            return -1
        if y == self.bbox.max_y:
            return self.nrows - 1
        return int((y - self.bbox.min_y) / self.tilesize)

    def col(self, x: float) -> int:
        if x < self.bbox.min_x or x > self.bbox.max_x:
            return -1
        if x == self.bbox.max_x:
            return self.ncolumns - 1
        c = (x - self.bbox.min_x) / self.tilesize
        return int(c) if c >= 0.0 else int(c - 1)

    def tile_id(self, lat: float, lon: float) -> int:
        r, c = self.row(lat), self.col(lon)
        if r < 0 or c < 0:
            return -1
        return r * self.ncolumns + c

    def tile_bbox(self, tile_id: int) -> BoundingBox:
        r, c = divmod(tile_id, self.ncolumns)
        min_x = self.bbox.min_x + c * self.tilesize
        min_y = self.bbox.min_y + r * self.tilesize
        return BoundingBox(min_x, min_y, min_x + self.tilesize, min_y + self.tilesize)

    def digits(self, number: int) -> int:
        d = 1 if number < 0 else 0
        while number:
            number //= 10
            d += 1
        return d

    def file_suffix(self, tile_id: int, level: int, suffix: str) -> str:
        """Directory-grouped file name, e.g. level 2, tile 415760, 'json'
        -> '2/000/415/760.json' (get_tiles.py:82-102)."""
        max_length = self.digits(self.max_tile_id)
        remainder = max_length % 3
        if remainder:
            max_length += 3 - remainder
        if level == 0:
            name = "{:,}".format(int(10 ** max_length) + tile_id).replace(",", "/")
            name = "0" + name[1:]
        else:
            name = "{:,}".format(level * int(10 ** max_length) + tile_id).replace(",", "/")
        return name + "." + suffix


class TileHierarchy:
    def __init__(self):
        self.levels: Dict[int, TileSet] = {lvl: TileSet(size) for lvl, size in LEVEL_SIZES.items()}

    def tile_id(self, level: int, lat: float, lon: float) -> int:
        return self.levels[level].tile_id(lat, lon)

    def tiles_in_bbox(self, min_lon: float, min_lat: float, max_lon: float, max_lat: float) -> Iterator[Tuple[int, int]]:
        """Yield (level, tile_id) for every tile intersecting the bbox, handling
        bboxes that cross the antimeridian (get_tiles.py:143-157)."""
        boxes: List[BoundingBox] = []
        if min_lon >= max_lon:
            min_lon -= 360.0
        world = WORLD_MAX_X - WORLD_MIN_X
        if min_lon < WORLD_MIN_X and max_lon > WORLD_MIN_X:
            boxes.append(BoundingBox(WORLD_MIN_X, min_lat, max_lon, max_lat))
            boxes.append(BoundingBox(min_lon + world, min_lat, WORLD_MAX_X, max_lat))
        elif min_lon < WORLD_MAX_X and max_lon > WORLD_MAX_X:
            boxes.append(BoundingBox(min_lon, min_lat, WORLD_MAX_X, max_lat))
            boxes.append(BoundingBox(WORLD_MIN_X, min_lat, max_lon - world, max_lat))
        else:
            boxes.append(BoundingBox(min_lon, min_lat, max_lon, max_lat))

        for box in boxes:
            # clamp to world bounds so out-of-range coords can't turn the -1
            # sentinel from row()/col() into a bogus tile index
            box = BoundingBox(
                max(box.min_x, WORLD_MIN_X),
                max(box.min_y, WORLD_MIN_Y),
                min(box.max_x, WORLD_MAX_X),
                min(box.max_y, WORLD_MAX_Y),
            )
            if box.min_x > box.max_x or box.min_y > box.max_y:
                continue
            for level, tiles in self.levels.items():
                min_col = tiles.col(box.min_x)
                for r in range(tiles.row(box.min_y), tiles.row(box.max_y) + 1):
                    for c in range(min_col, tiles.col(box.max_x) + 1):
                        yield level, r * tiles.ncolumns + c

    def tile_files_in_bbox(
        self, min_lon, min_lat, max_lon, max_lat, suffix: str, levels=None
    ) -> List[str]:
        return [
            self.levels[level].file_suffix(tile_id, level, suffix)
            for level, tile_id in self.tiles_in_bbox(min_lon, min_lat, max_lon, max_lat)
            if levels is None or level in levels
        ]
