"""Dense, device-ready graph arrays.

A copy of the reference's ``GraphArrays`` and ``build_graph_arrays``: flat
float32/int32 arrays built from a RoadNetwork.  The two device layouts are
byte-for-byte the reference's:

  - ``cell_rows`` [n_cells, 8*cap] f32, cell-major, plane-major within a
    cell: ax, ay, bx, by, off, len, edge-value, pad runs of ``cap`` values
    (empty slots carry edge -1.0).  A point's candidate sweep reads four
    whole rows (its 2x2 quadrant cells).
  - ``edge_rows`` [E, 8] f32: to-node bits, from-node bits (int32 bit-cast
    into the float lanes), len, speed, head0, head1, pad, pad.

``DeviceGraph`` is the small set of torch tensors and scalars the kernels
read; ``to_device`` moves it to the card.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import geo
from ..device import resolve_device
from .network import RoadNetwork

log = logging.getLogger(__name__)


class DeviceGraph:
    """What the device kernels read of the graph.  The grid scalars are
    float32 values (Python floats already rounded through float32), so the
    kernels and the plain versions see the same numbers the reference's
    float32 device scalars hold.  ``edge_seg`` ([E] int32 dense segment
    index, -1 unassociated) is what the segment histogram reads."""

    def __init__(self, edge_rows: torch.Tensor, cell_rows: torch.Tensor,
                 grid_x0: float, grid_y0: float, grid_nx: int, grid_ny: int,
                 cell_size: float, edge_seg: Optional[torch.Tensor] = None):
        if edge_rows.dtype != torch.float32 or edge_rows.dim() != 2 \
                or edge_rows.shape[1] != 8:
            raise ValueError("edge_rows must be [E, 8] float32")
        if cell_rows.dtype != torch.float32 or cell_rows.dim() != 2 \
                or cell_rows.shape[1] % 8:
            raise ValueError("cell_rows must be [n_cells, 8*cap] float32")
        if cell_rows.shape[0] != grid_nx * grid_ny:
            raise ValueError("cell_rows has %d rows for a %dx%d grid"
                             % (cell_rows.shape[0], grid_nx, grid_ny))
        self.edge_rows = edge_rows.contiguous()
        self.cell_rows = cell_rows.contiguous()
        self.grid_x0 = float(np.float32(grid_x0))
        self.grid_y0 = float(np.float32(grid_y0))
        self.grid_nx = int(grid_nx)
        self.grid_ny = int(grid_ny)
        self.cell_size = float(np.float32(cell_size))
        self.edge_seg = edge_seg

    @property
    def cap(self) -> int:
        return self.cell_rows.shape[1] // 8

    def to_device(self, device="cuda") -> "DeviceGraph":
        dev = resolve_device(device)
        return DeviceGraph(self.edge_rows.to(dev), self.cell_rows.to(dev),
                           self.grid_x0, self.grid_y0, self.grid_nx,
                           self.grid_ny, self.cell_size,
                           None if self.edge_seg is None
                           else self.edge_seg.to(dev))


@dataclass
class GraphArrays:
    proj: geo.LocalProjection
    # nodes
    node_x: np.ndarray
    node_y: np.ndarray
    # edges
    edge_from: np.ndarray
    edge_to: np.ndarray
    edge_len: np.ndarray
    edge_speed: np.ndarray  # m/s
    edge_level: np.ndarray
    edge_seg: np.ndarray  # dense segment index, -1 = unassociated
    edge_seg_off: np.ndarray  # metres from segment start to this edge's start
    edge_internal: np.ndarray
    edge_way: np.ndarray  # way id, -1 if none
    edge_head0: np.ndarray  # heading (radians, atan2(dy,dx)) at edge start
    edge_head1: np.ndarray  # heading at edge end
    # segment table
    seg_ids: np.ndarray  # int64 OSMLR ids
    seg_len: np.ndarray
    # flattened shape segments
    shp_ax: np.ndarray
    shp_ay: np.ndarray
    shp_bx: np.ndarray
    shp_by: np.ndarray
    shp_edge: np.ndarray
    shp_off: np.ndarray
    shp_len: np.ndarray
    # spatial grid
    grid_x0: float
    grid_y0: float
    cell_size: float
    grid_nx: int
    grid_ny: int
    grid_items: np.ndarray  # [ncells, cap] i32, -1 padded
    # adjacency (host)
    out_start: np.ndarray  # [N+1]
    out_edges: np.ndarray  # [E] edge ids sorted by from node

    @property
    def num_nodes(self) -> int:
        return len(self.node_x)

    @property
    def num_edges(self) -> int:
        return len(self.edge_from)

    def cell_rows(self) -> np.ndarray:
        """Cell-major [n_cells, 8*cap] f32 candidate planes (plane-major
        within a cell; see the module docstring).  Edge ids are stored as
        their float value, exact below 2**24 edges."""
        items = self.grid_items
        n_cells, cap = items.shape
        n = len(self.shp_ax)
        if self.num_edges >= (1 << 24):
            raise ValueError(
                "%d edges: ids no longer exact in float32 candidate planes; "
                "shard the region into smaller tile sets" % self.num_edges)
        packed = np.zeros((n, 8), np.float32)
        packed[:, 0] = self.shp_ax
        packed[:, 1] = self.shp_ay
        packed[:, 2] = self.shp_bx
        packed[:, 3] = self.shp_by
        packed[:, 4] = self.shp_off
        packed[:, 5] = self.shp_len
        packed[:, 6] = np.asarray(self.shp_edge, np.float32)
        rows = packed[np.where(items >= 0, items, 0)]  # [n_cells, cap, 8]
        empty = items < 0
        rows[empty] = 0.0
        rows[empty, 6] = -1.0
        return np.ascontiguousarray(
            rows.transpose(0, 2, 1).reshape(n_cells, 8 * cap))

    def edge_rows(self) -> np.ndarray:
        """Interleaved [n_edges, 8] f32 per-edge rows."""
        rows = np.zeros((self.num_edges, 8), np.float32)
        rows[:, 0] = np.asarray(self.edge_to, np.int32).view(np.float32)
        rows[:, 1] = np.asarray(self.edge_from, np.int32).view(np.float32)
        rows[:, 2] = self.edge_len
        rows[:, 3] = self.edge_speed
        rows[:, 4] = self.edge_head0
        rows[:, 5] = self.edge_head1
        return rows

    def device_graph(self) -> DeviceGraph:
        """The kernels' view of this graph, on the CPU (``to_device``
        moves it)."""
        return DeviceGraph(
            torch.from_numpy(self.edge_rows()),
            torch.from_numpy(self.cell_rows()),
            self.grid_x0, self.grid_y0, self.grid_nx, self.grid_ny,
            self.cell_size,
            torch.from_numpy(np.ascontiguousarray(self.edge_seg, np.int32)))

    def to_device(self, device="cuda") -> DeviceGraph:
        return self.device_graph().to_device(device)


def _order_segment_edges(edge_ids: List[int], efrom: np.ndarray, eto: np.ndarray) -> List[int]:
    """Order a segment's member edges head-to-tail; insertion order when
    they do not chain."""
    if len(edge_ids) <= 1:
        return edge_ids
    to_nodes = {int(eto[e]) for e in edge_ids}
    by_from = {int(efrom[e]): e for e in edge_ids}
    starts = [e for e in edge_ids if int(efrom[e]) not in to_nodes]
    if len(starts) != 1 or len(by_from) != len(edge_ids):
        return edge_ids
    ordered = [starts[0]]
    while len(ordered) < len(edge_ids):
        nxt = by_from.get(int(eto[ordered[-1]]))
        if nxt is None or nxt in ordered:
            return edge_ids
        ordered.append(nxt)
    return ordered


def build_graph_arrays(
    net: RoadNetwork,
    cell_size: float = 100.0,
    bucket_cap: Optional[int] = None,
    proj: Optional[geo.LocalProjection] = None,
) -> GraphArrays:
    if net.num_edges == 0:
        raise ValueError("empty network")
    min_lat, min_lon, max_lat, max_lon = net.bbox()
    if proj is None:
        proj = geo.LocalProjection.for_bbox(min_lat, min_lon, max_lat, max_lon)

    node_x, node_y = proj.to_xy(np.asarray(net.node_lat), np.asarray(net.node_lon))
    node_x = node_x.astype(np.float32)
    node_y = node_y.astype(np.float32)

    E = net.num_edges
    edge_from = np.array([e.from_node for e in net.edges], np.int32)
    edge_to = np.array([e.to_node for e in net.edges], np.int32)
    edge_speed = np.array([e.speed_kph / 3.6 for e in net.edges], np.float32)
    edge_level = np.array([e.level for e in net.edges], np.int32)
    edge_internal = np.array([e.internal for e in net.edges], np.bool_)
    edge_way = np.array([e.way_id if e.way_id is not None else -1 for e in net.edges], np.int64)

    # dense segment table
    seg_index: Dict[int, int] = {}
    for e in net.edges:
        if e.segment_id is not None and e.segment_id not in seg_index:
            seg_index[e.segment_id] = len(seg_index)
    seg_ids = np.array(sorted(seg_index, key=seg_index.get), np.int64)
    edge_seg = np.array(
        [seg_index[e.segment_id] if e.segment_id is not None else -1 for e in net.edges],
        np.int32,
    )

    # flatten shapes (projected), accumulate edge lengths
    shp_ax, shp_ay, shp_bx, shp_by, shp_edge, shp_off, shp_len = [], [], [], [], [], [], []
    edge_len = np.zeros(E, np.float32)
    for ei, e in enumerate(net.edges):
        sx, sy = proj.to_xy([p[0] for p in e.shape], [p[1] for p in e.shape])
        off = 0.0
        for i in range(len(sx) - 1):
            seg_l = float(np.hypot(sx[i + 1] - sx[i], sy[i + 1] - sy[i]))
            shp_ax.append(sx[i]); shp_ay.append(sy[i])
            shp_bx.append(sx[i + 1]); shp_by.append(sy[i + 1])
            shp_edge.append(ei); shp_off.append(off); shp_len.append(seg_l)
            off += seg_l
        edge_len[ei] = off

    shp_ax = np.array(shp_ax, np.float32)
    shp_ay = np.array(shp_ay, np.float32)
    shp_bx = np.array(shp_bx, np.float32)
    shp_by = np.array(shp_by, np.float32)
    shp_edge = np.array(shp_edge, np.int32)
    shp_off = np.array(shp_off, np.float32)
    shp_len = np.array(shp_len, np.float32)

    # per-edge headings at entry/exit (first/last shape segment direction)
    edge_head0 = np.zeros(E, np.float32)
    edge_head1 = np.zeros(E, np.float32)
    for si in range(len(shp_edge)):
        ei = int(shp_edge[si])
        h = float(np.arctan2(shp_by[si] - shp_ay[si], shp_bx[si] - shp_ax[si]))
        if shp_off[si] == 0.0:
            edge_head0[ei] = h
        edge_head1[ei] = h  # last write along the edge wins

    # per-segment totals + per-edge offsets within the segment
    seg_len = np.zeros(len(seg_ids), np.float32)
    edge_seg_off = np.zeros(E, np.float32)
    seg_edges: Dict[int, List[int]] = {}
    for ei in range(E):
        s = int(edge_seg[ei])
        if s >= 0:
            seg_edges.setdefault(s, []).append(ei)
    for s, eids in seg_edges.items():
        ordered = _order_segment_edges(eids, edge_from, edge_to)
        off = 0.0
        for ei in ordered:
            edge_seg_off[ei] = off
            off += float(edge_len[ei])
        seg_len[s] = off

    # spatial grid over shape segments (conservative bbox insertion); the
    # 2x2 quadrant query covers a search radius <= cell_size/2
    x_min = float(min(shp_ax.min(), shp_bx.min()))
    y_min = float(min(shp_ay.min(), shp_by.min()))
    x_max = float(max(shp_ax.max(), shp_bx.max()))
    y_max = float(max(shp_ay.max(), shp_by.max()))
    grid_x0 = x_min - cell_size
    grid_y0 = y_min - cell_size
    grid_nx = int(np.ceil((x_max - grid_x0) / cell_size)) + 2
    grid_ny = int(np.ceil((y_max - grid_y0) / cell_size)) + 2

    cells: Dict[int, List[int]] = {}
    for si in range(len(shp_ax)):
        cx0 = int((min(shp_ax[si], shp_bx[si]) - grid_x0) // cell_size)
        cx1 = int((max(shp_ax[si], shp_bx[si]) - grid_x0) // cell_size)
        cy0 = int((min(shp_ay[si], shp_by[si]) - grid_y0) // cell_size)
        cy1 = int((max(shp_ay[si], shp_by[si]) - grid_y0) // cell_size)
        for cy in range(cy0, cy1 + 1):
            for cx in range(cx0, cx1 + 1):
                cells.setdefault(cy * grid_nx + cx, []).append(si)

    # bucket capacity adapts to the data unless capped; overflowing items
    # are dropped longest-first and counted
    cap = max((len(v) for v in cells.values()), default=1)
    if bucket_cap is not None and cap > bucket_cap:
        dropped = sum(max(0, len(v) - bucket_cap) for v in cells.values())
        log.warning(
            "spatial grid bucket overflow: max %d items/cell > cap %d; "
            "dropping %d cell entries", cap, bucket_cap, dropped)
        cap = bucket_cap
    grid_items = np.full((grid_nx * grid_ny, cap), -1, np.int32)
    for cell, items in cells.items():
        if len(items) > cap:
            items = sorted(items, key=lambda si: -shp_len[si])[:cap]
        grid_items[cell, : len(items)] = items

    # CSR out-adjacency
    order = np.argsort(edge_from, kind="stable")
    out_edges = order.astype(np.int32)
    out_start = np.zeros(net.num_nodes + 1, np.int32)
    np.add.at(out_start, edge_from + 1, 1)
    out_start = np.cumsum(out_start).astype(np.int32)

    return GraphArrays(
        proj=proj,
        node_x=node_x, node_y=node_y,
        edge_from=edge_from, edge_to=edge_to, edge_len=edge_len,
        edge_speed=edge_speed, edge_level=edge_level,
        edge_seg=edge_seg, edge_seg_off=edge_seg_off,
        edge_internal=edge_internal, edge_way=edge_way,
        edge_head0=edge_head0, edge_head1=edge_head1,
        seg_ids=seg_ids, seg_len=seg_len,
        shp_ax=shp_ax, shp_ay=shp_ay, shp_bx=shp_bx, shp_by=shp_by,
        shp_edge=shp_edge, shp_off=shp_off, shp_len=shp_len,
        grid_x0=grid_x0, grid_y0=grid_y0, cell_size=float(cell_size),
        grid_nx=grid_nx, grid_ny=grid_ny, grid_items=grid_items,
        out_start=out_start, out_edges=out_edges,
    )
