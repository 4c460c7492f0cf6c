"""The device mesh: dp (the trace batch) x gp (the UBODT's bucket ranges).

The port of ``reporter_tpu/parallel/mesh.py``.  The reference drives its
whole mesh from one process through a ``jax.sharding.Mesh``; so does the
port: a ``Mesh`` is an [n_dp, n_gp] grid of ``torch.device``s, each dp
rank's compute runs on its gp rank 0, and the collectives
(``ops/collectives.py``) move one tensor per rank to one device, reduce it
there and hand each rank its copy.  Ranks may share a device: the CPU
tests build every rank on ``cpu`` (the reference's virtual CPU mesh), a
one-card run builds them on ``cuda:0``.  By default ``make_mesh`` /
``make_mesh2`` take ``cuda:0 ... cuda:n-1`` and raise when fewer cards
are visible; an explicit device list is the only way to share one.

  - the trace batch is sharded over "dp": each dp rank decodes its rows
    with kernels 1-5 on its device;
  - the graph arrays are replicated; the UBODT is replicated on a dp-only
    mesh and split into contiguous bucket ranges over "gp" on a 2-D mesh
    (``DeviceUBODT.shard``), where each probe fans out over the gp ranks
    and merges by pmin / pmax (``ops/hashtable.ubodt_lookup``).  The
    reference replicates the Viterbi compute across the gp ranks of a dp
    shard; the port computes it once per dp shard, on its gp rank 0, which
    gives the same bytes;
  - per-segment histograms (kernel 11b, ``ops/histogram.py``) are reduced
    over the dp ranks with a psum.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device, upload
from ..ops import collectives
from ..ops.candidates import Candidates
from ..ops.histogram import (
    SegmentHistogram, chosen_route, segment_histogram,
)
from ..ops.viterbi import match_batch_full
from ..tiles.arrays import DeviceGraph
from ..tiles.tiering import TieredTable
from ..tiles.ubodt import ShardedUBODT
from .rules import BATCH_AXIS, GRAPH_AXIS, spec_for

__all__ = ["Mesh", "MatchResult", "SegmentHistogram", "check_ubodt_shardable",
           "graph_sharded_match_fn", "make_mesh", "make_mesh2",
           "match_and_histogram", "place", "sharded_match_fn", "split_rows"]


class Mesh:
    """An [n_dp, n_gp] grid of devices with the axis names ("dp",) or
    ("dp", "gp"), gp innermost as in the reference.  ``lock`` is held
    across each dispatch's launches and collectives."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names: Sequence[str]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.axis_names = tuple(axis_names)
        if not self.devices or len({len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {BATCH_AXIS: len(self.devices)}
        if GRAPH_AXIS in self.axis_names:
            self.shape[GRAPH_AXIS] = len(self.devices[0])
        elif len(self.devices[0]) != 1:
            raise ValueError("a mesh without a gp axis has one device per row")
        self.lock = threading.RLock()

    @property
    def n_dp(self) -> int:
        return self.shape[BATCH_AXIS]

    @property
    def n_gp(self) -> int:
        return self.shape.get(GRAPH_AXIS, 1)

    @property
    def dp_devices(self) -> List[torch.device]:
        """Each dp rank's compute device (its gp rank 0)."""
        return [row[0] for row in self.devices]

    def __repr__(self) -> str:
        return "Mesh(%s, %s)" % (self.shape, [[str(d) for d in r]
                                              for r in self.devices])


def _visible(devices) -> list:
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D dp mesh over the first ``n_devices`` of ``devices`` (default:
    every visible card; an explicit list may name one device more than
    once, ranks then share it)."""
    devices = _visible(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                "asked for a %d-device mesh but only %d device(s) are visible"
                % (n_devices, len(devices)))
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("asked for a device mesh but no device is visible")
    return Mesh([[d] for d in devices], (BATCH_AXIS,))


def make_mesh2(n_dp: int, n_gp: int, devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh: batch ("dp") x graph shard ("gp"), gp innermost."""
    devices = _visible(devices)
    need = n_dp * n_gp
    if need > len(devices):
        raise ValueError(
            "asked for a %dx%d mesh but only %d device(s) are visible"
            % (n_dp, n_gp, len(devices)))
    return Mesh([devices[i * n_gp:(i + 1) * n_gp] for i in range(n_dp)],
                (BATCH_AXIS, GRAPH_AXIS))


def check_ubodt_shardable(ubodt, n_gp: int):
    """The gp axis splits the table into n_gp equal bucket ranges; the
    power-of-two bucket count must divide evenly (it does whenever n_gp is
    a power of two no larger than it).  Returns the table unchanged."""
    size = ubodt.packed.shape[0]
    if size % n_gp:
        raise ValueError(
            "UBODT bucket count %d not divisible by gp=%d (use a power-of-two "
            "gp axis)" % (size, n_gp))
    return ubodt


def split_rows(mesh: Mesh, value, axis: int) -> list:
    """``value`` (a tensor or host array) cut into n_dp equal blocks along
    ``axis``, block r on dp rank r's device (host arrays uploaded)."""
    n = mesh.n_dp
    if value.shape[axis] % n:
        raise ValueError("%d rows do not split over dp=%d"
                         % (value.shape[axis], n))
    if isinstance(value, np.ndarray):
        return [upload(b, d) for b, d in zip(np.split(value, n, axis),
                                             mesh.dp_devices)]
    return [b.to(d).contiguous() for b, d in zip(torch.chunk(value, n, axis),
                                                 mesh.dp_devices)]


def place(mesh: Mesh, name: str, value) -> list:
    """Program argument ``name`` as each dp rank sees it, by the rule
    table (``rules.spec_for``; an unmatched name raises): blocks of rows
    over dp, a table split into gp bucket ranges (a ``ShardedUBODT`` per
    dp rank), or the value replicated on each rank's device, one copy per
    device.  A tiered table (``TieredTable`` built on this mesh) splits
    into its ranks' ``TieredDeviceUBODT`` views over the one manager, the
    same way.  Parameter bundles ("p", "sp") are host scalars every rank
    reads as they are."""
    spec = spec_for(name, mesh)
    if BATCH_AXIS in spec:
        return split_rows(mesh, value, spec.index(BATCH_AXIS))
    if name in ("p", "sp"):
        return [value] * mesh.n_dp
    if isinstance(value, TieredTable):
        # the tier's views: each (gp rank, device) pair's copy of its rank
        if GRAPH_AXIS in spec:
            return [ShardedUBODT(value.view(g, dev) for g, dev in enumerate(row))
                    for row in mesh.devices]
        return [value.view(0, d) for d in mesh.dp_devices]
    # ranks that share a device share one read-only copy
    copies: dict = {}
    if GRAPH_AXIS in spec:
        check_ubodt_shardable(value, mesh.n_gp)

        def view(g, dev):
            if (g, dev) not in copies:
                copies[g, dev] = value.shard(g, mesh.n_gp, dev)
            return copies[g, dev]
        return [ShardedUBODT(view(g, dev) for g, dev in enumerate(row))
                for row in mesh.devices]
    for d in mesh.dp_devices:
        if d not in copies:
            copies[d] = value.to_device(d)  # a DeviceGraph or DeviceUBODT
    return [copies[d] for d in mesh.dp_devices]


class MatchResult(NamedTuple):
    """The decoded batch the histogram reads (leading [B])."""

    cand: Candidates  # [B, T, K] candidate pool per point
    idx: torch.Tensor  # [B, T] i32 chosen slot, -1 = unmatched
    breaks: torch.Tensor  # [B, T] bool, True where a new HMM segment starts
    route_dist: torch.Tensor  # [B, T] f32 route metres into the chosen slot
    aux: torch.Tensor  # [B, 4] f32 confidence diagnostics


def match_and_histogram(dg: DeviceGraph, du, px, py, times, valid, p, k: int,
                        num_segments: int):
    """The framework's device step on one device: match the [B, T] batch
    (the reference's ``match_batch``: scan forward, dense model), then
    reduce per-segment aggregates over the whole batch (kernel 11b).
    Returns (MatchResult, SegmentHistogram)."""
    pre, packed, aux, choice = match_batch_full(dg, du, px, py, times, valid,
                                                p, k)
    hist = segment_histogram(
        choice, pre.route, pre.cand.edge, packed[2], times, dg.edge_seg,
        num_segments)
    res = MatchResult(cand=pre.cand, idx=choice[0], breaks=packed[2] != 0,
                      route_dist=chosen_route(choice, pre.route), aux=aux)
    return res, hist


def _mesh_fn(mesh: Mesh, k: int, num_segments: int):
    tables: dict = {}

    def fn(dg, du, px, py, times, valid, p):
        with mesh.lock:
            key = id(du)
            if key not in tables:  # the table's placement, built once
                tables.clear()
                tables[key] = (du, place(mesh, "du", du))
            dus = tables[key][1]
            parts = [match_and_histogram(g, u, *rows, p, k, num_segments)
                     for g, u, *rows in zip(
                         place(mesh, "dg", dg), dus,
                         *(split_rows(mesh, a, 0) for a in (px, py, times, valid)))]
            res = [r for r, _h in parts]
            gather = lambda leaves: collectives.all_gather(list(leaves))[0]  # noqa: E731
            out = MatchResult(
                cand=Candidates(*(None if c[0] is None else gather(c)
                                  for c in zip(*(r.cand for r in res)))),
                idx=gather(r.idx for r in res),
                breaks=gather(r.breaks for r in res),
                route_dist=gather(r.route_dist for r in res),
                aux=gather(r.aux for r in res))
            # the full batch's histogram: a psum over the dp ranks
            hist = SegmentHistogram(*(collectives.psum(list(h))[0]
                                      for h in zip(*(h for _r, h in parts))))
            return out, hist

    return fn


def sharded_match_fn(mesh: Mesh, k: int, num_segments: int):
    """(dg, du, px, py, times, valid, params) -> (MatchResult,
    SegmentHistogram), the batch axis split over the mesh's dp ranks (the
    row count a multiple of n_dp), the table replicated, the histogram
    summed over the ranks."""
    return _mesh_fn(mesh, k, num_segments)


def graph_sharded_match_fn(mesh: Mesh, k: int, num_segments: int):
    """The graph-sharded variant for tables that do not fit one card: the
    UBODT split into bucket ranges over "gp" (1/n_gp of the table per
    device), the batch over "dp"; probes resolve by pmin / pmax over the
    gp ranks (kernel 11a).  Same calling convention as
    ``sharded_match_fn``; the table's bucket count must divide by the gp
    axis size (``check_ubodt_shardable``)."""
    if GRAPH_AXIS not in mesh.axis_names:
        raise ValueError("graph_sharded_match_fn needs a mesh with a gp axis")
    return _mesh_fn(mesh, k, num_segments)
