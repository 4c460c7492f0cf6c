"""Carry the reference's host structures across as the port's device views.

The reference and the port build the same graph and UBODT bytes (the
tests assert it); these helpers take those bytes as numpy arrays, however
they were built, and wrap them in the port's ``DeviceGraph`` and
``DeviceUBODT`` on the CPU (``to_device`` moves them to the card), turn
a carried Viterbi state (a ``TraceCarry`` of numpy leaves, or the session
store's host carry dict) into the port's carry tensors, and the sparse
model's six scalars into the port's ``SparseParams``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.viterbi import CARRY_DTYPES, SparseParams, TraceCarry
from .tiles.arrays import DeviceGraph
from .tiles.ubodt import ROW_W, DeviceUBODT, bucket_entries


def graph_from_numpy(edge_rows, cell_rows, grid_origin, grid_dims,
                     cell_size) -> DeviceGraph:
    """``edge_rows`` [E, 8] f32, ``cell_rows`` [n_cells, 8*cap] f32,
    ``grid_origin`` (x0, y0), ``grid_dims`` (nx, ny), ``cell_size``."""
    x0, y0 = (float(v) for v in np.asarray(grid_origin, np.float32))
    nx, ny = (int(v) for v in np.asarray(grid_dims))
    return DeviceGraph(
        torch.from_numpy(np.ascontiguousarray(edge_rows, np.float32)),
        torch.from_numpy(np.ascontiguousarray(cell_rows, np.float32)),
        x0, y0, nx, ny, float(np.float32(cell_size)))


def ubodt_from_numpy(packed, bmask, layout: str = "cuckoo") -> DeviceUBODT:
    """``packed`` table of ``layout`` ([n_buckets, 128] or [n_buckets, 16,
    8] int32 cuckoo, [n_buckets, 256] or [n_buckets, 32, 8] wide32) and
    its bucket mask."""
    packed = np.ascontiguousarray(packed, np.int32)
    return DeviceUBODT(
        torch.from_numpy(packed.reshape(-1, bucket_entries(layout) * ROW_W)),
        int(bmask), layout)


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.bool: np.bool_}


def carry_from_numpy(carry) -> TraceCarry:
    """A carried Viterbi state as the port's ``TraceCarry`` on the CPU, bit
    for bit: anything with the eight leaves ``scores, edge, offset, x, y,
    t, active, committed`` as attributes (the reference's ``TraceCarry``,
    leaves as numpy or anything ``np.asarray`` reads) or as keys (a host
    carry dict).  Leaf shapes are kept: [B, K] / [B] for a batch, [K] / ()
    for one row."""
    get = carry.get if isinstance(carry, dict) else (
        lambda name: getattr(carry, name))
    return TraceCarry(*(
        torch.from_numpy(np.array(np.asarray(get(name)), _NP_DTYPES[dt]))
        for name, dt in zip(TraceCarry._fields, CARRY_DTYPES)))


def sparse_params_from_numpy(sp) -> SparseParams:
    """The sparse model's scalars as the port's ``SparseParams``, bit for
    bit: anything with the six fields ``beta_ref, beta_scale, beta_max,
    break_speed, vmax, plaus_weight`` as attributes (the reference's
    ``SparseParams``, leaves as numpy or anything ``np.asarray`` reads)."""
    return SparseParams(*(
        torch.from_numpy(np.array(np.asarray(getattr(sp, name)), np.float32))
        for name in SparseParams._fields))
