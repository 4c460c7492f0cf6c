"""Batched segment association: matched edge/offset/break per point ->
wire-format segment records, for a whole device batch.

One call of the native core (``rn_associate_batch_mt``, rows fanned over
C++ threads with the GIL released), falling back to the Python walk in
matching/segments.py point for point when the native library is not
available.  Both produce identical records; rounding happens here, after
the raw doubles come back, so the wire format is the same either way.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from ..native import get_lib
from .segments import associate_segments


def _fallback(arrays, ubodt, edge, offset, breaks, times, n_points,
              queue_thresh_mps: float, back_tol: float) -> List[List[dict]]:
    offset = np.asarray(offset, np.float32)
    out: List[List[dict]] = []
    for b in range(edge.shape[0]):
        n = int(n_points[b])
        match_points = [
            {
                "edge": int(edge[b, t]),
                "offset": float(offset[b, t]),
                "time": float(times[b, t]),
                "break": bool(breaks[b, t]),
                "shape_index": t,
            }
            for t in range(n)
        ]
        out.append(associate_segments(
            arrays, ubodt, match_points,
            queue_thresh_mps=queue_thresh_mps, back_tol=back_tol))
    return out


def associate_segments_batch(
    arrays,
    ubodt,
    edge: np.ndarray,  # [B, T] i32, -1 unmatched
    offset: np.ndarray,  # [B, T] f32
    breaks: np.ndarray,  # [B, T] bool
    times: np.ndarray,  # [B, T] f64 epoch seconds
    n_points: Sequence[int],  # live prefix per row
    queue_thresh_mps: float = 20.0 / 3.6,
    back_tol: float = 15.0,
    lib=None,
) -> List[List[dict]]:
    """One wire-format segments list per batch row."""
    B, T = edge.shape
    n_pts = np.ascontiguousarray(n_points, np.int32)
    if lib is None:
        lib = get_lib()
    if lib is None:
        return _fallback(arrays, ubodt, edge, offset, breaks, times, n_pts,
                         queue_thresh_mps, back_tol)

    m_edge = np.ascontiguousarray(edge, np.int32)
    m_off = np.ascontiguousarray(offset, np.float32)
    m_brk = np.ascontiguousarray(breaks, np.uint8)
    m_tim = np.ascontiguousarray(times, np.float64)

    # graph/UBODT views are immutable; convert once per object
    views = getattr(arrays, "_assoc_views", None)
    if views is None:
        views = (
            np.ascontiguousarray(arrays.edge_from, np.int32),
            np.ascontiguousarray(arrays.edge_to, np.int32),
            np.ascontiguousarray(arrays.edge_len, np.float32),
            np.ascontiguousarray(arrays.edge_seg, np.int32),
            np.ascontiguousarray(arrays.edge_seg_off, np.float32),
            np.ascontiguousarray(arrays.edge_internal, np.uint8),
            np.ascontiguousarray(arrays.edge_way, np.int64),
            np.ascontiguousarray(arrays.seg_ids, np.int64),
            np.ascontiguousarray(arrays.seg_len, np.float32),
        )
        arrays._assoc_views = views
    g_from, g_to, g_len, g_seg, g_seg_off, g_internal, g_way, s_ids, s_len = views
    t_packed = np.ascontiguousarray(ubodt.packed.reshape(-1), np.int32)

    n_threads = 0  # all cores
    out_cap = int(m_edge.size) * 2 + 64 * B + 64
    way_cap = out_cap * 2
    while True:
        rec_start = np.zeros(B + 1, np.int64)
        has_seg = np.zeros(out_cap, np.uint8)
        seg_id = np.zeros(out_cap, np.int64)
        t0 = np.zeros(out_cap, np.float64)
        t1 = np.zeros(out_cap, np.float64)
        length = np.zeros(out_cap, np.float64)
        internal = np.zeros(out_cap, np.uint8)
        qlen = np.zeros(out_cap, np.float64)
        bshape = np.zeros(out_cap, np.int32)
        eshape = np.zeros(out_cap, np.int32)
        way_start = np.zeros(out_cap + 1, np.int64)
        way_ids = np.zeros(way_cap, np.int64)
        # on overflow the exact needed sizes come back, so one retry suffices
        need_rec = ctypes.c_int64(0)
        need_way = ctypes.c_int64(0)
        rc = lib.rn_associate_batch_mt(
            g_from, g_to, g_len, g_seg, g_seg_off, g_internal, g_way,
            s_ids, s_len, t_packed, int(ubodt.bmask), int(ubodt.bucket_entries),
            int(ubodt.num_rows), B, T, m_edge, m_off, m_brk, m_tim, n_pts,
            float(queue_thresh_mps), float(back_tol), n_threads, out_cap,
            way_cap, rec_start[1:], has_seg, seg_id, t0, t1, length, internal,
            qlen, bshape, eshape, way_start, way_ids,
            ctypes.byref(need_rec), ctypes.byref(need_way),
        )
        if rc == 0:
            break
        out_cap = max(out_cap * 2, int(need_rec.value))
        way_cap = max(way_cap * 2, int(need_way.value))

    # bulk-convert columns to Python scalars once; rounding is the builtin
    # round() on Python floats, as in the Python walk
    n_rec = int(rec_start[B])
    rsl = rec_start.tolist()
    wsl = way_start[: n_rec + 1].tolist()
    way_l = way_ids[: wsl[n_rec] if n_rec else 0].tolist()
    hs = has_seg[:n_rec].tolist()
    sid = seg_id[:n_rec].tolist()
    t0l = t0[:n_rec].tolist()
    t1l = t1[:n_rec].tolist()
    lnl = length[:n_rec].tolist()
    inl = internal[:n_rec].tolist()
    qll = qlen[:n_rec].tolist()
    bsl = bshape[:n_rec].tolist()
    esl = eshape[:n_rec].tolist()

    out: List[List[dict]] = []
    for b in range(B):
        recs: List[dict] = []
        for r in range(rsl[b], rsl[b + 1]):
            rec: dict = {
                "way_ids": way_l[wsl[r]:wsl[r + 1]],
                "internal": bool(inl[r]),
                "queue_length": round(qll[r], 1),
                "begin_shape_index": bsl[r],
                "end_shape_index": esl[r],
            }
            if hs[r]:
                rec["segment_id"] = sid[r]
                rec["start_time"] = round(t0l[r], 3) if t0l[r] >= 0 else -1
                rec["end_time"] = round(t1l[r], 3) if t1l[r] >= 0 else -1
                rec["length"] = round(lnl[r], 3) if lnl[r] >= 0 else -1
            else:
                rec["start_time"] = round(t0l[r], 3)
                rec["end_time"] = round(t1l[r], 3)
                rec["length"] = -1
            recs.append(rec)
        out.append(recs)
    return out
