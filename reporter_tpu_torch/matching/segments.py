"""Host-side segment association: matched candidates -> OSMLR segment records.

Takes the device MatchResult (chosen candidate per point + HMM break flags),
reconstructs the continuous edge path between consecutive matched points via
UBODT first-edge hops, pins known times at the matched points, linearly
interpolates times at segment boundaries by route distance, and emits the
wire-format segment records of the reference's segment_matcher
(README.md:276-297):

    segment_id        absent when the edge has no OSMLR coverage
    way_ids           way ids of member edges
    start_time        time path entered the segment's *beginning*, -1 if the
                      path got on mid-segment
    end_time          time path exited the segment's *end*, -1 if it left
                      mid-segment
    length            full segment length, or -1 when not completely traversed
    internal          turn channel / roundabout / internal intersection
    queue_length      distance from segment end where speed < threshold
    begin_shape_index index of the trace point at/before segment entry
    end_shape_index   index of the trace point at/before segment exit

An HMM break (teleport / infeasible transition) closes the current path;
records on either side are independent, which report() counts as a
discontinuity when both boundary times are -1 (reporter_service.py:114-116).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class _PathSpan:
    edge: int
    enter_off: float  # metres along edge where the path enters
    exit_off: float  # metres along edge where the path leaves
    route_start: float  # cumulative route distance at enter


@dataclass
class _Pin:
    route_pos: float
    time: float
    shape_index: int


class _TimeLine:
    """Piecewise-linear time as a function of route position."""

    def __init__(self, pins: List[_Pin]):
        self.pins = pins

    def time_at(self, pos: float) -> float:
        pins = self.pins
        if not pins:
            return -1.0
        if pos <= pins[0].route_pos:
            return pins[0].time
        for a, b in zip(pins, pins[1:]):
            if pos <= b.route_pos:
                if b.route_pos <= a.route_pos:
                    return a.time
                f = (pos - a.route_pos) / (b.route_pos - a.route_pos)
                return a.time + f * (b.time - a.time)
        return pins[-1].time

    def shape_index_at(self, pos: float) -> int:
        """Index of the last trace point at/before the given route position."""
        out = self.pins[0].shape_index if self.pins else 0
        for p in self.pins:
            if p.route_pos <= pos + 1e-6:
                out = p.shape_index
            else:
                break
        return out

    def queue_length(self, entry: float, exit: float, thresh_mps: float) -> float:
        """Length of the contiguous run of slow travel (< thresh_mps) ending at
        the exit position -- the 'distance from the end of the segment where
        the speed drops below the threshold' of the reference's wire schema
        (README.md:283)."""
        q = 0.0
        pos = exit
        for a, b in zip(reversed(self.pins[:-1]), reversed(self.pins[1:])):
            if b.route_pos <= entry:
                break
            lo = max(a.route_pos, entry)
            hi = min(b.route_pos, exit)
            if hi <= lo:
                continue
            if hi < pos - 1e-6:  # gap: slow run no longer touches the exit
                break
            dt = b.time - a.time
            dr = b.route_pos - a.route_pos
            speed = (dr / dt) if dt > 0 else float("inf")
            if speed < thresh_mps:
                q += hi - lo
                pos = lo
            else:
                break
        return q


def _build_paths(arrays, ubodt, match_points: List[dict],
                 back_tol: float = 15.0) -> List[Tuple[List[_PathSpan], _TimeLine]]:
    """Group matched points into continuous paths (split at breaks/unmatched),
    reconstructing intermediate edges from the UBODT.  back_tol mirrors the
    kernel's same-edge jitter tolerance: a backward move within it is treated
    as standing still; beyond it the HMM paid for the loop route, so the loop
    edges are emitted here too."""
    paths: List[Tuple[List[_PathSpan], _TimeLine]] = []
    spans: List[_PathSpan] = []
    pins: List[_Pin] = []
    route_pos = 0.0

    def flush():
        nonlocal spans, pins, route_pos
        if spans:
            paths.append((spans, _TimeLine(pins)))
        spans, pins, route_pos = [], [], 0.0

    prev: Optional[dict] = None
    for mp in match_points:
        if mp["edge"] < 0:
            # unmatched point: close the current path
            flush()
            prev = None
            continue
        if prev is None or mp["break"]:
            flush()
            spans = [_PathSpan(mp["edge"], mp["offset"], mp["offset"], 0.0)]
            pins = [_Pin(0.0, mp["time"], mp["shape_index"])]
            route_pos = 0.0
            prev = mp
            continue

        e_prev, e_cur = prev["edge"], mp["edge"]
        cur_span = spans[-1]
        same_edge = e_cur == e_prev
        if same_edge and mp["offset"] >= cur_span.exit_off:
            # forward on the same edge: advance
            route_pos += mp["offset"] - cur_span.exit_off
            cur_span.exit_off = mp["offset"]
        elif same_edge and cur_span.exit_off - mp["offset"] <= back_tol:
            # small backward jitter: keep position, pin the time only
            pass
        else:
            # leave prev edge through its end, route to current edge's start
            edge_to = int(arrays.edge_to[e_prev])
            edge_from = int(arrays.edge_from[e_cur])
            mid_edges = ubodt.path_edges(edge_to, edge_from)
            if mid_edges is None:
                # no route (should have been a break) -- split defensively
                flush()
                spans = [_PathSpan(e_cur, mp["offset"], mp["offset"], 0.0)]
                pins = [_Pin(0.0, mp["time"], mp["shape_index"])]
                route_pos = 0.0
                prev = mp
                continue
            route_pos += float(arrays.edge_len[e_prev]) - cur_span.exit_off
            cur_span.exit_off = float(arrays.edge_len[e_prev])
            for me in mid_edges:
                spans.append(_PathSpan(me, 0.0, float(arrays.edge_len[me]), route_pos))
                route_pos += float(arrays.edge_len[me])
            spans.append(_PathSpan(e_cur, 0.0, mp["offset"], route_pos))
            route_pos += mp["offset"]
        pins.append(_Pin(route_pos, mp["time"], mp["shape_index"]))
        prev = mp

    flush()
    return paths


def _segment_records(arrays, spans: List[_PathSpan], tl: _TimeLine,
                     queue_thresh_mps: float) -> List[dict]:
    """Group path spans into per-OSMLR-segment traversal records."""
    records: List[dict] = []
    i = 0
    n = len(spans)
    while i < n:
        sp = spans[i]
        seg = int(arrays.edge_seg[sp.edge])
        internal = bool(arrays.edge_internal[sp.edge])
        # group consecutive spans on the same segment (or same association
        # status for unassociated/internal runs)
        j = i
        group = []
        while j < n:
            sj = spans[j]
            if int(arrays.edge_seg[sj.edge]) != seg or bool(arrays.edge_internal[sj.edge]) != internal:
                break
            group.append(sj)
            j += 1

        first, last = group[0], group[-1]
        entry_route = first.route_start
        exit_route = last.route_start + (last.exit_off - last.enter_off)

        way_ids = []
        for g in group:
            w = int(arrays.edge_way[g.edge])
            if w >= 0 and w not in way_ids:
                way_ids.append(w)

        rec: dict = {
            "way_ids": way_ids,
            "internal": internal,
            "queue_length": round(tl.queue_length(entry_route, exit_route, queue_thresh_mps), 1),
            "begin_shape_index": tl.shape_index_at(entry_route),
            "end_shape_index": tl.shape_index_at(exit_route),
        }

        if seg >= 0 and not internal:
            seg_id = int(arrays.seg_ids[seg])
            seg_total = float(arrays.seg_len[seg])
            # position within the segment at entry/exit
            seg_entry = float(arrays.edge_seg_off[first.edge]) + first.enter_off
            seg_exit = float(arrays.edge_seg_off[last.edge]) + last.exit_off
            entered_at_start = seg_entry <= 1e-3
            exited_at_end = seg_exit >= seg_total - 1e-3
            rec["segment_id"] = seg_id
            rec["start_time"] = round(tl.time_at(entry_route), 3) if entered_at_start else -1
            rec["end_time"] = round(tl.time_at(exit_route), 3) if exited_at_end else -1
            rec["length"] = round(seg_total, 3) if (entered_at_start and exited_at_end) else -1
        else:
            rec["start_time"] = round(tl.time_at(entry_route), 3)
            rec["end_time"] = round(tl.time_at(exit_route), 3)
            rec["length"] = -1

        records.append(rec)
        i = j
    return records


def associate_segments(arrays, ubodt, match_points: List[dict],
                       queue_thresh_mps: float = 20.0 / 3.6,
                       back_tol: float = 15.0) -> List[dict]:
    """match_points: per original trace point, dicts with keys
    edge (int, -1 unmatched), offset (m), time (s), break (bool),
    shape_index (int).  Returns the wire-format segments list."""
    out: List[dict] = []
    for spans, tl in _build_paths(arrays, ubodt, match_points, back_tol=back_tol):
        out.extend(_segment_records(arrays, spans, tl, queue_thresh_mps))
    return out
