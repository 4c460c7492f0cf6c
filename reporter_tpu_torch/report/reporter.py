"""The report() business logic: matched segments -> datastore reports + stats.

Behavioral port of the reference's core reporting walk
(py/reporter_service.py:79-179) -- the contract every downstream consumer
(BatchingProcessor, simple_reporter, the datastore) depends on:

  - segments younger than ``threshold_sec`` before the trace end are held back
    (they may still grow when the next window arrives); ``shape_used`` tells
    the caller how much of the trace is consumed and can be trimmed
    (reporter_service.py:83-92; the streaming client honours it in
    Batch.java:73-80)
  - a segment is reported only when *complete* (length > 0), non-internal,
    and its level is in ``report_levels``; its t1 is the next segment's start
    time when that level is in ``transition_levels`` (with next_id attached),
    else its own end time
  - internal segments (turn channels, roundabouts) are transparent: they mark
    the prior segment internal but do not replace it
  - validity cuts: dt <= 0 / inf / nan, and speed > 160 km/h
    (reporter_service.py:130-133)
  - stats: successful / unreported counts + km, discontinuities (consecutive
    -1 end / -1 start), invalid times/speeds, unassociated segments

Deviation from the reference (documented, deliberate): successful_length and
unreported_length *accumulate* over the walk; the reference assigns instead of
adding (reporter_service.py:138,142), so its value is just the last segment's
length -- an apparent bug we do not replicate.
"""

from __future__ import annotations

import math
from typing import Optional, Set


def report(
    match: dict,
    trace: dict,
    threshold_sec: int,
    report_levels: Set[int],
    transition_levels: Set[int],
    mode: str = "auto",
) -> dict:
    """match: {"segments": [...]} from SegmentMatcher; trace: the request dict."""
    segments = match.get("segments", [])
    trace_points = trace["trace"]
    end_time = trace_points[-1]["time"]

    # hold back segments that may still be growing: walk backwards while the
    # segment started less than threshold_sec before the trace end
    last_idx = len(segments) - 1
    while last_idx >= 0 and end_time - segments[last_idx]["start_time"] < threshold_sec:
        last_idx -= 1

    shape_used: Optional[int] = None
    if last_idx >= 0:
        shape_used = segments[last_idx]["begin_shape_index"]

    match["mode"] = mode
    datastore = {"mode": mode, "reports": []}

    successful_count = 0
    successful_length = 0.0
    unreported_count = 0
    unreported_length = 0.0
    discontinuities = 0
    invalid_time = 0
    invalid_speed = 0
    unassociated = 0

    prior = None  # dict of the last reportable (non-internal) segment record
    first = True
    for idx in range(0, last_idx + 1):
        seg = segments[idx]
        segment_id = seg.get("segment_id")
        start_time = seg.get("start_time")
        internal = bool(seg.get("internal", False))

        if idx != 0 and seg.get("start_time") == -1 and segments[idx - 1].get("end_time") == -1:
            discontinuities += 1

        level = (segment_id & 0x7) if segment_id is not None else -1

        # the prior must be a complete, *associated* segment to be considered
        # at all (reference condition: prior_segment_id != None and
        # prior_length > 0, reporter_service.py:122)
        if prior is not None and prior["segment_id"] is not None and prior["length"] is not None \
                and prior["length"] > 0 and not internal:
            if prior["level"] in report_levels:
                rep = {
                    "id": prior["segment_id"],
                    "t0": prior["start_time"],
                    "t1": start_time if level in transition_levels else prior["end_time"],
                    "length": prior["length"],
                    "queue_length": prior["queue_length"],
                }
                if level in transition_levels and segment_id is not None:
                    rep["next_id"] = segment_id
                dt = float(rep["t1"]) - float(rep["t0"])
                if dt <= 0 or math.isinf(dt) or math.isnan(dt):
                    invalid_time += 1
                elif (prior["length"] / dt) * 3.6 > 160:
                    invalid_speed += 1
                else:
                    datastore["reports"].append(rep)
                    successful_count += 1
                    successful_length += prior["length"] * 0.001
            else:
                unreported_count += 1
                unreported_length += prior["length"] * 0.001

        # internal segments are transparent for pairing purposes; anything
        # else becomes the new prior
        if internal and not first:
            pass
        else:
            prior = {
                "segment_id": segment_id,
                "start_time": start_time,
                "end_time": seg.get("end_time"),
                "length": seg.get("length"),
                "queue_length": seg.get("queue_length"),
                "level": level,
            }
        first = False

        if segment_id is None and not internal:
            unassociated += 1

    data = {
        "stats": {
            "successful_matches": {
                "count": successful_count,
                "length": round(successful_length, 3),
            },
            "unreported_matches": {
                "count": unreported_count,
                "length": round(unreported_length, 3),
            },
            "match_errors": {
                "discontinuities": discontinuities,
                "invalid_speeds": invalid_speed,
                "invalid_times": invalid_time,
            },
            "unassociated_segments": unassociated,
        },
        "segment_matcher": match,
        "datastore": datastore,
    }
    # parity quirk: the reference emits shape_used only when truthy
    # (reporter_service.py:165-166), so index 0 is omitted
    if shape_used:
        data["shape_used"] = shape_used
    return data
