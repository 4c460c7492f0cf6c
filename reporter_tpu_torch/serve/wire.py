"""Binary columnar wire format (``application/x-reporter-columnar``).

A copy of the reference's ``serve/wire.py``: the same frames, byte for
byte, both ways.  The JSON wire stays the default and the contract
(docs/http-api.md "Wire formats"); this codec is a negotiated fast path
for the two matching POST endpoints (``/report``,
``/trace_attributes_batch``).  The frame carries the numeric bulk -- point
lat/lon/time on requests, segment/report fields on responses -- as flat
little-endian columns that ``np.frombuffer`` ingests with no per-point
Python, and everything else (uuids, match_options, stats, any unmodelled
key) as one small JSON tail, so unknown keys round-trip through the tail
instead of failing.

Frame layout (version 1, all integers little-endian)::

    "RPTC" | u8 version | u8 kind | u8 flags | u8 pad
    kind 1 (request):
        u32 n_traces | u32 lens[n]
        u8 numstate[4*n]      # per trace x (lat,lon,time,accuracy):
                              # 0=float 1=int 2=mixed (exact int positions
                              # in the tail) 3=accuracy not columnar for
                              # this trace (absent/irregular; any actual
                              # values ride the point-extras tail)
        f64 lat[total] | f64 lon[total] | f64 time[total]
        f64 accuracy[total of traces with state != 3]
        u32 tail_len | tail JSON
    kind 2 (response):        # flags bit0=degraded, bit1=single (/report)
        u32 n_results | u32 n_segs[n] | u32 n_reps[n]
        per segment column (SEG_KEYS order):  u8 states[S] | f64 vals[S]
        per report  column (REP_KEYS order):  u8 states[R] | f64 vals[R]
        u32 tail_len | tail JSON

Column value states: 0=key absent, 1=int, 2=float, 3=null, 4=false,
5=true.  Ints ride the f64 column exactly below 2**53; larger (or
non-scalar) values spill to per-item extras in the tail.  The decode is
therefore DICT-IDENTICAL to the JSON wire: the same values with the same
int/float types.

Request decode attaches a ``"_columns"`` side channel (f64 lat/lon/time
arrays) to every trace dict, the reference's columnar packer's input.
The port's packer reads the point dicts, so the service strips the key
before matching and before any echo (it is transport state, not
payload).

Dependency-free: stdlib ``struct``/``json`` + numpy.  Every length field
is bounds-checked against the buffer before use; a malformed frame raises
``WireError`` (a ``ValueError``), never over-reads.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"RPTC"
VERSION = 1
KIND_REQUEST = 1
KIND_RESPONSE = 2
CONTENT_TYPE = "application/x-reporter-columnar"

FLAG_DEGRADED = 0x01   # response: top-level "degraded": true
FLAG_SINGLE = 0x02     # request: bare /report trace; response: bare report

# value states for response struct-list columns
_ABSENT, _INT, _FLOAT, _NULL, _FALSE, _TRUE = range(6)

# request numstate for the optional accuracy column: the reference wire
# format's points carry accuracy as a fourth numeric field, so it rides a
# column whenever a trace's points carry it uniformly (per-point extras in
# the JSON tail would cost what JSON costs), and state 3 marks a trace
# whose accuracy is absent or irregular (those values spill to the extras
# tail)
_ACC_SKIP = 3
_REQ_COLS = ("lat", "lon", "time", "accuracy")

# hot columns; anything else (or an oversized/exotic value) rides the
# JSON tail as a per-item extra -- the codec tracks the schema loosely on
# purpose so report/reporter.py can grow keys without a wire version bump
SEG_KEYS = ("length", "internal", "queue_length", "begin_shape_index",
            "end_shape_index", "segment_id", "start_time", "end_time")
REP_KEYS = ("id", "t0", "t1", "length", "queue_length", "next_id")

_MAX_EXACT = 1 << 53   # ints beyond f64 exactness spill to the tail
_U32_MAX = 0xFFFFFFFF


class WireError(ValueError):
    """Malformed or out-of-bounds columnar frame."""


# -- primitives -------------------------------------------------------------


def _need(buf: bytes, off: int, n: int) -> None:
    if n < 0 or off + n > len(buf):
        raise WireError("frame truncated at offset %d (+%d > %d)"
                        % (off, n, len(buf)))


def _u32(buf: bytes, off: int) -> Tuple[int, int]:
    _need(buf, off, 4)
    return struct.unpack_from("<I", buf, off)[0], off + 4


def _u32s(buf: bytes, off: int, n: int) -> Tuple[np.ndarray, int]:
    _need(buf, off, 4 * n)
    return np.frombuffer(buf, "<u4", n, off), off + 4 * n


def _f64s(buf: bytes, off: int, n: int) -> Tuple[np.ndarray, int]:
    _need(buf, off, 8 * n)
    return np.frombuffer(buf, "<f8", n, off), off + 8 * n


def _u8s(buf: bytes, off: int, n: int) -> Tuple[np.ndarray, int]:
    _need(buf, off, n)
    return np.frombuffer(buf, np.uint8, n, off), off + n


def _tail(buf: bytes, off: int) -> Tuple[dict, int]:
    n, off = _u32(buf, off)
    _need(buf, off, n)
    try:
        tail = json.loads(buf[off:off + n].decode("utf-8"))
    except Exception as e:  # noqa: BLE001 - one error type for callers
        raise WireError("bad tail JSON: %s" % e)
    if not isinstance(tail, dict):
        raise WireError("tail must be a JSON object")
    return tail, off + n


def _header(kind: int, flags: int = 0) -> bytearray:
    return bytearray(MAGIC + bytes((VERSION, kind, flags, 0)))


def _parse_header(buf: bytes) -> Tuple[int, int, int]:
    """-> (kind, flags, offset past header)."""
    _need(buf, 0, 8)
    if buf[:4] != MAGIC:
        raise WireError("bad magic (not a columnar frame)")
    if buf[4] != VERSION:
        raise WireError("unsupported wire version %d" % buf[4])
    return buf[5], buf[6], 8


def is_wire(content_type: Optional[str]) -> bool:
    """Content-Type / Accept header match (parameters ignored)."""
    return bool(content_type) and content_type.split(";")[0].strip().lower() \
        == CONTENT_TYPE


# -- request codec ----------------------------------------------------------


def _num_state(vals: Sequence[Any]) -> int:
    """0 = all float, 1 = all int, 2 = mixed (bool never reaches here)."""
    n_int = sum(1 for v in vals if isinstance(v, int))
    if n_int == 0:
        return 0
    return 1 if n_int == len(vals) else 2


def _trace_tail(tr: dict, pts: list, mo_table: Dict[str, int],
                mo_list: List[Any], states: List[int],
                key: str) -> dict:
    """Per-trace non-columnar remainder (uuid, options ref, extras)."""
    t: Dict[str, Any] = {}
    if "uuid" in tr:
        t["u"] = tr["uuid"]
    if "match_options" in tr:
        mk = json.dumps(tr["match_options"], sort_keys=True, default=str)
        idx = mo_table.get(mk)
        if idx is None:
            idx = mo_table[mk] = len(mo_list)
            mo_list.append(tr["match_options"])
        t["o"] = idx
    extra = {k: v for k, v in tr.items()
             if k not in ("uuid", "match_options", key, "_columns")}
    if extra:
        t["x"] = extra
    drop = ("lat", "lon", "time") if states[3] == _ACC_SKIP \
        else ("lat", "lon", "time", "accuracy")
    pe = []
    for i, p in enumerate(pts):
        px = {k: v for k, v in p.items() if k not in drop}
        if px:
            pe.append([i, px])
    if pe:
        t["pe"] = pe
    mixed = {}
    for ci, col in enumerate(_REQ_COLS):
        if ci == 3 and states[3] == _ACC_SKIP:
            continue
        if states[ci] == 2:
            mixed[col] = [i for i, p in enumerate(pts)
                          if isinstance(p[col], int)]
    if mixed:
        t["ii"] = mixed
    return t


def _acc_column(pts: list) -> "Optional[List]":
    """The trace's accuracy values when columnar-carriable: present on
    EVERY point, all clean numerics.  None -> state 3 (tail spill)."""
    if not pts:
        return None
    vals = []
    for p in pts:
        v = p.get("accuracy")
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        if isinstance(v, int) and abs(v) >= _MAX_EXACT:
            return None
        vals.append(v)
    return vals


def encode_request(body: dict, key: str = "trace") -> bytes:
    """Encode a /report trace dict or a /trace_attributes_batch body.

    A bare trace dict (has ``key``, no "traces") encodes with FLAG_SINGLE.
    Raises WireError for bodies the columnar frame cannot carry exactly
    (non-numeric lat/lon/time, overlong arrays) — callers fall back to
    JSON.
    """
    single = "traces" not in body
    traces = [body] if single else body["traces"]
    if not isinstance(traces, list):
        raise WireError("traces must be a list")
    if len(traces) > _U32_MAX:
        raise WireError("too many traces")
    lens = np.zeros(len(traces), "<u4")
    numstate = np.zeros(4 * len(traces), np.uint8)
    lat_parts, lon_parts, time_parts, acc_parts = [], [], [], []
    t_tails: List[dict] = []
    mo_table: Dict[str, int] = {}
    mo_list: List[Any] = []
    for ti, tr in enumerate(traces):
        if not isinstance(tr, dict):
            raise WireError("trace %d is not an object" % ti)
        no_key = key not in tr
        pts = [] if no_key else tr[key]
        if not isinstance(pts, list):
            raise WireError("trace %d points is not a list" % ti)
        for p in pts:
            if not isinstance(p, dict):
                raise WireError("trace %d has a non-object point" % ti)
            for col in ("lat", "lon", "time"):
                v = p.get(col)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise WireError("trace %d: %s is not a number" % (ti, col))
                if isinstance(v, int) and abs(v) >= _MAX_EXACT:
                    raise WireError("trace %d: %s exceeds f64 exactness"
                                    % (ti, col))
        lens[ti] = len(pts)
        acc = _acc_column(pts)
        states = [_num_state([p[c] for p in pts])
                  for c in ("lat", "lon", "time")]
        states.append(_ACC_SKIP if acc is None else _num_state(acc))
        numstate[4 * ti: 4 * ti + 4] = states
        lat_parts.append(np.array([p["lat"] for p in pts], "<f8"))
        lon_parts.append(np.array([p["lon"] for p in pts], "<f8"))
        time_parts.append(np.array([float(p["time"]) for p in pts], "<f8"))
        if acc is not None:
            acc_parts.append(np.array([float(v) for v in acc], "<f8"))
        tt = _trace_tail(tr, pts, mo_table, mo_list, states, key)
        if no_key:
            tt["nk"] = 1
        t_tails.append(tt)
    tail: Dict[str, Any] = {"t": t_tails}
    if mo_list:
        tail["mo"] = mo_list
    if not single:
        extra = {k: v for k, v in body.items() if k != "traces"}
        if extra:
            tail["body"] = extra
    out = _header(KIND_REQUEST, FLAG_SINGLE if single else 0)
    out += struct.pack("<I", len(traces))
    out += lens.tobytes()
    out += numstate.tobytes()
    for parts in (lat_parts, lon_parts, time_parts, acc_parts):
        out += (np.concatenate(parts) if parts else
                np.zeros(0, "<f8")).tobytes()
    tail_b = json.dumps(tail, separators=(",", ":")).encode("utf-8")
    out += struct.pack("<I", len(tail_b)) + tail_b
    return bytes(out)


def _materialize_points(lat, lon, time, states, ii) -> list:
    """Rebuild the JSON-identical point dicts for one trace.  int-ness
    per column comes from the numstate byte (whole column) or the tail's
    exact index list (mixed)."""
    cols = []
    for ci, arr in enumerate((lat, lon, time)):
        vals = arr.tolist()
        if states[ci] == 1:
            vals = [int(v) for v in vals]
        elif states[ci] == 2:
            idx = (ii or {}).get(("lat", "lon", "time")[ci], [])
            for i in idx:
                if not 0 <= i < len(vals):
                    raise WireError("mixed-int index out of range")
                vals[i] = int(vals[i])
        cols.append(vals)
    return [{"lat": a, "lon": b, "time": c}
            for a, b, c in zip(cols[0], cols[1], cols[2])]


def decode_request(buf: bytes, key: str = "trace") -> dict:
    """Decode a kind-1 frame -> the JSON-equivalent body dict.

    Each trace dict additionally carries ``"_columns"``: {"lat","lon",
    "time"} float64 arrays over its points — the packer's zero-walk side
    channel.  Strip it before echoing a trace anywhere.
    """
    kind, flags, off = _parse_header(buf)
    if kind != KIND_REQUEST:
        raise WireError("expected request frame, got kind %d" % kind)
    n, off = _u32(buf, off)
    lens, off = _u32s(buf, off, n)
    total = int(lens.sum())
    numstate, off = _u8s(buf, off, 4 * n)
    lat, off = _f64s(buf, off, total)
    lon, off = _f64s(buf, off, total)
    time, off = _f64s(buf, off, total)
    acc_total = int(lens[numstate[3::4] != _ACC_SKIP].sum()) if n else 0
    acc, off = _f64s(buf, off, acc_total)
    tail, off = _tail(buf, off)
    t_tails = tail.get("t", [])
    if not isinstance(t_tails, list) or len(t_tails) != n:
        raise WireError("tail trace count mismatch")
    mo_list = tail.get("mo", [])
    traces = []
    pos = apos = 0
    for ti in range(n):
        ln = int(lens[ti])
        tl = t_tails[ti] if isinstance(t_tails[ti], dict) else {}
        states = numstate[4 * ti: 4 * ti + 4]
        tlat, tlon, ttime = (lat[pos:pos + ln], lon[pos:pos + ln],
                             time[pos:pos + ln])
        pos += ln
        pts = _materialize_points(tlat, tlon, ttime, states, tl.get("ii"))
        if states[3] != _ACC_SKIP:
            avals = acc[apos:apos + ln].tolist()
            apos += ln
            if states[3] == 1:
                avals = [int(v) for v in avals]
            elif states[3] == 2:
                for i in (tl.get("ii") or {}).get("accuracy", []):
                    if not 0 <= i < ln:
                        raise WireError("mixed-int index out of range")
                    avals[i] = int(avals[i])
            for p, v in zip(pts, avals):
                p["accuracy"] = v
        for i, px in tl.get("pe", []):
            if not (isinstance(i, int) and 0 <= i < ln
                    and isinstance(px, dict)):
                raise WireError("bad point-extra entry")
            pts[i].update(px)
        tr: Dict[str, Any] = {}
        if "u" in tl:
            tr["uuid"] = tl["u"]
        if not tl.get("nk"):
            tr[key] = pts
        if "o" in tl:
            oi = tl["o"]
            if not (isinstance(oi, int) and 0 <= oi < len(mo_list)):
                raise WireError("match_options index out of range")
            tr["match_options"] = mo_list[oi]
        if isinstance(tl.get("x"), dict):
            tr.update(tl["x"])
        tr["_columns"] = {"lat": np.asarray(tlat, np.float64),
                          "lon": np.asarray(tlon, np.float64),
                          "time": np.asarray(ttime, np.float64)}
        traces.append(tr)
    if flags & FLAG_SINGLE:
        return traces[0] if traces else {}
    body: Dict[str, Any] = {"traces": traces}
    if isinstance(tail.get("body"), dict):
        body.update(tail["body"])
    return body


def sniff_request(buf: bytes) -> List[dict]:
    """Router-side peek: per-trace {"uuid", "stream", "lat", "lon"}
    (lead point geo) WITHOUT materializing point dicts — the affinity /
    geo-ranking extraction for binary bodies."""
    kind, flags, off = _parse_header(buf)
    if kind != KIND_REQUEST:
        raise WireError("expected request frame, got kind %d" % kind)
    n, off = _u32(buf, off)
    lens, off = _u32s(buf, off, n)
    total = int(lens.sum())
    numstate, off = _u8s(buf, off, 4 * n)
    lat, off = _f64s(buf, off, total)
    lon, off = _f64s(buf, off, total)
    _, off = _f64s(buf, off, total)
    acc_total = int(lens[numstate[3::4] != _ACC_SKIP].sum()) if n else 0
    _, off = _f64s(buf, off, acc_total)
    tail, off = _tail(buf, off)
    t_tails = tail.get("t", [])
    if not isinstance(t_tails, list) or len(t_tails) != n:
        raise WireError("tail trace count mismatch")
    starts = np.cumsum(lens) - lens
    out = []
    for ti in range(n):
        tl = t_tails[ti] if isinstance(t_tails[ti], dict) else {}
        o = int(starts[ti])
        has = int(lens[ti]) > 0
        out.append({
            "uuid": tl.get("u"),
            "stream": bool((tl.get("x") or {}).get("stream")),
            "lat": float(lat[o]) if has else None,
            "lon": float(lon[o]) if has else None,
        })
    return out


# -- response codec ---------------------------------------------------------


def _encode_struct_list(items: List[dict], keys: Sequence[str],
                        extras: List[list], base: int) -> bytes:
    """items -> one (u8 states + f64 vals) column per key; non-scalar /
    oversized / unknown-key values append [base+i, {...}] to extras."""
    n = len(items)
    out = bytearray()
    spill: List[Dict[str, Any]] = [None] * n  # type: ignore[list-item]
    for key in keys:
        states = np.zeros(n, np.uint8)
        vals = np.zeros(n, "<f8")
        for i, it in enumerate(items):
            if key not in it:
                continue
            v = it[key]
            if v is None:
                states[i] = _NULL
            elif isinstance(v, bool):
                states[i] = _TRUE if v else _FALSE
            elif isinstance(v, int):
                if abs(v) >= _MAX_EXACT:
                    d = spill[i] = spill[i] or {}
                    d[key] = v
                    continue
                states[i] = _INT
                vals[i] = v
            elif isinstance(v, float):
                states[i] = _FLOAT
                vals[i] = v
            else:
                d = spill[i] = spill[i] or {}
                d[key] = v
        out += states.tobytes()
        out += vals.tobytes()
    known = set(keys)
    for i, it in enumerate(items):
        d = spill[i]
        for k, v in it.items():
            if k not in known:
                d = spill[i] = d or {}
                d[k] = v
        if d:
            extras.append([base + i, d])
    return bytes(out)


def _decode_struct_list(buf: bytes, off: int, total: int,
                        keys: Sequence[str]) -> Tuple[List[dict], int]:
    # the first column's states bound a lying count before the items are
    # allocated (the reference's check, made first)
    _need(buf, off, total)
    items: List[Dict[str, Any]] = [{} for _ in range(total)]
    for key in keys:
        states, off = _u8s(buf, off, total)
        vals, off = _f64s(buf, off, total)
        present = np.flatnonzero(states)
        for i in present.tolist():
            s = states[i]
            if s == _INT:
                items[i][key] = int(vals[i])
            elif s == _FLOAT:
                items[i][key] = float(vals[i])
            elif s == _NULL:
                items[i][key] = None
            elif s == _FALSE:
                items[i][key] = False
            elif s == _TRUE:
                items[i][key] = True
            else:
                raise WireError("bad value state %d" % s)
    return items, off


def _split_result(res: dict) -> Tuple[list, list, dict]:
    """result dict -> (segments, reports, rest).  Results without the
    expected shape (error payloads) ride whole in rest["raw"]."""
    sm = res.get("segment_matcher")
    ds = res.get("datastore")
    if (not isinstance(sm, dict) or not isinstance(sm.get("segments"), list)
            or not isinstance(ds, dict)
            or not isinstance(ds.get("reports"), list)):
        return [], [], {"raw": res}
    rest: Dict[str, Any] = {
        "sm": {k: v for k, v in sm.items() if k != "segments"},
        "ds": {k: v for k, v in ds.items() if k != "reports"},
    }
    x = {k: v for k, v in res.items()
         if k not in ("segment_matcher", "datastore")}
    if x:
        rest["x"] = x
    return sm["segments"], ds["reports"], rest


def encode_response(payload: dict, single: bool = False) -> bytes:
    """Encode a 200 payload: the /report report dict (``single=True``)
    or the batch {"results": [...]} body."""
    results = [payload] if single else payload.get("results")
    if not isinstance(results, list):
        raise WireError("payload has no results list")
    if len(results) > _U32_MAX:
        raise WireError("too many results")
    flags = FLAG_SINGLE if single else 0
    top = {} if single else {k: v for k, v in payload.items()
                             if k != "results"}
    if (payload if single else top).get("degraded"):
        flags |= FLAG_DEGRADED
    n = len(results)
    n_segs = np.zeros(n, "<u4")
    n_reps = np.zeros(n, "<u4")
    segs: List[dict] = []
    reps: List[dict] = []
    rests: List[dict] = []
    for i, res in enumerate(results):
        if not isinstance(res, dict):
            raise WireError("result %d is not an object" % i)
        s, r, rest = _split_result(res)
        if len(s) > _U32_MAX or len(r) > _U32_MAX:
            raise WireError("result %d too large" % i)
        n_segs[i] = len(s)
        n_reps[i] = len(r)
        segs.extend(s)
        reps.extend(r)
        rests.append(rest)
    for it in segs + reps:
        if not isinstance(it, dict):
            raise WireError("non-object segment/report record")
    seg_extras: List[list] = []
    rep_extras: List[list] = []
    out = _header(KIND_RESPONSE, flags)
    out += struct.pack("<I", n)
    out += n_segs.tobytes()
    out += n_reps.tobytes()
    out += _encode_struct_list(segs, SEG_KEYS, seg_extras, 0)
    out += _encode_struct_list(reps, REP_KEYS, rep_extras, 0)
    tail: Dict[str, Any] = {"r": rests}
    if seg_extras:
        tail["se"] = seg_extras
    if rep_extras:
        tail["re"] = rep_extras
    if top:
        tail["body"] = top
    tail_b = json.dumps(tail, separators=(",", ":")).encode("utf-8")
    out += struct.pack("<I", len(tail_b)) + tail_b
    return bytes(out)


def _apply_extras(items: List[dict], extras) -> None:
    if extras is None:
        return
    if not isinstance(extras, list):
        raise WireError("extras must be a list")
    for e in extras:
        if (not isinstance(e, list) or len(e) != 2
                or not isinstance(e[0], int)
                or not 0 <= e[0] < len(items)
                or not isinstance(e[1], dict)):
            raise WireError("bad extras entry")
        items[e[0]].update(e[1])


def decode_response(buf: bytes) -> dict:
    """Decode a kind-2 frame -> the JSON-equivalent payload dict."""
    kind, flags, off = _parse_header(buf)
    if kind != KIND_RESPONSE:
        raise WireError("expected response frame, got kind %d" % kind)
    n, off = _u32(buf, off)
    n_segs, off = _u32s(buf, off, n)
    n_reps, off = _u32s(buf, off, n)
    segs, off = _decode_struct_list(buf, off, int(n_segs.sum()), SEG_KEYS)
    reps, off = _decode_struct_list(buf, off, int(n_reps.sum()), REP_KEYS)
    tail, off = _tail(buf, off)
    _apply_extras(segs, tail.get("se"))
    _apply_extras(reps, tail.get("re"))
    rests = tail.get("r", [])
    if not isinstance(rests, list) or len(rests) != n:
        raise WireError("tail result count mismatch")
    results = []
    so = ro = 0
    for i in range(n):
        rest = rests[i] if isinstance(rests[i], dict) else {}
        ns, nr = int(n_segs[i]), int(n_reps[i])
        if "raw" in rest:
            results.append(rest["raw"])
            so += ns
            ro += nr
            continue
        res: Dict[str, Any] = {}
        if isinstance(rest.get("x"), dict):
            res.update(rest["x"])
        sm = dict(rest.get("sm") or {})
        sm["segments"] = segs[so:so + ns]
        res["segment_matcher"] = sm
        ds = dict(rest.get("ds") or {})
        ds["reports"] = reps[ro:ro + nr]
        res["datastore"] = ds
        so += ns
        ro += nr
        results.append(res)
    if flags & FLAG_SINGLE:
        return results[0] if results else {}
    body: Dict[str, Any] = {}
    if isinstance(tail.get("body"), dict):
        body.update(tail["body"])
    body["results"] = results
    return body


def response_degraded(buf: bytes) -> bool:
    """Header-only degraded peek (the router's byte-sniff equivalent for
    binary response bodies)."""
    try:
        kind, flags, _ = _parse_header(buf)
    except WireError:
        return False
    return kind == KIND_RESPONSE and bool(flags & FLAG_DEGRADED)
