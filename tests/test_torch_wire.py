"""The port's binary columnar wire (``reporter_tpu_torch.serve.wire``)
against the JAX package's (``reporter_tpu.serve.wire``), on the CPU:
request and response frames byte-identical over seeded bodies, each side
decoding the other's frames to equal dicts (the ``_columns`` side channel's
arrays too), the router's peeks, and every malformed frame refused with
``WireError`` by both.  Every comparison is exact."""

import json
import struct

import numpy as np
import pytest

from reporter_tpu.serve import wire as ref_wire
from reporter_tpu_torch.serve import wire

N_BODIES = 220


def _num(rng, kind, lo, hi):
    """A value of ``kind``: 0 float, 1 int, 2 either (mixed columns)."""
    if kind == 2:
        kind = int(rng.integers(0, 2))
    v = float(rng.uniform(lo, hi))
    return int(v) if kind == 1 else v


def _point(rng, j, kinds, acc_mode):
    p = {"lat": _num(rng, kinds[0], -90, 90), "lon": _num(rng, kinds[1], -180, 180),
         "time": (1_460_000_000 + 15 * j) if kinds[2] == 1 else
         (1_460_000_000 + 15 * j + float(rng.uniform(0, 1))) if kinds[2] == 0 else
         (1_460_000_000 + 15 * j + (0 if rng.integers(0, 2) else 0.5))}
    if acc_mode == "uniform int":
        p["accuracy"] = int(rng.integers(1, 30))
    elif acc_mode == "uniform float":
        p["accuracy"] = float(rng.uniform(1, 30))
    elif acc_mode == "mixed":
        p["accuracy"] = int(rng.integers(1, 30)) if rng.integers(0, 2) else 7.25
    elif acc_mode == "irregular" and rng.integers(0, 2):
        p["accuracy"] = int(rng.integers(1, 30)) if rng.integers(0, 2) else "high"
    if rng.integers(0, 6) == 0:  # point extras ride the tail
        p["heading"] = int(rng.integers(0, 360))
    if rng.integers(0, 12) == 0:
        p["speed"] = None
    return p


def _trace(rng, i):
    n = int(rng.integers(0, 14))
    kinds = [int(rng.integers(0, 3)) for _ in range(3)]
    acc_mode = ("none", "uniform int", "uniform float", "mixed", "irregular")[
        int(rng.integers(0, 5))]
    tr = {"trace": [_point(rng, j, kinds, acc_mode) for j in range(n)]}
    if rng.integers(0, 5):
        tr["uuid"] = "véh-Ω-%d" % i if rng.integers(0, 2) else i
    if rng.integers(0, 3):
        mo = {"mode": "auto", "report_levels": [0, 1], "transition_levels": [0, 1]}
        if rng.integers(0, 2):
            mo["sigma_z"] = float(rng.uniform(2, 9))
        tr["match_options"] = mo
    if rng.integers(0, 4) == 0:
        tr["stream"] = True
    if rng.integers(0, 5) == 0:
        tr["vehicle_class"] = {"kind": "bus", "axles": 2}  # an unknown key
    if rng.integers(0, 9) == 0:
        del tr["trace"]  # a trace without its points key round-trips
    return tr


def request_bodies(seed=0, n=N_BODIES):
    """Seeded /trace_attributes_batch bodies and bare /report traces."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 4 == 3:
            tr = _trace(rng, k)
            tr.setdefault("trace", [])
            out.append(tr)
            continue
        body = {"traces": [_trace(rng, i) for i in range(int(rng.integers(0, 7)))]}
        if rng.integers(0, 4) == 0:
            body["client"] = "fleet-%d" % k
        out.append(body)
    return out


def _canon(body):
    """(JSON text without the side channel, {trace index: columns})."""
    traces = body["traces"] if "traces" in body else [body]
    cols = {i: t.pop("_columns") for i, t in enumerate(traces) if "_columns" in t}
    return json.dumps(body, sort_keys=True), cols


def _cols_equal(a, b):
    assert a.keys() == b.keys()
    for i in a:
        assert a[i].keys() == b[i].keys() == {"lat", "lon", "time"}
        for k in a[i]:
            assert a[i][k].dtype == b[i][k].dtype == np.float64
            np.testing.assert_array_equal(a[i][k], b[i][k])


def test_request_frames_byte_identical_and_cross_decode():
    n_int_time = n_mixed = n_acc = 0
    for body in request_bodies():
        frame = wire.encode_request(json.loads(json.dumps(body)))
        assert frame == ref_wire.encode_request(json.loads(json.dumps(body)))
        got, got_cols = _canon(wire.decode_request(frame))
        want, want_cols = _canon(ref_wire.decode_request(frame))
        assert got == want == json.dumps(body, sort_keys=True)
        _cols_equal(got_cols, want_cols)
        assert wire.sniff_request(frame) == ref_wire.sniff_request(frame)
        n = struct.unpack_from("<I", frame, 8)[0]
        states = np.frombuffer(frame, np.uint8, 4 * n, 12 + 4 * n)
        n_int_time += int((states[2::4] == 1).sum())
        n_mixed += sum(int((states[c::4] == 2).sum()) for c in range(3))
        n_acc += int((states[3::4] != 3).sum())
    # the seeded bodies reach every column state
    assert n_int_time and n_mixed and n_acc


def test_single_trace_flag_and_sniff():
    tr = {"uuid": "a", "stream": True, "trace": [{"lat": 1.5, "lon": 2, "time": 3}]}
    frame = wire.encode_request(tr)
    assert frame == ref_wire.encode_request(tr)
    assert frame[6] & wire.FLAG_SINGLE
    assert wire.sniff_request(frame) == ref_wire.sniff_request(frame) == [
        {"uuid": "a", "stream": True, "lat": 1.5, "lon": 2.0}]
    empty = wire.encode_request({"traces": [{"uuid": "e", "trace": []}]})
    assert wire.sniff_request(empty) == ref_wire.sniff_request(empty)


@pytest.mark.parametrize("bad", [
    {"traces": [{"trace": [{"lat": "1", "lon": 2.0, "time": 3}]}]},
    {"traces": [{"trace": [{"lat": True, "lon": 2.0, "time": 3}]}]},
    {"traces": [{"trace": [{"lat": 1.0, "lon": 2.0, "time": 1 << 53}]}]},
    {"traces": [{"trace": [{"lat": 1.0, "lon": 2.0}]}]},
    {"traces": [{"trace": [[1.0, 2.0, 3]]}]},
    {"traces": [{"trace": {"lat": 1.0}}]},
    {"traces": ["not an object"]},
    {"traces": {"0": {}}},
])
def test_encode_refuses_what_a_frame_cannot_carry(bad):
    with pytest.raises(ref_wire.WireError) as want:
        ref_wire.encode_request(bad)
    with pytest.raises(wire.WireError) as got:
        wire.encode_request(bad)
    assert str(got.value) == str(want.value)


def _segment(rng):
    s = {}
    for k in wire.SEG_KEYS:
        r = int(rng.integers(0, 9))
        if r == 0:
            continue  # absent
        s[k] = (None if r == 1 else bool(rng.integers(0, 2)) if r == 2
                else int(rng.integers(-5, 1 << 40)) if r in (3, 4)
                else float(rng.uniform(-1e3, 1e9)) if r in (5, 6)
                else (1 << 60) + int(rng.integers(0, 99)) if r == 7 else "x%d" % r)
    if rng.integers(0, 5) == 0:
        s["way_ids"] = [int(rng.integers(0, 1 << 33)) for _ in range(3)]
    return s


def _report(rng):
    r = {k: (int(rng.integers(0, 1 << 45)) if k in ("id", "next_id")
             else float(rng.uniform(1.4e9, 1.5e9)) if k in ("t0", "t1")
             else int(rng.integers(0, 900)) if rng.integers(0, 2) else float(rng.uniform(0, 900)))
         for k in wire.REP_KEYS if rng.integers(0, 6)}
    if rng.integers(0, 6) == 0:
        r["next_id"] = None
    return r


def _result(rng):
    if rng.integers(0, 12) == 0:
        return {"error": "trace failed", "code": 500}  # rides whole in the tail
    res = {"segment_matcher": {"mode": "auto",
                               "segments": [_segment(rng) for _ in range(int(rng.integers(0, 8)))]},
           "datastore": {"mode": "auto",
                         "reports": [_report(rng) for _ in range(int(rng.integers(0, 6)))]},
           "stats": {"successful_matches": int(rng.integers(0, 9)), "match_ms": 1.25}}
    if rng.integers(0, 3) == 0:
        res["shape_used"] = int(rng.integers(0, 64))
    if rng.integers(0, 6) == 0:
        res["session"] = {"seq": 2, "points_total": 8}
    return res


def response_payloads(seed=1, n=N_BODIES):
    """Seeded (payload, single) pairs: batch bodies and bare reports."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 3 == 2:
            res = _result(rng)
            if rng.integers(0, 4) == 0:
                res["degraded"] = True
            out.append((res, True))
            continue
        body = {"results": [_result(rng) for _ in range(int(rng.integers(0, 6)))]}
        if rng.integers(0, 4) == 0:
            body["degraded"] = True
        out.append((body, False))
    return out


def test_response_frames_byte_identical_and_cross_decode():
    n_degraded = 0
    for payload, single in response_payloads():
        frame = wire.encode_response(json.loads(json.dumps(payload)), single=single)
        assert frame == ref_wire.encode_response(json.loads(json.dumps(payload)),
                                                 single=single)
        want = json.dumps(payload, sort_keys=True)
        assert json.dumps(wire.decode_response(frame), sort_keys=True) == want
        assert json.dumps(ref_wire.decode_response(frame), sort_keys=True) == want
        flag = wire.response_degraded(frame)
        assert flag == ref_wire.response_degraded(frame)
        n_degraded += flag
    assert n_degraded
    assert wire.response_degraded(b"junk") is ref_wire.response_degraded(b"junk") is False


def test_response_refusals_agree():
    for bad, single in (({"results": "x"}, False), ({"results": [1]}, False),
                        ({"results": [{"segment_matcher": {"segments": [1]},
                                       "datastore": {"reports": []}}]}, False)):
        with pytest.raises(ref_wire.WireError):
            ref_wire.encode_response(bad, single=single)
        with pytest.raises(wire.WireError):
            wire.encode_response(bad, single=single)


def _refused_alike(buf, decode, ref_decode):
    with pytest.raises(ref_wire.WireError) as want:
        ref_decode(buf)
    with pytest.raises(wire.WireError) as got:
        decode(buf)
    assert str(got.value) == str(want.value)


def test_every_truncation_refused_alike():
    rng = np.random.default_rng(5)
    req = wire.encode_request({"traces": [_trace(rng, i) for i in range(3)]
                               + [{"uuid": "u", "trace": [{"lat": 1.0, "lon": 2.0,
                                                           "time": 3, "accuracy": 4}]}]})
    resp = wire.encode_response({"results": [_result(rng) for _ in range(3)]})
    for frame, dec, ref_dec in ((req, wire.decode_request, ref_wire.decode_request),
                                (req, wire.sniff_request, ref_wire.sniff_request),
                                (resp, wire.decode_response, ref_wire.decode_response)):
        for cut in range(len(frame)):
            _refused_alike(frame[:cut], dec, ref_dec)
        assert dec(frame) is not None


def test_lying_lengths_and_bad_headers_refused_alike():
    req = wire.encode_request({"traces": [{"uuid": "a", "trace": [
        {"lat": 1.0, "lon": 2.0, "time": 3}, {"lat": 1.5, "lon": 2.5, "time": 4}]}]})
    resp = wire.encode_response({"results": [{"segment_matcher": {"segments": [{"length": 3}]},
                                              "datastore": {"reports": []}}]})
    cases = []
    for frame, dec, ref_dec in ((req, wire.decode_request, ref_wire.decode_request),
                                (resp, wire.decode_response, ref_wire.decode_response)):
        # n and the first length each set to a lie (the JAX package's
        # response decode allocates a lying segment count's items before
        # it checks them: test_lying_segment_count_refused_before_allocation)
        req = dec is wire.decode_request
        for off in ((8, 12) if req else (8,)):
            for lie in ((0xFFFFFFFF, 1 << 20, 7) if req else (0xFFFFFFFF, 1 << 20)):
                cases.append((frame[:off] + struct.pack("<I", lie) + frame[off + 4:],
                              dec, ref_dec))
        cases.append((frame + b"\x00", dec, ref_dec))
        cases.append((b"XPTC" + frame[4:], dec, ref_dec))      # magic
        cases.append((frame[:4] + b"\x02" + frame[5:], dec, ref_dec))  # version
        cases.append((frame[:5] + bytes([3 - frame[5]]) + frame[6:], dec, ref_dec))  # kind
    # a tail count that disagrees with n, a tail that is not an object, a
    # bad value state, out-of-range indices in the tail
    body = {"traces": [{"uuid": "a", "trace": [{"lat": 1.0, "lon": 2.0, "time": 3}]}]}
    frame = wire.encode_request(body)
    head, tail = _split_tail(frame)
    for t in ({"t": []}, [1], {"t": [{"ii": {"time": [5]}}]}, {"t": [{"o": 3}]},
              {"t": [{"pe": [[9, {"x": 1}]]}]}):
        cases.append((_with_tail(head, t), wire.decode_request, ref_wire.decode_request))
    cases.append((head + struct.pack("<I", 3) + b"{{{", wire.decode_request,
                  ref_wire.decode_request))
    rf = bytearray(resp)
    rf[20] = 9  # the first segment's "length" state
    cases.append((bytes(rf), wire.decode_response, ref_wire.decode_response))
    rhead, _rt = _split_tail(resp)
    for t in ({"r": []}, {"r": [{}], "se": [[5, {}]]}, {"r": [{}], "re": "x"}):
        cases.append((_with_tail(rhead, t), wire.decode_response, ref_wire.decode_response))
    for buf, dec, ref_dec in cases:
        try:
            want = ref_dec(buf)
        except ref_wire.WireError as e:
            _refused_alike(buf, dec, ref_dec)
            assert str(e)
        else:  # a lie the frame happens to carry decodes alike
            assert json.dumps(_strip(dec(buf)), sort_keys=True) == \
                json.dumps(_strip(want), sort_keys=True)


def test_lying_segment_count_refused_before_allocation():
    """A response frame whose per-result segment or report count lies is
    refused before its items are allocated: the port checks the first
    column's extent first (the reference makes the same check after
    allocating ``total`` dicts, 4 * 10^9 for this frame, so it is not run
    here)."""
    resp = wire.encode_response({"results": [{"segment_matcher": {"segments": [{"length": 3}]},
                                              "datastore": {"reports": []}}]})
    for off in (12, 16):
        bad = resp[:off] + struct.pack("<I", 0xFFFFFFFF) + resp[off + 4:]
        with pytest.raises(wire.WireError, match="frame truncated at offset"):
            wire.decode_response(bad)


def _split_tail(frame):
    n = None
    for cut in range(len(frame) - 4, 7, -1):
        n = struct.unpack_from("<I", frame, cut)[0]
        if cut + 4 + n == len(frame):
            try:
                json.loads(frame[cut + 4:])
            except ValueError:
                continue
            return frame[:cut], frame[cut + 4:]
    raise AssertionError("no tail")


def _with_tail(head, tail):
    b = json.dumps(tail).encode()
    return head + struct.pack("<I", len(b)) + b


def _strip(body):
    if isinstance(body, dict):
        for t in body.get("traces", [body]):
            if isinstance(t, dict):
                t.pop("_columns", None)
    return body


def test_is_wire():
    for ct in (None, "", "application/json", "application/x-reporter-columnar",
               "Application/X-Reporter-Columnar; charset=binary", "text/plain"):
        assert wire.is_wire(ct) == ref_wire.is_wire(ct)
    assert (wire.CONTENT_TYPE, wire.MAGIC, wire.VERSION, wire.SEG_KEYS, wire.REP_KEYS) == (
        ref_wire.CONTENT_TYPE, ref_wire.MAGIC, ref_wire.VERSION, ref_wire.SEG_KEYS,
        ref_wire.REP_KEYS)
