"""Chip smoke run of the PyTorch/CUDA port (``reporter_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the five CUDA kernels of the match program (one nvcc per source,
sm_90a, all started together) and the native host core, builds the
metro-scale grid city (120 x 120 blocks of 150 m, UBODT delta 3000 m,
cuckoo layout) and moves it to the card, then:

  1. holds each of kernels 1-4 against its plain PyTorch version on the
     card at both of the bucketed path's shapes (B=512, T=64 from
     TraceSynthesizer(seed=7) and B=128, T=256 from seed 8; K=8), and at
     512 x 64 times both with CUDA events beside the kernel's bound;
  2. holds kernel 5 (the chain) against its plain version at the long
     path's shape (64 x 256, the second window of 64 traces of 2,048
     points from seed 9, continuing the first window's carries) and at
     the session shape (512 x 4 against a 65,536-slot slab: continuing,
     fresh and padding rows), and times both;
  3. drives each path through the launch counters (every count set to 0
     just before, read just after): the bucketed path,
     ``SegmentMatcher(device="cuda").match_many`` over the 512 x 64 and
     128 x 256 cohorts, each held against the plain versions' composition;
     the long path, ``match_many`` over the 64 x 2,048 cohort (8 windows
     of 256), held window by window against the plain composition; the
     session path, the 512 x 64 cohort streamed as 512 sessions in 16
     steps of 4 points through ``SessionEngine`` with the session slab,
     held bit for bit against the host-carry path and against the long
     path of a matcher with 4-point windows;
  4. serves 8 /report requests, one 2,048-point /report and 8 vehicles'
     streaming submits on the metro city, then replays the 6 recorded
     /report fixtures on the 8 x 8 fixture grid and diffs them against
     the recorded responses.

Prints the card's name and power limit, one line per phase, a
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without CUDA it exits non-zero before printing any result.  Details go to
build/chip_smoke.json.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# published H100 SXM peaks the bounds are taken against: HBM bytes/s, and
# float32 operations/s outside the tensor cores (every kernel here is
# scalar float32/int32 work)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


_FLUSH = []


def time_ms(fn, reps=20, warmup=3, cold_l2=False, queued=True):
    """Median device time of one call of ``fn`` over ``reps`` calls, in ms,
    from CUDA events.

    With ``queued`` the calls are enqueued behind a spin kernel, so the
    host's work in each call (output allocation, argument checks, the
    ctypes call) runs while the card spins and none of it lands between
    the events; the spin is lengthened until the card is still spinning
    when the last call has been enqueued.  Without ``cold_l2`` the calls
    run back to back with an event between each two.  With it, a write of
    a 256 MB buffer (five times the L2) precedes each call and an event
    pair brackets the call alone, for a kernel whose main-path inputs are
    cold in L2.  ``queued=False`` (the plain versions, whose many small
    ops are launch-bound on the host) lets the host's gaps count, as they
    do for a caller."""
    import torch

    if cold_l2 and not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device="cuda"))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000  # ~25 ms at the H100's clock
    for _attempt in range(4):
        if queued:
            torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        if cold_l2:
            pairs = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
            for a, b in pairs:
                _FLUSH[0].zero_()
                a.record()
                fn()
                b.record()
        else:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
            marks[0].record()
            for m in marks[1:]:
                fn()
                m.record()
            pairs = list(zip(marks, marks[1:]))
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead or not queued:
            return statistics.median(a.elapsed_time(b) for a, b in pairs)
        cycles *= 4
    raise RuntimeError("timing: the host did not get ahead of the card")


def max_abs_err(pairs):
    """Largest |kernel - plain| over every output (equal entries, infinities
    included, count 0)."""
    import torch

    worst = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs()
        d = torch.where(a == b, torch.zeros_like(d), d)
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build():
    from reporter_tpu_torch import native
    from reporter_tpu_torch._build import build_all
    from reporter_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    out = build_all({**_kernels.build_jobs(), **native.build_jobs()})
    _kernels.build_kernels()  # binds (nothing stale left to build)
    native.require_lib()
    dt = time.perf_counter() - t0
    print("build: %d libraries in %.1f s (nvcc sm_90a + g++, in parallel)"
          % (len(out), dt))
    for lib, text in sorted(out.items()):
        regs = [ln.split("ptxas info    :")[-1].strip() for ln in text.splitlines()
                if "registers" in ln]
        if regs:
            print("  %s: %s" % (os.path.basename(lib), "; ".join(regs)))
    return dt


def metro_city(rows, device):
    from reporter_tpu_torch import native
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.network import grid_city
    from reporter_tpu_torch.tiles.ubodt import build_ubodt

    t0 = time.perf_counter()
    arrays = build_graph_arrays(grid_city(rows, rows, spacing_m=150.0), cell_size=100.0)
    t1 = time.perf_counter()
    lib = native.require_lib() if device.type == "cuda" else None
    ubodt = build_ubodt(arrays, delta=3000.0, lib=lib)
    t2 = time.perf_counter()
    matcher = SegmentMatcher(arrays=arrays, ubodt=ubodt,
                             config=MatcherConfig(quality_aux=True), device=device)
    t3 = time.perf_counter()
    info = {
        "grid": "%dx%d blocks of 150 m" % (rows, rows),
        "nodes": arrays.num_nodes, "edges": arrays.num_edges,
        "cell_rows_cap": int(arrays.grid_items.shape[1]),
        "ubodt_rows": int(ubodt.num_rows), "ubodt_buckets": int(ubodt.n_buckets),
        "ubodt_mb": ubodt.packed.nbytes / 1e6,
        "graph_s": t1 - t0, "ubodt_s": t2 - t1, "to_device_s": t3 - t2,
    }
    print("metro city: %(grid)s, %(nodes)d nodes, %(edges)d edges, UBODT "
          "%(ubodt_rows)d rows in %(ubodt_buckets)d buckets = %(ubodt_mb).1f MB "
          "(graph %(graph_s).1f s, ubodt %(ubodt_s).1f s, to card "
          "%(to_device_s).1f s)" % info)
    return matcher, info


def cohort(matcher, seed, n, T):
    from reporter_tpu_torch.synth import TraceSynthesizer

    t0 = time.perf_counter()
    traces = [s.trace for s in TraceSynthesizer(matcher.arrays, seed=seed).batch(
        n, T, dt=5.0, sigma=5.0, max_tries=100)]
    print("cohort %dx%d synthesized in %.1f s" % (n, T, time.perf_counter() - t0))
    return traces


def bucket_rows(matcher, traces, T):
    """The bucketed path's packed [4, B, T] input of a cohort, on the card."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    px, py, tm, valid, _times = matcher._fill_rows(traces, list(range(len(traces))), T)
    return torch.from_numpy(V.pack_inputs(px, py, tm, valid)).to(matcher.device)


def session_rows(matcher, traces, j, Wn=4, pad=16):
    """A session step's packed [4, B + pad, Wn] input: each trace's points
    j .. j+Wn as the session packer lays them out, then ``pad``
    all-invalid rows."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    items = [{"points": tr["trace"][j:j + Wn], "t0": tr["trace"][0]["time"]}
             for tr in traces]
    px, py, tm, valid, _n = matcher._fill_session_rows(items, range(len(traces)), Wn)
    return torch.from_numpy(V.pack_inputs(*(np.concatenate(
        [a, np.zeros((pad, Wn), a.dtype)]) for a in (px, py, tm, valid)))).to(matcher.device)


def kernel_phases(matcher, xin, timed):
    """Each kernel against its plain version at one of the main path's
    shapes (the packed [4, B, T] input ``xin``): the full call's every
    output, and the main path's call (which skips the outputs the scan
    never reads) equal to the full call on what it returns.  ``timed``:
    also time the main path's call of each kernel and of its plain
    version, beside the bound of that call's work."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops.candidates import candidate_sweep, candidate_sweep_plain
    from reporter_tpu_torch.ops.hashtable import (
        device_pair_hash, device_pair_hash2, ubodt_lookup, ubodt_lookup_plain,
    )

    dev = matcher.device
    B, T = xin.shape[1], xin.shape[2]
    K = matcher.cfg.beam_k
    x, y, t, v = V.unpack_inputs(xin)
    px, py = x.cpu().numpy(), y.cpu().numpy()
    dg, du, p = matcher._dg, matcher._du, matcher._params
    rows = []

    def same(got, full, what):
        check(all(torch.equal(u, w) for u, w in zip(got, full)),
              what + ": the main path's call equals the full call")

    # kernel 1: candidate sweep (+ emission, edge-row node ids)
    args1 = (dg, x, y, v, K, p.search_radius, p.sigma_z)
    s1 = candidate_sweep(*args1)
    s0 = candidate_sweep_plain(*args1)
    check(torch.equal(s1.cand.edge, s0.cand.edge), "candidate_sweep edge")
    check(torch.equal(s1.to_node, s0.to_node) and torch.equal(s1.from_node, s0.from_node),
          "candidate_sweep node ids")
    for f in ("dist", "offset", "cx", "cy"):
        check(torch.allclose(getattr(s1.cand, f), getattr(s0.cand, f), rtol=0, atol=1e-4,
                             equal_nan=False), "candidate_sweep " + f)
    check(torch.allclose(s1.emis, s0.emis, rtol=1e-6, atol=0), "candidate_sweep emis")
    err1 = max_abs_err([(getattr(s1.cand, f), getattr(s0.cand, f))
                        for f in ("edge", "offset", "dist", "cx", "cy")]
                       + [(s1.emis, s0.emis), (s1.to_node, s0.to_node)])
    lean1 = candidate_sweep(*args1, full=False)
    same([lean1.cand.edge, lean1.cand.offset, lean1.emis, lean1.to_node, lean1.from_node],
         [s1.cand.edge, s1.cand.offset, s1.emis, s1.to_node, s1.from_node],
         "candidate_sweep")
    cap = dg.cap
    fx = (px - np.float32(dg.grid_x0)) / np.float32(dg.cell_size)
    fy = (py - np.float32(dg.grid_y0)) / np.float32(dg.cell_size)
    cx0 = np.clip(np.floor(fx).astype(np.int64), 0, dg.grid_nx - 1)
    cy0 = np.clip(np.floor(fy).astype(np.int64), 0, dg.grid_ny - 1)
    sx = np.where(fx - np.floor(fx) >= 0.5, 1, -1)
    sy = np.where(fy - np.floor(fy) >= 0.5, 1, -1)
    cells = set()
    for ccy in (cy0, np.clip(cy0 + sy, 0, dg.grid_ny - 1)):
        for ccx in (cx0, np.clip(cx0 + sx, 0, dg.grid_nx - 1)):
            cells.update((ccy * dg.grid_nx + ccx).ravel().tolist())
    n_edges = int(torch.unique(s1.cand.edge[s1.cand.edge >= 0]).numel())
    P = B * T
    # reads: px, py, valid, each distinct cell row once, the two node lanes
    # of each distinct candidate edge; writes: the 5 [P, K] outputs the
    # main path keeps (edge, offset, emis, to/from node).  ~30 float
    # operations per shape segment of the 4*cap swept.
    b1, by1 = bound(12 * P + len(cells) * 32 * cap + 8 * n_edges + 20 * P * K,
                    30 * 4 * cap * P)
    rows.append(dict(name="candidate_sweep", route="cuda",
                     source="reporter_tpu_torch/csrc/candidate_sweep.cu",
                     replaces="reporter_tpu/ops/candidates.py:88",
                     tolerance="edge, node ids exact; dist/offset/cx/cy atol 1e-4; emis rtol 1e-6",
                     fn=lambda: candidate_sweep(*args1, full=False),
                     plain=lambda: candidate_sweep_plain(*args1, full=False), cold_l2=True,
                     max_abs_err=err1, bound_ms=b1, bound_by=by1))

    # kernel 2: UBODT probe over the [B, T-1, K, K] key grid
    a_keys = s1.to_node[:, :-1, :, None]
    b_keys = s1.from_node[:, 1:, None, :]
    r1 = ubodt_lookup(du, a_keys, b_keys)
    r0 = ubodt_lookup_plain(du, a_keys, b_keys)
    check(all(torch.equal(u, w) for u, w in zip(r1, r0)), "ubodt_probe")
    err2 = max_abs_err(zip(r1, r0))
    same(ubodt_lookup(du, a_keys, b_keys, with_first=False)[:2], r1[:2], "ubodt_probe")
    ka, kb = torch.broadcast_tensors(a_keys, b_keys)
    buckets = torch.unique(torch.cat([device_pair_hash(ka.reshape(-1), kb.reshape(-1), du.bmask),
                                      device_pair_hash2(ka.reshape(-1), kb.reshape(-1), du.bmask)]))
    N = ka.numel()
    hit = float(torch.isfinite(r1[0]).float().mean())
    # reads: the two [B, T, K] key arrays, each distinct 512-byte bucket
    # row once; writes: dist and time (the main path skips first_edge).
    # ~40 integer operations per probe.
    b2, by2 = bound(8 * P * K + 512 * int(buckets.numel()) + 8 * N, 40 * N)
    rows.append(dict(name="ubodt_probe", route="cuda",
                     source="reporter_tpu_torch/csrc/ubodt_probe.cu",
                     replaces="reporter_tpu/ops/hashtable.py:138",
                     tolerance="exact",
                     fn=lambda: ubodt_lookup(du, a_keys, b_keys, with_first=False),
                     plain=lambda: ubodt_lookup_plain(du, a_keys, b_keys, with_first=False),
                     cold_l2=True, max_abs_err=err2, bound_ms=b2, bound_by=by2,
                     probes=N, distinct_rows=int(buckets.numel()), hit_rate=hit))

    # kernel 3: transition build
    args3 = (dg, s1.cand, x, y, t, r1[0], r1[1], p)
    l1 = V.transition_build(*args3)
    l0 = V.transition_build_plain(*args3)
    for name, u, w in zip(("logp", "route", "gc"), l1, l0):
        check(torch.allclose(u, w, rtol=1e-6, atol=0), "transition_build " + name)
    err3 = max_abs_err(zip(l1, l0))
    lean3 = V.transition_build(*args3, with_route=False)
    same([lean3[0], lean3[2]], [l1[0], l1[2]], "transition_build")
    # reads: candidate edge + offset, px/py/times, probe dist + time, the
    # distinct candidate edges' rows; writes: logp and gc (the main path
    # skips route).  ~45 float operations per (t, i, j).
    b3, by3 = bound(8 * P * K + 12 * P + 8 * N + 32 * n_edges + 4 * N + 4 * B * (T - 1),
                    45 * N)
    rows.append(dict(name="transition_build", route="cuda",
                     source="reporter_tpu_torch/csrc/transition_build.cu",
                     replaces="reporter_tpu/ops/viterbi.py:196",
                     tolerance="rtol 1e-6",
                     fn=lambda: V.transition_build(*args3, with_route=False),
                     plain=lambda: V.transition_build_plain(*args3, with_route=False),
                     cold_l2=False, max_abs_err=err3, bound_ms=b3, bound_by=by3))

    # kernel 4: scan recursion, backtrace, compact gather, confidence
    args4 = (s1.emis, l1[0], l1[2], v, s1.cand.edge, s1.cand.offset, p.breakage_distance)
    k4 = V.viterbi_scan(*args4)
    k0 = V.viterbi_scan_plain(*args4)
    check(torch.equal(k4[0], k0[0]), "viterbi_scan packed")
    check(torch.allclose(k4[1], k0[1], rtol=1e-4, atol=0), "viterbi_scan aux")
    err4 = max_abs_err([(k4[0], k0[0])])
    # reads: emis, logp, gc, valid, the chosen slot's edge + offset and the
    # last slot's edge per point; writes: packed + aux.  2 K^2 float
    # operations (add, compare) per step.
    b4, by4 = bound(4 * P * K + 4 * N + 4 * B * (T - 1) + 4 * P + 12 * P + 12 * P + 16 * B,
                    2 * N)
    rows.append(dict(name="viterbi_scan", route="cuda",
                     source="reporter_tpu_torch/csrc/viterbi_scan.cu",
                     replaces="reporter_tpu/ops/viterbi.py:447",
                     tolerance="packed exact; aux rtol 1e-4",
                     fn=lambda: V.viterbi_scan(*args4),
                     plain=lambda: V.viterbi_scan_plain(*args4), cold_l2=False,
                     max_abs_err=err4, bound_ms=b4, bound_by=by4,
                     aux_max_abs_err=max_abs_err([(k4[1], k0[1])])))

    if timed and dev.type == "cuda":
        for r in rows:
            r["ms"] = time_ms(r["fn"], cold_l2=r["cold_l2"])
            r["plain_ms"] = time_ms(r["plain"], cold_l2=r["cold_l2"], queued=False)
    for r in rows:
        print("kernel %-17s %dx%d max_abs_err=%-9.3g kernel_ms=%s plain_ms=%s "
              "bound_ms=%.4f (%s) within tolerance: %s"
              % (r["name"], B, T, r["max_abs_err"],
                 "%.4f" % r["ms"] if "ms" in r else "-",
                 "%.4f" % r["plain_ms"] if "plain_ms" in r else "-", r["bound_ms"],
                 r["bound_by"], r["tolerance"]))
    return rows


def _carry_same(a, b):
    """Every leaf of two TraceCarry equal byte for byte."""
    return all(x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
               for x, y in zip(a, b))


def _seam_rows(dg, du, carry_edge, first_edge):
    """Distinct UBODT bucket rows and edge rows the seam transitions of a
    batch read: the probes (to(carry edge i), from(first candidate j))."""
    import torch

    from reporter_tpu_torch.ops.hashtable import device_pair_hash, device_pair_hash2

    def node(e, lane):
        rows = dg.edge_rows[torch.where(e >= 0, e, 0).long()][..., lane]
        return rows.contiguous().view(torch.int32)
    a = node(carry_edge, 0)[:, :, None].expand(-1, -1, first_edge.shape[1]).reshape(-1)
    b = node(first_edge, 1)[:, None, :].expand(-1, carry_edge.shape[1], -1).reshape(-1)
    buckets = torch.unique(torch.cat([device_pair_hash(a, b, du.bmask),
                                      device_pair_hash2(a, b, du.bmask)]))
    edges = torch.unique(torch.cat([carry_edge.reshape(-1), first_edge.reshape(-1)]))
    return int(buckets.numel()), int(edges.numel())


def chain_phases(matcher, long_traces, traces64, timed):
    """Kernel 5 against its plain version at its two main-path shapes: the
    long path's window (64 x 256, continuing live carries) and the
    session step against the serving slab (512 x 4, 65,536 slots)."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    dev = matcher.device
    K = matcher.cfg.beam_k
    dg, du, p = matcher._dg, matcher._du, matcher._params
    out = {}

    # long path: window 1 of the long cohort, from window 0's carries
    W = matcher.max_trace_points
    B = len(long_traces)
    two = [dict(tr, trace=tr["trace"][:2 * W]) for tr in long_traces]
    px, py, tm, valid, _t = matcher._fill_rows(two, list(range(B)), 2 * W)
    xin = torch.from_numpy(V.pack_inputs(px, py, tm, valid)).to(dev)
    x0, x1 = xin[:, :, :W].contiguous(), xin[:, :, W:].contiguous()
    pre0 = V.precompute_batch_packed(dg, du, x0, p, K)
    carry = V.chain_batch_carry_packed_aux(dg, du, pre0, x0, p, K,
                                           V.initial_carry_batch(B, K, dev))[2]
    check(bool(carry.active.all()), "live carries after window 0")
    pre = V.precompute_batch_packed(dg, du, x1, p, K)
    args = (dg, du, pre.emis, pre.logp, pre.gc, *V.unpack_inputs(x1), pre.cand.edge,
            pre.cand.offset, p, carry)
    k5, p5 = V.viterbi_chain(*args), V.viterbi_chain_plain(*args)
    check(torch.equal(k5[0], p5[0]), "viterbi_chain packed (long)")
    check(_carry_same(k5[2], p5[2]), "viterbi_chain carry-out (long)")
    check(torch.allclose(k5[1], p5[1], rtol=1e-4, atol=0), "viterbi_chain aux (long)")
    n_rows, n_edges = _seam_rows(dg, du, carry.edge, pre.cand.edge[:, 0])
    T = W
    slot_b = 12 * K + 17
    # reads: emis, logp, gc, px/py/times/valid, candidate edge + offset, the
    # carry, the seam's distinct bucket and edge rows; writes: packed, aux,
    # the carry.  2 K^2 operations per step, ~80 per seam pair.
    nbytes = (4 * B * T * K + 4 * B * (T - 1) * K * K + 4 * B * (T - 1) + 16 * B * T
              + 8 * B * T * K + 2 * slot_b * B + 512 * n_rows + 32 * n_edges
              + 12 * B * T + 16 * B)
    bl, byl = bound(nbytes, 2 * K * K * (T - 1) * B + 80 * K * K * B)
    out["long"] = dict(shape="%dx%d" % (B, T), fn=lambda: V.viterbi_chain(*args),
                       plain=lambda: V.viterbi_chain_plain(*args), bound_ms=bl,
                       bound_by=byl, max_abs_err=max_abs_err([(k5[0], p5[0])]),
                       aux_max_abs_err=max_abs_err([(k5[1], p5[1])]),
                       seam_bucket_rows=n_rows)

    # session step against the serving slab: 480 rows continue their
    # beams, 16 start fresh on slots that hold old beams, 16 are padding
    S, B, Wn = matcher.cfg.max_sessions, len(traces64), 4
    rng = np.random.default_rng(5)
    slots = np.full(B, S, np.int32)
    slots[:B - 16] = rng.choice(S, B - 16, replace=False)

    slab = V.initial_carry_batch(S, K, dev)
    # xs1 is the input main() holds kernels 1-4 at (kernel_phases), so the
    # pre both sides share below was itself checked against its plain version
    xs0, xs1 = (session_rows(matcher, traces64[:B - 16], j, Wn) for j in (0, Wn))
    V.session_step_arena(dg, du, xs0, p, K, slab, slots, np.zeros(B, bool))
    use = np.zeros(B, bool)
    use[:B - 32] = True
    pre = V.precompute_batch_packed(dg, du, xs1, p, K)
    slab_k = V.TraceCarry(*(t.clone() for t in slab))
    slab_p = V.TraceCarry(*(t.clone() for t in slab))
    sargs = (dg, du, pre.emis, pre.logp, pre.gc, *V.unpack_inputs(xs1), pre.cand.edge,
             pre.cand.offset, p)
    ka = V.viterbi_chain(*sargs, slab_k, slots, use)
    pa = V.viterbi_chain_plain(*sargs, slab_p, slots, use)
    check(torch.equal(ka[0], pa[0]), "viterbi_chain packed (arena)")
    check(_carry_same(slab_k, slab_p), "viterbi_chain slab (arena)")
    check(not _carry_same(slab_k, slab), "the arena step wrote the slab")
    check(torch.allclose(ka[1], pa[1], rtol=1e-4, atol=0), "viterbi_chain aux (arena)")
    live = torch.from_numpy(slots[:B - 32].astype(np.int64)).to(dev)
    in_edge = slab.edge[live]
    n_rows, n_edges = _seam_rows(dg, du, in_edge, pre.cand.edge[:B - 32, 0])
    T = Wn
    nbytes = (4 * B * T * K + 4 * B * (T - 1) * K * K + 4 * B * (T - 1) + 16 * B * T
              + 8 * B * T * K + 5 * B + slot_b * ((B - 32) + (B - 16))
              + 512 * n_rows + 32 * n_edges + 12 * B * T + 16 * B)
    ba, bya = bound(nbytes, 2 * K * K * (T - 1) * B + 80 * K * K * B)
    out["arena"] = dict(shape="%dx%d slab %d" % (B, T, S),
                        fn=lambda: V.viterbi_chain(*sargs, slab_k, slots, use),
                        plain=lambda: V.viterbi_chain_plain(*sargs, slab_p, slots, use),
                        bound_ms=ba, bound_by=bya,
                        max_abs_err=max_abs_err([(ka[0], pa[0])]),
                        aux_max_abs_err=max_abs_err([(ka[1], pa[1])]),
                        seam_bucket_rows=n_rows)
    for r in out.values():
        if timed and dev.type == "cuda":
            r["ms"] = time_ms(r["fn"], cold_l2=False)
            r["plain_ms"] = time_ms(r["plain"], cold_l2=False, queued=False)
        print("kernel viterbi_chain     %-17s max_abs_err=%-9.3g kernel_ms=%s plain_ms=%s "
              "bound_ms=%.4f (%s) within tolerance: packed, carry/slab exact; aux rtol 1e-4"
              % (r["shape"], r["max_abs_err"],
                 "%.4f" % r["ms"] if "ms" in r else "-",
                 "%.4f" % r["plain_ms"] if "plain_ms" in r else "-", r["bound_ms"],
                 r["bound_by"]))
    return out


def _counted(path_kernels, drive):
    """Drive one path with every launch count set to 0 just before and read
    just after; on the card every kernel of the path must have launched."""
    import torch

    from reporter_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = drive()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: kern.launches for k, kern in _kernels.KERNELS.items()}
    if torch.cuda.is_available():
        check(all(launches[k] > 0 for k in path_kernels),
              "every kernel of the path launched: %s" % json.dumps(launches))
    return res, dt, launches


BUCKETED = ("candidate_sweep", "ubodt_probe", "transition_build", "viterbi_scan")
CARRIED = ("candidate_sweep", "ubodt_probe", "transition_build", "viterbi_chain")


def long_path(matcher, traces):
    """The long path: ``match_many`` over 64 traces of 2,048 points (8
    windows of 256) through the launch counters, then the group's
    per-point output held against the plain composition window by window
    on the card."""
    import numpy as np
    import torch

    from reporter_tpu_torch.ops import viterbi as V

    dev = matcher.device
    matcher.match_many(traces[:1])  # first-call set-up outside the count
    res, dt, launches = _counted(CARRIED, lambda: matcher.match_many(traces))
    check(len(res) == len(traces) and all(r["segments"] for r in res), "long path results")
    n_pts = sum(len(tr["trace"]) for tr in traces)
    rate = {"traces": len(traces), "T": len(traces[0]["trace"]), "s": dt,
            "traces_per_s": len(traces) / dt, "points_per_s": n_pts / dt}
    print("long path %dx%d: %.3f s, %.1f traces/s, %.0f points/s, launches %s"
          % (len(traces), rate["T"], dt, rate["traces_per_s"], rate["points_per_s"],
             json.dumps(launches)))
    W = matcher.max_trace_points
    n_chunks = -(-rate["T"] // W)
    if dev.type == "cuda":
        check(launches["candidate_sweep"] == 1 and launches["viterbi_chain"] == n_chunks,
              "one pre dispatch and one chain dispatch per window")

    handles = matcher._dispatch_long(traces, list(range(len(traces))))
    check(len(handles) == 1, "one long group")
    group, (edge, offset, breaks), _times, _aux = matcher._fetch_long_aux(handles[0])
    px, py, tm, valid, _t = matcher._fill_rows(traces, group, n_chunks * W)
    xin = torch.from_numpy(V.pack_inputs(px, py, tm, valid)).to(dev)
    p, K = matcher._params, matcher.cfg.beam_k
    carry = V.initial_carry_batch(len(group), K, dev)
    parts = []
    for c in range(n_chunks):
        xc = xin[:, :, c * W:(c + 1) * W].contiguous()
        pre = V.precompute_batch_packed_plain(matcher._dg, matcher._du, xc, p, K)
        packed, _a, carry = V.chain_batch_carry_packed_aux_plain(
            matcher._dg, matcher._du, pre, xc, p, K, carry)
        parts.append(V.unpack_compact(packed.cpu().numpy()))
    want = [np.concatenate([q[f] for q in parts], 1) for f in range(3)]
    B = len(group)
    check(np.array_equal(edge[:B], want[0]) and offset[:B].tobytes() == want[1].tobytes()
          and np.array_equal(breaks[:B], want[2]),
          "long path output equals the plain composition")
    print("long path [%d, %d x %d] equals the plain composition window by window"
          % (B, n_chunks, W))
    return launches, rate


def _clocked(fn, acc, key, finish_key=None):
    """``fn`` with its host time added to ``acc[key]``; with ``finish_key``
    fn returns a finish() whose time goes to ``acc[finish_key]``."""
    def run(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        if finish_key is None:
            return out

        def finish():
            t1 = time.perf_counter()
            res = out()
            acc[finish_key] = acc.get(finish_key, 0.0) + time.perf_counter() - t1
            return res
        return finish
    return run


def long_breakdown(matcher, traces):
    """Host-clock split of the long cohort through the matcher's own steps:
    packing, the device program (upload, the pre dispatch, the chain
    dispatches, fetch), association and report()."""
    import torch

    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.report import report as report_fn

    W = matcher.max_trace_points
    idxs = list(range(len(traces)))
    n_chunks = -(-max(len(t["trace"]) for t in traces) // W)
    if matcher.device.type == "cuda":
        torch.cuda.synchronize(matcher.device)
    t0 = time.perf_counter()
    px, py, tm, valid, times = matcher._fill_rows(traces, idxs, n_chunks * W)
    xin = V.pack_inputs(px, py, tm, valid)
    t1 = time.perf_counter()
    handle = (idxs, *matcher._dispatch_long_group(xin, n_chunks, W, matcher._params))
    group, host_parts, outs, aux = handle
    tail = torch.cat(outs, 2) if len(outs) > 1 else outs[0]
    _g, res, _t, aux = matcher._fetch_long_aux((group, host_parts, tail, times, aux))
    t2 = time.perf_counter()
    results = [None] * len(traces)
    matcher._associate_and_store(idxs, *res, times, results, aux=aux)
    t3 = time.perf_counter()
    for tr, r in zip(traces, results):
        r.pop("_quality", None)
        report_fn(r, tr, 15, {0, 1, 2}, {0, 1, 2})
    t4 = time.perf_counter()
    out = {"pack_ms": (t1 - t0) * 1e3, "device_ms": (t2 - t1) * 1e3,
           "assoc_ms": (t3 - t2) * 1e3, "report_ms": (t4 - t3) * 1e3}
    print("breakdown %dx%d (long): pack %.1f ms, device program incl. transfers %.2f ms, "
          "association %.1f ms, report() %.1f ms"
          % (len(traces), n_chunks * W, out["pack_ms"], out["device_ms"], out["assoc_ms"],
             out["report_ms"]))
    return out


def session_path(matcher, traces64):
    """The session path: the 512 x 64 cohort as 512 sessions in 16 steps of
    4 points through ``SessionEngine`` with the session slab at its
    serving size, through the launch counters; held bit for bit against
    the host-carry path and the long path of a matcher with 4-point
    windows.  Returns the slab matcher (the serve phase reuses it)."""
    from dataclasses import replace

    import numpy as np

    from reporter_tpu_torch.matching import SegmentMatcher, SessionEngine, SessionStore
    from reporter_tpu_torch.matching.arena import carry_host

    cfg = matcher.cfg
    am = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt,
                        config=replace(cfg, session_arena=True), device=matcher.device)
    check(am.session_arena.hot_slots == 65536, "serving slab of 65,536 slots")
    steps, Wn = len(traces64[0]["trace"]) // 4, 4

    def stream(m, traces, split=None):
        eng = SessionEngine(m, SessionStore(cfg.max_sessions, cfg.session_ttl_s),
                            tail_points=cfg.session_tail_points)
        if split is not None:  # host clocks around the engine's own steps
            eng.associate = _clocked(eng.associate, split, "association")
            m.match_sessions_async = _clocked(m.match_sessions_async, split, "dispatch",
                                              "device_and_fetch")
        for j in range(0, steps * Wn, Wn):
            eng.match_many([dict(tr, trace=tr["trace"][j:j + Wn]) for tr in traces])
        m.__dict__.pop("match_sessions_async", None)
        return eng

    warm = stream(am, [dict(traces64[0], uuid="warm")])  # set-up outside the count
    warm.store.drop("warm")
    split = {}
    eng, dt, launches = _counted(CARRIED, lambda: stream(am, traces64, split))
    n = len(traces64)
    split = {k + "_ms_per_step": v * 1e3 / steps for k, v in split.items()}
    split["engine_rest_ms_per_step"] = dt * 1e3 / steps - sum(split.values())
    rate = {"sessions": n, "steps": steps, "points_per_step": Wn, "s": dt,
            "steps_per_s": steps / dt, "points_per_s": n * steps * Wn / dt,
            "breakdown": split}
    print("session path %d sessions x %d steps of %d: %.3f s, %.2f steps/s, %.0f points/s, "
          "launches %s" % (n, steps, Wn, dt, rate["steps_per_s"], rate["points_per_s"],
                           json.dumps(launches)))
    print("session step breakdown (ms per step): %s"
          % ", ".join("%s %.1f" % (k[:-12], v) for k, v in split.items()))
    if matcher.device.type == "cuda":
        check(launches["viterbi_chain"] == steps, "one slab step per session step")
    host = stream(matcher, traces64)
    oracle = SegmentMatcher(arrays=matcher.arrays, ubodt=matcher.ubodt,
                            config=replace(cfg, length_buckets=[Wn]), device=matcher.device)
    (h,) = oracle._dispatch_long(traces64, list(range(n)))
    group, (edge, offset, breaks), _t, _a = oracle._fetch_long_aux(h)
    for row, i in enumerate(group):
        u = traces64[i]["uuid"]
        s, hs = eng.store.peek(u), host.store.peek(u)
        check(s.records == hs.records, "slab path records equal host-carry path (%s)" % u)
        a, b = carry_host(s.carry), carry_host(hs.carry)
        check(all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a),
              "slab beam equals host-carry beam (%s)" % u)
        rec = np.array([(r[0], r[2]) for r in s.records])
        off = np.array([r[1] for r in s.records], np.float32)
        check(np.array_equal(rec[:, 0], edge[row]) and np.array_equal(rec[:, 1], breaks[row])
              and off.tobytes() == offset[row].tobytes(),
              "session records equal the 4-point-window long path (%s)" % u)
    print("session path: %d sessions' records and beams equal on the slab and host-carry "
          "paths, and equal the long path with 4-point windows" % n)
    rate["arena"] = am.session_arena.summary()
    return am, launches, rate


def main_path(matcher, cohorts, xins):
    """The bucketed path through the launch counters, then, for each cohort,
    the packed program held against the plain versions' composition on
    the same batch."""
    import torch

    from reporter_tpu_torch.ops import _kernels
    from reporter_tpu_torch.ops import viterbi as V

    dev = matcher.device
    matcher.match_many(cohorts[0][:4])  # first-call set-up outside the count
    _kernels.reset_launches()
    rates = []
    for traces in cohorts:
        t0 = time.perf_counter()
        res = matcher.match_many(traces)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        n_pts = sum(len(tr["trace"]) for tr in traces)
        check(len(res) == len(traces) and all(r["segments"] for r in res),
              "main path results")
        rates.append({"traces": len(traces), "T": len(traces[0]["trace"]), "s": dt,
                      "traces_per_s": len(traces) / dt, "points_per_s": n_pts / dt})
        print("main path %dx%d: %.3f s, %.1f traces/s, %.0f points/s"
              % (len(traces), len(traces[0]["trace"]), dt, len(traces) / dt, n_pts / dt))
    launches = {k: kern.launches for k, kern in _kernels.KERNELS.items()}
    print("main path launches: %s" % json.dumps(launches))
    if dev.type == "cuda":
        check(all(launches[k] > 0 for k in BUCKETED), "every kernel launched on the main path")
    p = matcher._params
    for xin in xins:
        got = V.match_batch_compact_packed_aux(matcher._dg, matcher._du, xin, p,
                                               matcher.cfg.beam_k)
        want = V.match_batch_compact_packed_aux_plain(matcher._dg, matcher._du, xin, p,
                                                      matcher.cfg.beam_k)
        check(torch.equal(got[0], want[0]), "main path packed output equals the plain versions'")
        check(torch.allclose(got[1], want[1], rtol=1e-4, atol=0), "main path aux")
        print("main path packed [3,%d,%d] equals the plain composition, aux within rtol 1e-4"
              % tuple(xin.shape[1:]))
    return launches, rates


def breakdown(matcher, traces):
    """Host-clock split of one bucketed batch through the matcher's own
    steps: packing, the device program (upload, kernels 1-4, fetch),
    association, and report()."""
    import torch

    from reporter_tpu_torch.report import report as report_fn

    idxs = list(range(len(traces)))
    T = matcher._bucket_len(len(traces[0]["trace"]))
    if matcher.device.type == "cuda":
        torch.cuda.synchronize(matcher.device)
    t0 = time.perf_counter()
    px, py, tm, valid, times = matcher._fill_rows(traces, idxs, T)
    t1 = time.perf_counter()
    res, aux = matcher._collect_batch(matcher._dispatch_batch(px, py, tm, valid))
    t2 = time.perf_counter()
    results = [None] * len(traces)
    matcher._associate_and_store(idxs, *res, times, results, aux=aux)
    t3 = time.perf_counter()
    for tr, r in zip(traces, results):
        r.pop("_quality", None)
        report_fn(r, tr, 15, {0, 1, 2}, {0, 1, 2})
    t4 = time.perf_counter()
    out = {"pack_ms": (t1 - t0) * 1e3, "device_ms": (t2 - t1) * 1e3,
           "assoc_ms": (t3 - t2) * 1e3, "report_ms": (t4 - t3) * 1e3}
    print("breakdown %dx%d: pack %.1f ms, device program incl. transfers %.2f ms, "
          "association %.1f ms, report() %.1f ms"
          % (len(traces), T, out["pack_ms"], out["device_ms"], out["assoc_ms"],
             out["report_ms"]))
    return out


def _post(port, body):
    req = urllib.request.Request("http://127.0.0.1:%d/report" % port,
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _serve(matcher, threshold, *batches):
    """Answer each batch of requests concurrently through one port HTTP
    server, the batches one after the other; one answer list per batch."""
    from reporter_tpu_torch.serve import ReporterService

    service = ReporterService(matcher, threshold_sec=threshold, max_batch=64, max_wait_ms=10)
    server = service.make_server("127.0.0.1", 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    outs = []
    try:
        for requests in batches:
            out = [None] * len(requests)

            def one(i):
                out[i] = _post(port, requests[i])

            workers = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(300)
            check(not any(w.is_alive() for w in workers), "requests answered")
            outs.append(out)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        th.join(10)
    return outs


def _diff(got, want, path):
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want), "%s keys" % path)
        for k in want:
            _diff(got[k], want[k], "%s.%s" % (path, k))
    elif isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want), "%s length" % path)
        for i, (g, w) in enumerate(zip(got, want)):
            _diff(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, float):
        check(abs(got - want) <= 0.01, "%s: %r != %r" % (path, got, want))
    else:
        check(got == want, "%s: %r != %r" % (path, got, want))


def serve_phase(matcher, traces, long_trace, device):
    """Windowed, long and streaming /report on the metro city through the
    launch counters, then the recorded fixtures."""
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.network import grid_city
    from reporter_tpu_torch.tiles.ubodt import build_ubodt

    # 8 vehicles, 4 streaming submits of 4 points each, submitted together
    streams = [dict(tr, uuid="veh-%d" % i, stream=True, trace=tr["trace"][j:j + 4])
               for j in range(0, 16, 4) for i, tr in enumerate(traces[8:16])]
    requests = traces[:8] + [long_trace]
    t0 = time.perf_counter()

    (answers, *streamed), _dt, launches = _counted(BUCKETED + CARRIED, lambda: _serve(
        matcher, 15, requests, *(streams[j:j + 8] for j in range(0, len(streams), 8))))
    for code, body in answers:
        check(code == 200, "metro /report status %s" % code)
        check({"datastore", "segment_matcher", "stats"} <= set(body)
              and set(body) <= {"datastore", "segment_matcher", "stats", "shape_used"},
              "metro /report schema")
        check(body["segment_matcher"]["segments"], "metro /report segments")
    want = json.loads(json.dumps(matcher.match(long_trace)["segments"]))
    check(answers[-1][1]["segment_matcher"]["segments"] == want,
          "the long /report's segments equal match()")
    for k, batch in enumerate(streamed):
        for code, body in batch:
            check(code == 200 and body["session"]["seq"] == k + 1
                  and body["session"]["points_total"] == 4 * (k + 1),
                  "streaming /report status and session block")
    n_reports = sum(len(b["datastore"]["reports"]) for _c, b in answers)
    print("serve metro: 8 /report and one %d-point /report answered 200, 8 vehicles x 4 "
          "streaming submits answered 200, in %.2f s (%d datastore reports), launches %s"
          % (len(long_trace["trace"]), time.perf_counter() - t0, n_reports,
             json.dumps(launches)))

    with open(os.path.join(REPO, "tests", "fixtures", "report_fixtures.json")) as f:
        recorded = json.load(f)
    net = recorded["network"]
    arrays = build_graph_arrays(grid_city(net["rows"], net["cols"], net["spacing_m"]),
                                cell_size=100.0)
    fixture_matcher = SegmentMatcher(arrays=arrays, ubodt=build_ubodt(arrays, delta=3000.0),
                                     config=MatcherConfig(), device=device)
    (answers,) = _serve(fixture_matcher, recorded["threshold_sec"],
                        [fx["request"] for fx in recorded["fixtures"]])
    for fx, (code, body) in zip(recorded["fixtures"], answers):
        check(code == 200, "fixture status")
        _diff(body, fx["response"], fx["request"]["uuid"])
    print("serve fixtures: %d recorded /report responses replayed equal"
          % len(recorded["fixtures"]))
    return n_reports, launches


def main():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available\n")
        return 2
    import reporter_tpu_torch  # noqa: F401 - fails outside a checkout

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print("python %s, torch %s, cuda %s" % (sys.version.split()[0], torch.__version__,
                                            torch.version.cuda))
    t_start = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    build_s = build()
    matcher, city = metro_city(120, device)
    traces64 = cohort(matcher, 7, 512, 64)
    traces256 = cohort(matcher, 8, 128, 256)
    traces2048 = cohort(matcher, 9, 64, 2048)
    xin64, xin256 = bucket_rows(matcher, traces64, 64), bucket_rows(matcher, traces256, 256)
    rows = kernel_phases(matcher, xin64, timed=True)
    rows256 = kernel_phases(matcher, xin256, timed=False)
    # the session steps' shape: 496 sessions' 4 new points and 16 padding rows
    rows4 = kernel_phases(matcher, session_rows(matcher, traces64[:-16], 4), timed=False)
    chain = chain_phases(matcher, traces2048, traces64, timed=True)
    launches, rates = main_path(matcher, [traces64, traces256], [xin64, xin256])
    long_launches, long_rate = long_path(matcher, traces2048)
    arena_matcher, sess_launches, sess_rate = session_path(matcher, traces64)
    split = [breakdown(matcher, trs) for trs in (traces64, traces256)]
    split.append(long_breakdown(matcher, traces2048))
    n_reports, serve_launches = serve_phase(arena_matcher, traces64, traces2048[0], device)

    # launches over the counted runs of the bucketed, long and session
    # paths; kernels 1-4's times and bounds at 512 x 64, max_abs_err over
    # both bucketed shapes and the session step's; kernel 5's at the long
    # path's 64 x 256
    total = {k: launches[k] + long_launches[k] + sess_launches[k] for k in launches}
    kernels = [{
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": total[r["name"]],
        "max_abs_err": max(r["max_abs_err"], r2["max_abs_err"], r4["max_abs_err"]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
    } for r, r2, r4 in zip(rows, rows256, rows4)]
    cl = chain["long"]
    kernels.append({
        "name": "viterbi_chain", "route": "cuda",
        "source": "reporter_tpu_torch/csrc/viterbi_chain.cu",
        "replaces": "reporter_tpu/ops/viterbi.py:447", "launches": total["viterbi_chain"],
        "max_abs_err": max(c["max_abs_err"] for c in chain.values()), "ms": cl["ms"],
        "plain_ms": cl["plain_ms"], "bound_ms": cl["bound_ms"], "bound_by": cl["bound_by"],
        "library_ms": None})
    report = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "city": city, "main_path": rates, "breakdown": split,
        "long_path": long_rate, "session_path": sess_rate,
        "launches": {"bucketed": launches, "long": long_launches, "session": sess_launches,
                     "serve": serve_launches},
        "metro_reports": n_reports, "peak_memory_mb": torch.cuda.max_memory_allocated() / 1e6,
        "kernels": kernels,
        "extra": dict({"%s_%d" % (r["name"], T): {k: v for k, v in r.items() if k in (
            "probes", "distinct_rows", "hit_rate", "max_abs_err", "aux_max_abs_err")}
            for T, rs in ((64, rows), (256, rows256), (4, rows4)) for r in rs},
            **{"viterbi_chain_" + name: {k: v for k, v in c.items() if k not in ("fn", "plain")}
               for name, c in chain.items()}),
        "wall_s": time.perf_counter() - t_start,
    }
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("wall %.1f s, peak device memory %.0f MB"
          % (report["wall_s"], report["peak_memory_mb"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
