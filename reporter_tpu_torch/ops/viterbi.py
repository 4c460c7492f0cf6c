"""Batched HMM map matching: emission, transition, Viterbi (kernels 3-5).

The port of ``reporter_tpu/ops/viterbi.py``'s dense and sparse-gap
programs, a window that starts fresh and a window that continues a
carried beam, with either Viterbi forward.  Shapes, per [B, T] padded
batch:

    candidates   [B, T, K]        kernel 1 (ops/candidates.py), emission fused
    UBODT probe  [B, T-1, K, K]   kernel 2 (ops/hashtable.py)
    transition   [B, T-1, K, K]   kernel 3, ``transition_build``: route =
                                  remain + UBODT dist + offset with the
                                  same-edge forward / jitter rules, the
                                  max-route and route-time cuts, the turn
                                  penalty, logp = -|route - gc| / beta
    viterbi      [B, T]           kernel 4, ``viterbi_scan``: per trace the
                                  max-plus [K] x [K, K] recursion with
                                  break / restart / padding-freeze,
                                  backtrace, compact gather and the [4]
                                  confidence aux
    chain        [B, T]           kernel 5, ``viterbi_chain``: the scan
                                  continuing a ``TraceCarry`` (the seam
                                  transition from the carried beam, the
                                  seam check, the renormalised carry-out),
                                  its carry in [B]-leading tensors or in a
                                  session slab read and written in place
    assoc        [B, T]           ``viterbi_assoc`` / ``viterbi_chain_assoc``
                                  (csrc/viterbi_assoc.cu): kernels 4 and 5
                                  with the log-depth forward, the
                                  reference's ``_forward_assoc`` (an alive
                                  recursion for the breaks, a segmented
                                  tropical associative scan for the scores
                                  in ``jax.lax.associative_scan``'s pairing,
                                  backpointers from the prefixes) and
                                  ``backtrace_assoc``

Discontinuities follow the reference (and Meili): consecutive points
further apart than ``breakage_distance``, or a step that no feasible route
connects, restart the HMM at that point and record a break.

Long traces run in fixed windows: ``precompute_batch_packed`` (kernels
1-3) over all of a group's windows at once, then one
``chain_batch_carry_packed_aux`` (kernel 5) per window, the carry chaining
them; the legacy ``match_batch_carry_packed`` runs kernels 1-3 and the
chain kernel once a window instead.  A session step runs both over one
small window, the carry in
[B]-leading tensors (``session_step_packed``) or in the device slab
(``session_step_arena``).

Every entry point takes ``sp=None``: with a ``SparseParams`` it runs the
sparse-gap model (the reference's ``*_packed_sparse`` programs) through
the SPARSE instantiations of kernels 3-5.  The entry points that see a
whole dispatch's key set (``match_batch_compact_packed_aux``,
``precompute_batch[_packed]``) take ``dedup=False``: the in-batch probe
dedup of ops/hashtable.py, same results.  Session steps and the chain's
seam probes never dedup; the seam probe reads the table's layout.

Every entry point also takes ``kernel="scan"``: "assoc" runs the log-depth
forward (the reference's ``kernel="assoc"``; at T < 2 the scan, as there).

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors.  Every packed entry point composes
the wrappers; its ``_plain`` twin composes the plain versions (the
reference a chip run holds the kernels against on the card).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import upload
from ..tiles.arrays import DeviceGraph
from ..tiles.ubodt import DeviceUBODT, ShardedUBODT
from . import collectives
from ..obs.attrib import stage, staged
from ._kernels import KERNELS, check, library_function, ptr
from .candidates import (
    NEG_INF, Candidates, _scalar, candidate_sweep, candidate_sweep_plain, fma,
    hypot_like_jax,
)
from .hashtable import (
    check_table, note_lookup, table_args, ubodt_lookup, ubodt_lookup_plain,
)

_PI = float(np.float32(math.pi))
_TWO_PI = float(np.float32(2.0 * math.pi))


def _f32(v) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32)


class MatchParams(NamedTuple):
    """HMM scalars shared across a batch: float32 0-d host tensors (the
    kernels take them as float arguments without a device sync)."""

    sigma_z: torch.Tensor
    beta: torch.Tensor
    search_radius: torch.Tensor
    breakage_distance: torch.Tensor
    max_route_distance_factor: torch.Tensor
    max_route_time_factor: torch.Tensor
    turn_penalty_factor: torch.Tensor

    @classmethod
    def from_config(cls, cfg) -> "MatchParams":
        return cls(
            sigma_z=_f32(cfg.sigma_z),
            beta=_f32(cfg.beta),
            search_radius=_f32(cfg.search_radius),
            breakage_distance=_f32(cfg.breakage_distance),
            max_route_distance_factor=_f32(cfg.max_route_distance_factor),
            max_route_time_factor=_f32(cfg.max_route_time_factor),
            turn_penalty_factor=_f32(cfg.turn_penalty_factor),
        )


class SparseParams(NamedTuple):
    """The sparse-gap model's six scalars (the reference's ``SparseParams``,
    docs/match-quality.md "Sparse gaps"): float32 0-d host tensors, like
    MatchParams.  Per point pair with measurement gap dt seconds:

      * time-adaptive beta: beta * min(1 + beta_scale * max(dt - beta_ref,
        0) / max(beta_ref, 1), beta_max) (``sparse_beta``);
      * drivable-speed plausibility: a pair whose route implies a speed
        above vmax pays plaus_weight * (route / max(dt, 1) - vmax) /
        max(vmax, 1) log-prob units, where dt > 0;
      * gap-conditioned breakage: max(breakage_distance, break_speed *
        max(dt, 0)) (``sparse_breakage``).

    Presence is static, as in the reference: every entry point takes
    ``sp=None`` for the dense model, and the kernels run their SPARSE
    instantiation only when ``sp`` is given."""

    beta_ref: torch.Tensor  # s; gaps at or below leave beta unchanged
    beta_scale: torch.Tensor  # growth rate of the beta multiplier
    beta_max: torch.Tensor  # cap on the multiplier
    break_speed: torch.Tensor  # m/s; breakage = max(base, break_speed * dt)
    vmax: torch.Tensor  # m/s drivable-speed knee
    plaus_weight: torch.Tensor  # log-prob units per vmax of excess speed

    @classmethod
    def from_values(cls, beta_ref, beta_scale, beta_max, break_speed, vmax,
                    plaus_weight) -> "SparseParams":
        return cls(_f32(beta_ref), _f32(beta_scale), _f32(beta_max),
                   _f32(break_speed), _f32(vmax), _f32(plaus_weight))

    @classmethod
    def from_config(cls, cfg) -> "SparseParams":
        return cls.from_values(
            cfg.sparse_beta_ref_s, cfg.sparse_beta_scale, cfg.sparse_beta_max,
            cfg.sparse_break_speed_mps, cfg.sparse_vmax_mps,
            cfg.sparse_plaus_weight)

    def floats(self):
        """The six values as Python floats, in the kernels' argument order."""
        return [float(v) for v in self]


def sparse_beta(beta, sp: SparseParams, dt: torch.Tensor) -> torch.Tensor:
    """The time-adaptive beta(dt) of the sparse model (float32, on
    ``dt``'s device)."""
    f = lambda v: _scalar(v, dt)  # noqa: E731
    grow = (f(sp.beta_scale) * torch.clamp(dt - f(sp.beta_ref), min=0.0)
            / torch.clamp(f(sp.beta_ref), min=1.0))
    return f(beta) * torch.minimum(1.0 + grow, f(sp.beta_max))


def sparse_breakage(breakage_distance, sp: Optional[SparseParams],
                    dt: torch.Tensor) -> torch.Tensor:
    """The breakage threshold of a step with gap ``dt``: the fixed
    ``breakage_distance`` for the dense model (``sp`` None), else
    max(breakage_distance, break_speed * max(dt, 0))."""
    brk = _scalar(breakage_distance, dt)
    if sp is None:
        return brk
    return torch.maximum(
        brk, _scalar(sp.break_speed, dt) * torch.clamp(dt, min=0.0))


class TracePre(NamedTuple):
    """Everything the Viterbi forward consumes, [B, ...] leaves."""

    cand: Candidates  # [B, T, K]
    emis: torch.Tensor  # [B, T, K] emission log-probs
    logp: torch.Tensor  # [B, T-1, K, K] transition log-probs per step
    route: Optional[torch.Tensor]  # [B, T-1, K, K] route distances per step (None on the packed path)
    gc: torch.Tensor  # [B, T-1] straight-line metres between consecutive points


class TraceCarry(NamedTuple):
    """Viterbi state carried from one window of a trace to the next (the
    reference's ``TraceCarry``, vmapped), SoA with leading [B] (or [S] for
    the session slab).  The next window's first transition runs from
    these candidates instead of restarting the HMM."""

    scores: torch.Tensor  # [B, K] f32 beam at the last valid point, max-renormalised
    edge: torch.Tensor  # [B, K] i32 candidate edges there
    offset: torch.Tensor  # [B, K] f32 offsets along them
    x: torch.Tensor  # [B] f32 last valid point
    y: torch.Tensor  # [B] f32
    t: torch.Tensor  # [B] f32 its time
    active: torch.Tensor  # [B] bool, False = no live state
    committed: torch.Tensor  # [B] i32 slot the backtrace chose there, -1 none


CARRY_DTYPES = (torch.float32, torch.int32, torch.float32, torch.float32,
                 torch.float32, torch.float32, torch.bool, torch.int32)


def initial_carry_batch(b: int, k: int, device="cpu") -> TraceCarry:
    """The inactive carry for ``b`` rows: a fresh trace or session."""
    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)
    return TraceCarry(
        scores=full((b, k), NEG_INF, torch.float32),
        edge=full((b, k), -1, torch.int32),
        offset=full((b, k), 0.0, torch.float32),
        x=full((b,), 0.0, torch.float32), y=full((b,), 0.0, torch.float32),
        t=full((b,), 0.0, torch.float32),
        active=full((b,), False, torch.bool),
        committed=full((b,), -1, torch.int32))


def slice_pre(pre: TracePre, lo: int, hi: int) -> TracePre:
    """Rows [lo, hi) of every leaf of a TracePre (None leaves stay None)."""
    cut = lambda a: None if a is None else a[lo:hi]  # noqa: E731
    return TracePre(Candidates(*(cut(a) for a in pre.cand)), cut(pre.emis),
                    cut(pre.logp), cut(pre.route), cut(pre.gc))


# -- kernel 3: transition build ---------------------------------------------

def angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed smallest difference between two angles, in (-pi, pi]:
    ``jnp.mod`` written out as its floored remainder (fmod, then add the
    divisor where the signs differ), which is exact."""
    d = b - a + _PI
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=d.device)
    r = torch.fmod(d.double(), two_pi.double()).float()  # exact in float64
    r = torch.where((r != 0) & ((r < 0) != (two_pi < 0)), r + two_pi, r)
    return r - _PI


@staged("emission+transition-build")
def transition_build_plain(dg: DeviceGraph, cand: Candidates, px, py, times,
                           sp_dist, sp_time, p: MatchParams,
                           with_route: bool = True,
                           sp: Optional[SparseParams] = None):
    """Plain PyTorch version of ``_transition_matrix`` over a batch, the
    dense model or, with ``sp``, the sparse-gap one.  cand leaves [B, T, K];
    px/py/times [B, T]; sp_dist/sp_time [B, T-1, K, K].  Returns (logp,
    route [B, T-1, K, K], gc [B, T-1]); route is None unless
    ``with_route``."""
    f = lambda v: _scalar(v, px)  # noqa: E731 - device-local float32 scalar
    gc = hypot_like_jax(px[:, 1:] - px[:, :-1], py[:, 1:] - py[:, :-1])
    dt = times[:, 1:] - times[:, :-1]
    ea = cand.edge[:, :-1, :, None]
    eb = cand.edge[:, 1:, None, :]
    oa = cand.offset[:, :-1, :, None]
    ob = cand.offset[:, 1:, None, :]
    er = dg.edge_rows[torch.where(cand.edge >= 0, cand.edge, 0).long()]  # [B, T, K, 8]
    era = er[:, :-1, :, None, :]
    erb = er[:, 1:, None, :, :]
    gc4 = gc[:, :, None, None]
    dt4 = dt[:, :, None, None]

    remain = era[..., 2] - oa
    route = remain + sp_dist + ob
    speed_a = torch.clamp(era[..., 3], min=0.1)
    speed_b = torch.clamp(erb[..., 3], min=0.1)
    rtime = remain / speed_a + sp_time + ob / speed_b

    # same-edge handling: forward progress is the offset delta; a small
    # backward delta (GPS jitter) costs a slight penalty; a large one
    # routes the loop, which the UBODT formula above already expresses
    same = (ea == eb) & (ea >= 0)
    delta = ob - oa
    back_tol = 2.0 * p.sigma_z.to(px.device) + 5.0
    same_fwd = same & (delta >= 0)
    same_jitter = same & (delta < 0) & (-delta <= back_tol)
    route = torch.where(same_fwd, delta, route)
    route = torch.where(same_jitter, fma(-delta, torch.full_like(delta, 1.05), 1.0), route)
    same_known = same_fwd | same_jitter
    rtime = torch.where(same_known, delta.abs() / speed_a, rtime)

    ok = (ea >= 0) & (eb >= 0)
    max_route = p.max_route_distance_factor.to(px.device) * (gc4 + f(p.search_radius))
    feasible = ok & torch.isfinite(route) & (route <= max_route)
    feasible &= (dt4 <= 0) | (rtime <= p.max_route_time_factor.to(px.device)
                              * torch.clamp(dt4, min=1.0))
    beta = f(p.beta) if sp is None else sparse_beta(p.beta, sp, dt4)
    logp = -(route - gc4).abs() / beta
    turn = angle_diff(era[..., 5], erb[..., 4]).abs()
    pen = p.turn_penalty_factor.to(px.device) * turn / (_PI * beta)
    logp = logp - torch.where(same_known, torch.zeros_like(pen), pen)
    if sp is not None:
        # drivable-speed plausibility on the route before the feasibility
        # cut; an infeasible pair's NaN (0 * inf) is masked just below.
        # The compiled reference does not fuse this product into the
        # subtraction (measured in all three of its fusions, PERF.md)
        implied = route / torch.clamp(dt4, min=1.0)
        excess = (torch.clamp(implied - f(sp.vmax), min=0.0)
                  / torch.clamp(f(sp.vmax), min=1.0))
        pen = f(sp.plaus_weight) * excess
        logp = logp - torch.where(dt4 > 0, pen, torch.zeros_like(pen))
    logp = torch.where(feasible, logp, torch.full_like(logp, NEG_INF))
    route = torch.where(feasible, route, torch.full_like(route, float("inf")))
    return logp, route if with_route else None, gc


def transition_build(dg: DeviceGraph, cand: Candidates, px, py, times,
                     sp_dist, sp_time, p: MatchParams, with_route: bool = True,
                     sp: Optional[SparseParams] = None):
    """Transition log-probs and routes for every step of a batch: the CUDA
    kernel (its sparse instantiation with ``sp``) for CUDA tensors, the
    plain version for CPU tensors.  With ``with_route=False`` the route is
    neither written nor returned (None): the Viterbi scan never reads it."""
    if px.device.type == "cpu":
        return transition_build_plain(dg, cand, px, py, times, sp_dist,
                                      sp_time, p, with_route, sp)
    dev = px.device
    B, T, K = cand.edge.shape
    check(cand.edge, "edge", torch.int32, dev, (B, T, K))
    check(cand.offset, "offset", torch.float32, dev, (B, T, K))
    for name, t in (("px", px), ("py", py), ("times", times)):
        check(t, name, torch.float32, dev, (B, T))
    for name, t in (("sp_dist", sp_dist), ("sp_time", sp_time)):
        check(t, name, torch.float32, dev, (B, T - 1, K, K))
    check(dg.edge_rows, "edge_rows", torch.float32, dev)
    logp = torch.empty((B, T - 1, K, K), dtype=torch.float32, device=dev)
    route = torch.empty_like(logp) if with_route else None
    gc = torch.empty((B, T - 1), dtype=torch.float32, device=dev)
    if logp.numel():
        args = [ptr(cand.edge), ptr(cand.offset), ptr(px), ptr(py),
                ptr(times), ptr(dg.edge_rows), ptr(sp_dist), ptr(sp_time), B,
                T, K, float(p.sigma_z), float(p.beta), float(p.search_radius),
                float(p.max_route_distance_factor),
                float(p.max_route_time_factor), float(p.turn_penalty_factor),
                ptr(logp), ptr(route), ptr(gc)]
        if sp is None:
            KERNELS["transition_build"].launch(dev, *args)
        else:
            KERNELS["transition_build[sparse]"].launch(dev, *args,
                                                       *sp.floats())
    return logp, route, gc


# -- kernel 4: scan recursion, backtrace, compact gather, confidence -----------

def _forward_plain(init, first_break, emis, logp, gc, vb, brk):
    """The score recursion from ``init`` [B, K] (the scores at t = 0) with
    break/restart/padding-freeze; ``brk`` is the breakage threshold, 0-d
    or per step [B, T-1].  Returns scores [B, T, K], backpointers
    [B, T, K] (-1 restart, -2 padded) and breaks [B, T] bool."""
    B, T, K = emis.shape
    scores = init
    scores_mat = [scores]
    backptr = [torch.full((B, K), -1, dtype=torch.int64, device=emis.device)]
    breaks = [first_break & vb[:, 0]]
    for t in range(1, T):
        total = scores[:, :, None] + logp[:, t - 1]  # [B, K src, K dst]
        best_src = torch.argmax(total, dim=1)  # first maximum
        best_val = torch.gather(total, 1, best_src[:, None, :])[:, 0]
        connected = best_val > NEG_INF / 2
        brk_t = brk if brk.dim() == 0 else brk[:, t - 1]
        broke = (gc[:, t - 1] > brk_t) | ~connected.any(1)
        new = torch.where(broke[:, None], emis[:, t], best_val + emis[:, t])
        vt = vb[:, t, None]
        new = torch.where(vt, new, scores)  # padding: freeze
        bp = torch.where(broke[:, None] | ~connected, -1, best_src)
        bp = torch.where(vt, bp, -2)  # -2 = padded step
        scores = new
        scores_mat.append(scores)
        backptr.append(bp)
        breaks.append(broke & vb[:, t])
    return (torch.stack(scores_mat, 1), torch.stack(backptr, 1),
            torch.stack(breaks, 1))


def _backtrace_plain(S, BP, vb):
    """Chosen slot per point [B, T] (-1 unmatched): a padded or dead
    successor restarts the walk at the local argmax."""
    T = S.shape[1]
    local = torch.argmax(S, dim=2)  # [B, T]
    top1 = torch.gather(S, 2, local[..., None])[..., 0]
    local = torch.where(top1 > NEG_INF / 2, local, -1)
    idx = [None] * T
    nxt = torch.where(vb[:, T - 1], local[:, T - 1], -1)
    idx[T - 1] = nxt
    for t in range(T - 2, -1, -1):
        from_next = torch.gather(BP[:, t + 1], 1, nxt.clamp(min=0)[:, None])[:, 0]
        from_next = torch.where(nxt >= 0, from_next, -1)
        it = torch.where(vb[:, t + 1] & (nxt >= 0) & (from_next >= 0),
                         from_next, local[:, t])
        it = torch.where(vb[:, t], it, -1)
        idx[t] = it
        nxt = it
    return torch.stack(idx, 1)


# -- the log-depth (assoc) forward and backtrace (kernels 4 and 5's assoc twins) --

def _cut(e: torch.Tensor, dim: int, start=None, stop=None, step=None):
    return e[(slice(None),) * dim + (slice(start, stop, step),)]


def _assoc_scan_plain(combine, elems, reverse: bool = False, dim: int = 0):
    """``jax.lax.associative_scan`` written out on tensors, in its pairing
    order: combine adjacent pairs, recurse on the half-length sequence
    (the odd prefixes), then form each even prefix from the odd prefix
    before it, and interleave.  The order matters: each float ``+`` of a
    combine rounds, so another tree (Hillis-Steele, Blelloch) gives other
    bits.  ``combine(a, b)`` takes and returns tuples of tensors, ``a``
    the earlier elements; ``reverse`` scans from the end, as the
    reference's does."""
    elems = [e.flip(dim) if reverse else e for e in elems]

    def scan(es):
        n = es[0].shape[dim]
        if n < 2:
            return es
        odd = scan(list(combine(tuple(_cut(e, dim, 0, -1, 2) for e in es),
                                tuple(_cut(e, dim, 1, None, 2) for e in es))))
        prev = odd if n % 2 else [_cut(o, dim, 0, -1) for o in odd]
        even = combine(tuple(prev), tuple(_cut(e, dim, 2, None, 2) for e in es))
        out = []
        for e, ev, od in zip(es, even, odd):
            r = torch.empty_like(e)
            _cut(r, dim, 0, 1).copy_(_cut(e, dim, 0, 1))
            _cut(r, dim, 2, None, 2).copy_(ev)
            _cut(r, dim, 1, None, 2).copy_(od)
            out.append(r)
        return out

    return tuple(e.flip(dim) if reverse else e for e in scan(elems))


def _forward_assoc_plain(init, first_break, emis, logp, gc, vb, brk):
    """The log-depth forward (the reference's ``_forward_assoc``), batched,
    with ``_forward_plain``'s arguments and results.  Break flags come from
    a serial alive-support recursion over [K] booleans (exact: liveness is
    reachability); the scores from a segmented tropical associative scan
    of the affine maps f_t(s) = flag_t ? c_t : s (x) M_t, M_t = logp_t +
    emis[t+1] (padded steps the identity), with ``init`` added to the
    composed prefix last; backpointers recomputed from the prefix scores,
    first maximum on ties."""
    B, T, K = emis.shape
    vt = vb[:, 1:]  # [B, T-1]
    feasible = logp > NEG_INF / 2
    ealive = emis[:, 1:] > NEG_INF / 2
    hard = gc > brk
    alive = init > NEG_INF / 2
    broke = []
    for t in range(T - 1):
        conn = (alive[:, :, None] & feasible[:, t]).any(1)  # [B, K]
        b = hard[:, t] | ~conn.any(1)
        new = torch.where(b[:, None], ealive[:, t], conn & ealive[:, t])
        alive = torch.where(vt[:, t, None], new, alive)  # padding: freeze
        broke.append(b)
    broke = torch.stack(broke, 1)  # [B, T-1]

    eye = torch.full((K, K), NEG_INF, dtype=emis.dtype, device=emis.device)
    eye.fill_diagonal_(0.0)
    M = torch.where(vt[:, :, None, None], logp + emis[:, 1:, None, :], eye)
    flag = broke & vt
    c = torch.where(flag[..., None], emis[:, 1:], torch.full_like(emis[:, 1:], NEG_INF))

    def combine(a, b):
        fa, ma, ca = a
        fb, mb, cb = b
        mab = (ma[..., :, :, None] + mb[..., None, :, :]).amax(-2)
        cab = (ca[..., :, None] + mb).amax(-2)
        return fa | fb, mab, torch.where(fb[..., None], cb, cab)

    flags, ms, cs = _assoc_scan_plain(combine, (flag, M, c), dim=1)
    prop = (init[:, None, :, None] + ms).amax(2)  # [B, T-1, K]
    scores = torch.where(flags[..., None], cs, prop)

    prev = torch.cat([init[:, None], scores[:, :-1]], 1)
    total = prev[..., :, None] + logp  # [B, T-1, K src, K dst]
    best_src = torch.argmax(total, dim=2)  # first maximum
    connected = torch.gather(total, 2, best_src[:, :, None])[:, :, 0] > NEG_INF / 2
    bp = torch.where(broke[..., None] | ~connected, -1, best_src)
    bp = torch.where(vt[..., None], bp, -2)  # -2 = padded step
    return (torch.cat([init[:, None], scores], 1),
            torch.cat([torch.full_like(bp[:, :1], -1), bp], 1),
            torch.cat([(first_break & vb[:, 0])[:, None], broke & vt], 1))


def _backtrace_assoc_plain(S, BP, vb):
    """``_backtrace_plain``'s result by the reference's ``backtrace_assoc``:
    each reverse step is a map of the chosen slot at t+1 (slot K encoding
    -1) to the slot at t, [K+1] indices, composed by gather in a reverse
    associative scan."""
    B, T, K = S.shape
    local = torch.argmax(S[:, :-1], dim=2)  # [B, T-1]
    top = torch.gather(S[:, :-1], 2, local[..., None])[..., 0]
    local = torch.where(top > NEG_INF / 2, local, -1)
    maps = torch.where(vb[:, 1:, None] & (BP[:, 1:] >= 0), BP[:, 1:], local[..., None])
    maps = torch.cat([maps, local[..., None]], 2)  # [B, T-1, K+1]
    maps = torch.where(vb[:, :-1, None], maps, -1)

    def compose(a, b):
        (a,), (b,) = a, b
        return (torch.gather(b, -1, torch.where(a >= 0, a, K)),)

    (suffix,) = _assoc_scan_plain(compose, (maps,), reverse=True, dim=1)
    last = torch.argmax(S[:, -1], dim=1)
    top = torch.gather(S[:, -1], 1, last[:, None])[:, 0]
    last = torch.where((top > NEG_INF / 2) & vb[:, -1], last, -1)
    enc = torch.where(last >= 0, last, K)[:, None, None].expand(B, T - 1, 1)
    return torch.cat([torch.gather(suffix, 2, enc)[..., 0], last[:, None]], 1)


KERNEL_CHOICES = ("scan", "assoc")


def _use_assoc(kernel: str, T: int) -> bool:
    """Whether the ``kernel`` forward runs the assoc code at window length
    T: "assoc" at T >= 2; at T < 2 it is the scan, as in the reference."""
    if kernel not in KERNEL_CHOICES:
        raise ValueError("unknown viterbi kernel %r" % (kernel,))
    return kernel == "assoc" and T >= 2


def _decode_stage(kernel: str, T: int) -> str:
    """The stage label of the plain decode that ``kernel`` selects at T
    steps (the scan's or the log-depth forward's)."""
    return KERNELS["viterbi_assoc" if _use_assoc(kernel, T)
                   else "viterbi_scan"].stage


def _decode_plain(kernel, init, first_break, emis, logp, gc, vb, brk):
    """(scores, backpointers, breaks, chosen slots) of the ``kernel``
    forward and its backtrace."""
    if _use_assoc(kernel, emis.shape[1]):
        S, BP, BR = _forward_assoc_plain(init, first_break, emis, logp, gc, vb, brk)
        return S, BP, BR, _backtrace_assoc_plain(S, BP, vb)
    S, BP, BR = _forward_plain(init, first_break, emis, logp, gc, vb, brk)
    return S, BP, BR, _backtrace_plain(S, BP, vb)


def _pack_plain(idx, BR, cand_edge, cand_offset):
    """The packed [3, B, T] i32 output: chosen edge, offset bits, break."""
    sel = idx.clamp(min=0)[..., None]
    edge = torch.gather(cand_edge, 2, sel)[..., 0]
    edge = torch.where(idx >= 0, edge, torch.full_like(edge, -1))
    offset = torch.gather(cand_offset, 2, sel)[..., 0]
    return torch.stack([edge.to(torch.int32),
                        offset.contiguous().view(torch.int32),
                        BR.to(torch.int32)])


def _aux_plain(S, vb, cand_edge):
    """The [B, 4] confidence aux: winner-vs-runner-up margin per point
    (min, sum, count) and pool exhaustion count."""
    K = S.shape[2]
    am = torch.argmax(S, dim=2, keepdim=True)
    masked = S.scatter(2, am, NEG_INF)
    top2 = masked.amax(2)
    top1 = torch.gather(S, 2, am)[..., 0]
    two_alive = (top1 > NEG_INF / 2) & (top2 > NEG_INF / 2) & vb
    marg = top1 - top2
    exhausted = (cand_edge[:, :, K - 1] >= 0) & vb
    inf = torch.full_like(marg, float("inf"))
    return torch.stack([
        torch.where(two_alive, marg, inf).amin(1),
        torch.where(two_alive, marg, torch.zeros_like(marg)).sum(1),
        two_alive.sum(1).to(torch.float32),
        exhausted.sum(1).to(torch.float32),
    ], 1)


def _step_dt(times):
    return times[:, 1:] - times[:, :-1]


def _choice_plain(idx, BP):
    """[2, B, T] i32: each point's chosen slot and the backpointer there
    (-1 where unmatched)."""
    src = torch.gather(BP, 2, idx.clamp(min=0)[..., None])[..., 0]
    return torch.stack([idx, torch.where(idx >= 0, src, -1)]).to(torch.int32)


def viterbi_scan_plain(emis, logp, gc, valid, cand_edge, cand_offset,
                       breakage_distance, times=None,
                       sp: Optional[SparseParams] = None, kernel: str = "scan",
                       with_choice: bool = False):
    """Plain PyTorch version of the carry-free scan ``chain_trace`` +
    ``backtrace`` + ``_compact`` + the confidence block + ``pack_compact``.
    emis [B, T, K]; logp [B, T-1, K, K]; gc [B, T-1]; valid [B, T] float
    0/1; cand_edge/cand_offset [B, T, K]; with ``sp`` (the sparse model's
    gap-conditioned breakage) also times [B, T].  ``kernel`` picks the
    forward: "scan" (the sequential recursion) or "assoc" (the log-depth
    one and its backtrace; the scan at T < 2).  Returns (packed
    [3, B, T] i32, aux [B, 4] f32), and with ``with_choice`` also the
    [2, B, T] i32 chosen slot and backpointer there of each point."""
    vb = valid != 0
    brk = (_scalar(breakage_distance, emis) if sp is None
           else sparse_breakage(breakage_distance, sp, _step_dt(times)))
    S, BP, BR, idx = _decode_plain(kernel, emis[:, 0], torch.ones_like(vb[:, 0]),
                                   emis, logp, gc, vb, brk)
    out = _pack_plain(idx, BR, cand_edge, cand_offset), _aux_plain(S, vb, cand_edge)
    return out + (_choice_plain(idx, BP),) if with_choice else out


def viterbi_scan(emis, logp, gc, valid, cand_edge, cand_offset,
                 breakage_distance, times=None,
                 sp: Optional[SparseParams] = None, kernel: str = "scan",
                 with_choice: bool = False):
    """Per-trace Viterbi over a batch: the CUDA kernel (its sparse
    instantiation with ``sp``, which reads ``times``) for CUDA tensors, the
    plain version for CPU tensors.  ``kernel`` "assoc" launches the
    log-depth kernel ``viterbi_assoc`` at T >= 2 (the scan kernel below).
    Returns (packed [3, B, T] i32, aux [B, 4] f32), and with
    ``with_choice`` (the dense scan kernel writes it) the [2, B, T] chosen
    slots and backpointers there."""
    if emis.device.type == "cpu":
        with stage(_decode_stage(kernel, emis.shape[1])):
            return viterbi_scan_plain(emis, logp, gc, valid, cand_edge,
                                      cand_offset, breakage_distance, times,
                                      sp, kernel, with_choice)
    dev = emis.device
    B, T, K = emis.shape
    kname = "viterbi_assoc" if _use_assoc(kernel, T) else "viterbi_scan"
    if with_choice and (kname != "viterbi_scan" or sp is not None):
        raise ValueError("the chosen slots are written by the dense scan "
                         "kernel only")
    if K not in (1, 2, 4, 8, 16, 32):
        raise ValueError("%s: K=%d must be a power of two <= 32" % (kname, K))
    check(emis, "emis", torch.float32, dev, (B, T, K))
    check(logp, "logp", torch.float32, dev, (B, T - 1, K, K))
    check(gc, "gc", torch.float32, dev, (B, T - 1))
    check(valid, "valid", torch.float32, dev, (B, T))
    check(cand_edge, "cand_edge", torch.int32, dev, (B, T, K))
    check(cand_offset, "cand_offset", torch.float32, dev, (B, T, K))
    packed = torch.empty((3, B, T), dtype=torch.int32, device=dev)
    aux = torch.empty((B, 4), dtype=torch.float32, device=dev)
    choice = (torch.empty((2, B, T), dtype=torch.int32, device=dev)
              if with_choice else None)
    if sp is not None:
        check(times, "times", torch.float32, dev, (B, T))
    if B and T:
        args = [ptr(emis), ptr(logp), ptr(gc), ptr(valid), ptr(cand_edge),
                ptr(cand_offset), B, T, K, float(breakage_distance),
                ptr(packed), ptr(aux)]
        if kname == "viterbi_assoc":  # the workspace, held until the launch is queued
            ws = _assoc_workspace(B, T, K, dev, carry=False)
            args.append(ptr(ws))
        if sp is None:
            if kname == "viterbi_scan":
                args.append(ptr(choice))
            KERNELS[kname].launch(dev, *args)
        else:
            KERNELS[kname + "[sparse]"].launch(dev, *args, ptr(times),
                                              *sp.floats())
    return (packed, aux, choice) if with_choice else (packed, aux)


# -- kernel 5: the chain, a window continuing a carried beam -------------------

def _slab_rows(slots, use_carry, S: int, device):
    """Validate a step's slot map against an [S]-row slab and move it to
    ``device``: ``slots`` [B] (S = padding row: it reads nothing and writes
    nothing), ``use_carry`` [B] bool (False = start from the inactive
    carry).  Host numpy in.  Raises when two rows name the same slot: one
    launch reads and writes the slab, which is safe only with distinct
    rows."""
    slots = np.asarray(slots)
    use = np.asarray(use_carry, bool)
    if slots.ndim != 1 or use.shape != slots.shape:
        raise ValueError("slots and use_carry must be [B], got %s and %s"
                         % (slots.shape, use.shape))
    if slots.size and (slots.min() < 0 or slots.max() > S):
        raise ValueError("slots must lie in [0, %d]" % S)
    live = slots[slots < S]
    if np.unique(live).size != live.size:
        raise ValueError("a slab row may appear at most once per step")
    if (use & (slots >= S)).any():
        raise ValueError("a padding row (slot == S) cannot use a carry")
    return upload(slots.astype(np.int32), device), upload(use, device)


def _seam_plain(dg, du, carry: TraceCarry, cand_edge, cand_offset, px, py,
                times, p: MatchParams, sp: Optional[SparseParams] = None):
    """The seam transition from the carried beam to each row's first point:
    (logp0 [B, K src, K dst], gc0 [B]).  The probe and the transition
    build run over the two-point window (carried point, first point)."""
    two = lambda c, w: torch.stack([c, w[:, 0]], 1)  # noqa: E731
    sp_dist, sp_time = seam_probe(dg, du, carry.edge, cand_edge[:, 0], plain=True)
    cand = Candidates(two(carry.edge, cand_edge), two(carry.offset, cand_offset),
                      None, None, None)
    logp0, _, gc0 = transition_build_plain(
        dg, cand, two(carry.x, px), two(carry.y, py), two(carry.t, times),
        sp_dist[:, None], sp_time[:, None], p, with_route=False, sp=sp)
    return logp0[:, 0], gc0[:, 0]


def seam_probe(dg, du, carry_edge, first_edge, plain: bool = False):
    """The seam's UBODT probe, outside the chain launch: (dist, time)
    [B, K src, K dst] of (to(carry_edge[b, i]), from(first_edge[b, j])),
    the keys the chain kernels' seam forms (an empty slot reads edge 0).
    On a gp mesh (``du`` a ``ShardedUBODT``) this is how the seam sees the
    whole table: every rank probes its range and the answers merge.
    ``plain`` probes with the plain version (the plain chain's seam)."""
    def node(edges, lane):
        rows = dg.edge_rows[torch.where(edges >= 0, edges, 0).long()]
        return rows[..., lane].contiguous().view(torch.int32)
    lookup = ubodt_lookup_plain if plain else ubodt_lookup
    d, t, _ = lookup(du, node(carry_edge, 0)[:, :, None],
                     node(first_edge, 1)[:, None, :], False)
    return d.contiguous(), t.contiguous()


def _carry_out_plain(S, idx, vb, cand_edge, cand_offset, px, py, times):
    """The beam at each row's last valid point (padded steps froze the
    scores, so S[:, T-1] is that beam), renormalised by its max."""
    B, T, K = S.shape
    any_valid = vb.any(1)
    last = (T - 1) - torch.argmax(vb.flip(1).to(torch.int32), 1)
    at = torch.where(any_valid, last, torch.zeros_like(last))
    s = S[:, T - 1]
    smax = s.amax(1, keepdim=True)
    scores = torch.where((s > NEG_INF / 2) & (smax > NEG_INF / 2), s - smax,
                         torch.full_like(s, NEG_INF))
    pick = lambda a: torch.gather(a, 1, at[:, None])[:, 0]  # noqa: E731
    gk = at[:, None, None].expand(B, 1, K)
    return TraceCarry(
        scores=scores, edge=torch.gather(cand_edge, 1, gk)[:, 0],
        offset=torch.gather(cand_offset, 1, gk)[:, 0],
        x=pick(px), y=pick(py), t=pick(times), active=any_valid,
        committed=torch.where(any_valid, pick(idx), -1).to(torch.int32))


def viterbi_chain_plain(dg: DeviceGraph, du: DeviceUBODT, emis, logp, gc,
                        px, py, times, valid, cand_edge, cand_offset,
                        p: MatchParams, carry: TraceCarry, slots=None,
                        use_carry=None, sp: Optional[SparseParams] = None,
                        kernel: str = "scan"):
    """Plain PyTorch version of the carry branch of ``chain_trace`` (the
    seam transition from the carried beam, the recursion, the seam check
    and the carry-out) + ``backtrace`` + ``_compact`` + the confidence
    block + ``pack_compact``.  Shapes as ``viterbi_scan_plain`` plus
    px/py/times [B, T] and ``carry`` with leading [B].  Returns (packed,
    aux, carry').  With ``sp`` the seam transition and every step's
    breakage follow the sparse model (the seam's gap is times[:, 0] minus
    the carried time).  ``kernel`` picks the forward after the seam, as
    ``viterbi_scan_plain``'s does.

    With ``slots`` (host [B] ints) and ``use_carry`` (host [B] bools),
    ``carry`` is the session slab with leading [S]: row b starts from
    slab[slots[b]] where use_carry[b] (else the inactive carry), and its
    successor is written back to slab[slots[b]] in place unless
    slots[b] == S; the slab itself is returned as carry'."""
    B, T, K = emis.shape
    dev = emis.device
    vb = valid != 0
    slab = None
    if slots is not None:
        slab = carry
        S = slab.scores.shape[0]
        sl, use = _slab_rows(slots, use_carry, S, dev)
        rows = sl.clamp(max=S - 1).long()
        inact = initial_carry_batch(B, K, dev)
        carry = TraceCarry(*(
            torch.where(use.view((B,) + (1,) * (g.dim() - 1)), g[rows], i)
            for g, i in zip(slab, inact)))
    logp0, gc0 = _seam_plain(dg, du, carry, cand_edge, cand_offset, px, py,
                             times, p, sp)
    total0 = carry.scores[:, :, None] + logp0  # [B, K src, K dst]
    best0 = total0.amax(1)
    brk0 = sparse_breakage(p.breakage_distance, sp, times[:, 0] - carry.t)
    broke0 = ((gc0 > brk0) | ~(best0 > NEG_INF / 2).any(1) | ~carry.active)
    init = torch.where(broke0[:, None], emis[:, 0], best0 + emis[:, 0])
    S_, _BP, BR, idx = _decode_plain(
        kernel, init, broke0, emis, logp, gc, vb,
        sparse_breakage(p.breakage_distance, sp, _step_dt(times)))
    # seam check: the committed slot must reach the window's first choice
    c = carry.committed.long()
    i0 = idx[:, 0]
    lp_c = logp0[torch.arange(B, device=dev), c.clamp(min=0), i0.clamp(min=0)]
    BR[:, 0] |= ((c >= 0) & (i0 >= 0) & ~BR[:, 0] & ~(lp_c > NEG_INF / 2)
                 & vb[:, 0])
    packed = _pack_plain(idx, BR, cand_edge, cand_offset)
    aux = _aux_plain(S_, vb, cand_edge)
    out = _carry_out_plain(S_, idx, vb, cand_edge, cand_offset, px, py, times)
    if slab is None:
        return packed, aux, out
    keep = sl < slab.scores.shape[0]
    for leaf, new in zip(slab, out):
        leaf.index_copy_(0, sl[keep].long(), new[keep])
    return packed, aux, slab


def _check_carry(c: TraceCarry, n: int, k: int, dev) -> None:
    for name, t, dt in zip(TraceCarry._fields, c, CARRY_DTYPES):
        check(t, "carry." + name, dt, dev,
              (n, k) if name in ("scores", "edge", "offset") else (n,))


def viterbi_chain(dg: DeviceGraph, du: DeviceUBODT, emis, logp, gc, px, py,
                  times, valid, cand_edge, cand_offset, p: MatchParams,
                  carry: TraceCarry, slots=None, use_carry=None,
                  sp: Optional[SparseParams] = None, kernel: str = "scan"):
    """A window continuing a carried beam: the CUDA kernel (its sparse
    instantiation with ``sp``) for CUDA tensors, the plain version for CPU
    tensors.  Arguments and results as ``viterbi_chain_plain``; with
    ``slots`` the kernel gathers, selects and scatters the slab rows
    itself, in place.  ``kernel`` "assoc" launches ``viterbi_chain_assoc``
    at T >= 2."""
    if emis.device.type == "cpu":
        with stage(_decode_stage(kernel, emis.shape[1])):
            return viterbi_chain_plain(dg, du, emis, logp, gc, px, py, times,
                                       valid, cand_edge, cand_offset, p,
                                       carry, slots, use_carry, sp, kernel)
    dev = emis.device
    B, T, K = emis.shape
    kname = "viterbi_chain_assoc" if _use_assoc(kernel, T) else "viterbi_chain"
    sharded = isinstance(du, ShardedUBODT)
    if sharded and slots is not None:
        raise ValueError("a table split over gp ranks takes the mesh's "
                         "session step (session_step_arena_mesh), not a slab")
    if K not in (1, 2, 4, 8, 16, 32):
        raise ValueError("%s: K=%d must be a power of two <= 32" % (kname, K))
    check(emis, "emis", torch.float32, dev, (B, T, K))
    check(logp, "logp", torch.float32, dev, (B, T - 1, K, K))
    check(gc, "gc", torch.float32, dev, (B, T - 1))
    for name, t in (("px", px), ("py", py), ("times", times),
                    ("valid", valid)):
        check(t, name, torch.float32, dev, (B, T))
    check(cand_edge, "cand_edge", torch.int32, dev, (B, T, K))
    check(cand_offset, "cand_offset", torch.float32, dev, (B, T, K))
    check(dg.edge_rows, "edge_rows", torch.float32, dev)
    if not sharded:
        check_table(du, dev)
    if slots is None:
        _check_carry(carry, B, K, dev)
        out = TraceCarry(*(torch.empty_like(t) for t in carry))
        sl = use = None
        S = 0
    else:
        S = carry.scores.shape[0]
        _check_carry(carry, S, K, dev)
        if len(slots) != B:
            raise ValueError("slots must be [%d], got %d" % (B, len(slots)))
        sl, use = _slab_rows(slots, use_carry, S, dev)
        out = carry  # updated in place
    packed = torch.empty((3, B, T), dtype=torch.int32, device=dev)
    aux = torch.empty((B, 4), dtype=torch.float32, device=dev)
    if B and T:
        # the seam probes the table: one lookup's fetch units; on a gp
        # mesh the seam's probe is resolved over the ranks first
        seam = (seam_probe(dg, du, carry.edge, cand_edge[:, 0]) if sharded
                else (None, None))
        if not sharded:
            note_lookup(du)
        ws = (_assoc_workspace(B, T, K, dev, carry=True)
              if kname == "viterbi_chain_assoc" else None)
        with (contextlib.nullcontext((ptr(None), [ptr(None)] * 4)) if sharded
              else table_args(du)) as (table, tier):
            args = [ptr(emis), ptr(logp), ptr(gc), ptr(valid), ptr(cand_edge),
                    ptr(cand_offset), ptr(px), ptr(py), ptr(times),
                    ptr(dg.edge_rows), table, du.bmask, int(du.wide), *tier,
                    ptr(seam[0]), ptr(seam[1]), B, T, K,
                    float(p.breakage_distance), float(p.sigma_z),
                    float(p.beta), float(p.search_radius),
                    float(p.max_route_distance_factor),
                    float(p.max_route_time_factor),
                    float(p.turn_penalty_factor),
                    *(ptr(t) for t in carry), *(ptr(t) for t in out), ptr(sl),
                    ptr(use), S, ptr(packed), ptr(aux)]
            if kname == "viterbi_chain_assoc":  # held until the launch is queued
                args.append(ptr(ws))
            if sp is None:
                KERNELS[kname].launch(dev, *args)
            else:
                KERNELS[kname + "[sparse]"].launch(dev, *args, *sp.floats())
    return packed, aux, out


def _assoc_workspace(B: int, T: int, K: int, device, carry: bool):
    """Global scratch of the assoc kernels, or None where a trace's scan
    fits in shared memory.  Per trace (csrc/viterbi_assoc.cu's
    ``level_floats``): every level's [K, K] maps, the stored prefix maps
    of the levels above the first, then every level's [K] restart vectors,
    as the library's ``viterbi_assoc_workspace`` sizes them."""
    per = _assoc_ws_floats(T, K, carry)
    return torch.empty(B * per, dtype=torch.float32, device=device) if per else None


def _assoc_ws_floats(T: int, K: int, carry: bool) -> int:
    """Floats of global workspace one trace needs (0: its scan fits in
    shared memory), from the library's ``viterbi_assoc_workspace``."""
    return library_function("viterbi_assoc", "viterbi_assoc_workspace", ctypes.c_int64,
                            [ctypes.c_int32] * 3)(T, K, int(carry))


# -- composition ---------------------------------------------------------------

class _Stages(NamedTuple):
    sweep: object
    probe: object
    build: object
    scan: object
    chain: object


_KERNELS = _Stages(candidate_sweep, ubodt_lookup, transition_build,
                   viterbi_scan, viterbi_chain)
_PLAIN = _Stages(candidate_sweep_plain, ubodt_lookup_plain,
                 transition_build_plain, viterbi_scan_plain,
                 viterbi_chain_plain)


def _precompute(st: _Stages, dg, du, px, py, times, valid, p, k, full=True,
                sp=None, dedup=False):
    """The first three stages.  ``full=False`` (the packed path) leaves
    out what the scan never reads: the candidates' dist, cx, cy and the
    route.  The probe's first edge is never needed here; ``dedup`` probes
    each distinct pair of the whole [B, T-1, K, K] key set once."""
    sw = st.sweep(dg, px, py, valid, k, p.search_radius, p.sigma_z, full)
    sp_dist, sp_time, _ = st.probe(du, sw.to_node[:, :-1, :, None],
                                   sw.from_node[:, 1:, None, :], False, dedup)
    logp, route, gc = st.build(dg, sw.cand, px, py, times, sp_dist, sp_time,
                               p, full, sp)
    return TracePre(cand=sw.cand, emis=sw.emis, logp=logp, route=route, gc=gc)


def precompute_batch(dg: DeviceGraph, du: DeviceUBODT, px, py, times, valid,
                     p: MatchParams, k: int,
                     sp: Optional[SparseParams] = None,
                     dedup: bool = False) -> TracePre:
    """Candidates, emissions and the [B, T-1, K, K] transition build over a
    [B, T] batch (``valid`` float 0/1).  The reference's ``precompute_batch``
    (probe dedup with ``dedup``), the dense model or, with ``sp``, the
    sparse one."""
    return _precompute(_KERNELS, dg, du, px, py, times, valid, p, k, sp=sp,
                       dedup=dedup)


def pack_inputs(px, py, times, valid) -> np.ndarray:
    """Host-side: one [4, B, T] f32 array from the four [B, T] batch arrays
    (valid encoded as 0.0/1.0)."""
    return np.stack([
        np.asarray(px, np.float32), np.asarray(py, np.float32),
        np.asarray(times, np.float32), np.asarray(valid).astype(np.float32),
    ])


def unpack_inputs(xin: torch.Tensor):
    """[4, B, T] -> (px, py, times, valid) with valid kept as float 0/1."""
    return xin[0], xin[1], xin[2], xin[3]


def unpack_compact(out):
    """Host-side inverse of the packed output: [3, B, T] i32 -> (edge i32,
    offset f32, breaks bool) numpy arrays."""
    out = np.asarray(out)
    return out[0], out[1].view(np.float32), out[2] != 0


def _match(st: _Stages, dg, du, xin, p, k, sp=None, dedup=False,
           kernel="scan"):
    pre = _pre_packed(st, dg, du, xin, p, k, sp, dedup)
    px, py, times, valid = unpack_inputs(xin)
    return st.scan(pre.emis, pre.logp, pre.gc, valid, pre.cand.edge,
                   pre.cand.offset, p.breakage_distance, times, sp, kernel)


def _pre_packed(st: _Stages, dg, du, xin, p, k, sp=None,
                dedup=False) -> TracePre:
    px, py, times, valid = unpack_inputs(xin)
    return _precompute(st, dg, du, px, py, times, valid, p, k, False, sp,
                       dedup)


def _chain(st: _Stages, dg, du, pre: TracePre, xin, p, carry, slots=None,
           use_carry=None, sp=None, kernel="scan"):
    px, py, times, valid = unpack_inputs(xin)
    return st.chain(dg, du, pre.emis, pre.logp, pre.gc, px, py, times, valid,
                    pre.cand.edge, pre.cand.offset, p, carry, slots,
                    use_carry, sp, kernel)


def _step(st: _Stages, dg, du, xin, p, k, carry, slots=None, use_carry=None,
          sp=None, kernel="scan"):
    return _chain(st, dg, du, _pre_packed(st, dg, du, xin, p, k, sp), xin, p,
                  carry, slots, use_carry, sp, kernel)


def match_batch_compact_packed_aux(dg: DeviceGraph, du: DeviceUBODT,
                                   xin: torch.Tensor, p: MatchParams, k: int,
                                   sp: Optional[SparseParams] = None,
                                   dedup: bool = False, kernel: str = "scan"):
    """The match program over a packed [4, B, T] f32 input: (packed
    [3, B, T] i32 = edge, offset bits, break; aux [B, 4] f32).  ``kernel``
    ("scan" or "assoc") picks the Viterbi forward of every entry point."""
    return _match(_KERNELS, dg, du, xin, p, k, sp, dedup, kernel)


def match_batch_compact_packed_aux_plain(dg: DeviceGraph, du: DeviceUBODT,
                                         xin: torch.Tensor, p: MatchParams,
                                         k: int,
                                         sp: Optional[SparseParams] = None,
                                         dedup: bool = False,
                                         kernel: str = "scan"):
    """``match_batch_compact_packed_aux`` through the plain versions, on
    whatever device the inputs are."""
    return _match(_PLAIN, dg, du, xin, p, k, sp, dedup, kernel)


def precompute_batch_packed(dg: DeviceGraph, du: DeviceUBODT, xin,
                            p: MatchParams, k: int,
                            sp: Optional[SparseParams] = None,
                            dedup: bool = False) -> TracePre:
    """The carry-independent stages (kernels 1-3) over a packed [4, B, W]
    input.  For long traces B is the chunk-major rows of many windows of a
    trace group, so one dispatch precomputes them all; the result feeds
    ``chain_batch_carry_packed_aux`` window by window (``slice_pre``).
    Leaves the scan never reads (dist, cx, cy, route) are None.  With
    ``dedup`` the probe dedups across all those windows' keys at once."""
    return _pre_packed(_KERNELS, dg, du, xin, p, k, sp, dedup)


def precompute_batch_packed_plain(dg, du, xin, p: MatchParams, k: int,
                                  sp: Optional[SparseParams] = None,
                                  dedup: bool = False):
    return _pre_packed(_PLAIN, dg, du, xin, p, k, sp, dedup)


def chain_batch_carry_packed_aux(dg: DeviceGraph, du: DeviceUBODT,
                                 pre: TracePre, xin, p: MatchParams, k: int,
                                 carry: TraceCarry,
                                 sp: Optional[SparseParams] = None,
                                 kernel: str = "scan"):
    """The carry-dependent rest of a window (kernel 5) over a precomputed
    ``pre`` (leading [B]) and the window's packed [4, B, W] input:
    (packed [3, B, W], aux [B, 4], carry').  Aux components combine across
    seams as min / + / + / +."""
    return _chain(_KERNELS, dg, du, pre, xin, p, carry, sp=sp, kernel=kernel)


def chain_batch_carry_packed_aux_plain(dg, du, pre: TracePre, xin,
                                       p: MatchParams, k: int,
                                       carry: TraceCarry,
                                       sp: Optional[SparseParams] = None,
                                       kernel: str = "scan"):
    return _chain(_PLAIN, dg, du, pre, xin, p, carry, sp=sp, kernel=kernel)


def match_batch_carry_packed(dg: DeviceGraph, du: DeviceUBODT, xin,
                             p: MatchParams, k: int, carry: TraceCarry,
                             kernel: str = "scan"):
    """The legacy per-window long-trace program (the reference's
    ``match_batch_carry_packed``): kernels 1-3 over one window's packed
    [4, B, W] rows, then the chain kernel of ``kernel`` (kernel 5 for
    "scan", ``viterbi_chain_assoc`` for "assoc") continuing ``carry``
    (leading [B]).  Returns (packed [3, B, W], carry').  The same
    operations as ``precompute_batch_packed`` + ``chain_batch_carry_packed_aux``
    over one window."""
    packed, _aux, carry = _step(_KERNELS, dg, du, xin, p, k, carry, kernel=kernel)
    return packed, carry


def match_batch_carry_packed_plain(dg, du, xin, p: MatchParams, k: int,
                                   carry: TraceCarry, kernel: str = "scan"):
    packed, _aux, carry = _step(_PLAIN, dg, du, xin, p, k, carry, kernel=kernel)
    return packed, carry


def session_step_packed(dg: DeviceGraph, du: DeviceUBODT, xin,
                        p: MatchParams, k: int, carry: TraceCarry,
                        sp: Optional[SparseParams] = None,
                        kernel: str = "scan"):
    """One incremental session step: each row of the packed [4, B, W] input
    is one session's newly arrived points (a valid prefix), continued from
    its carried beam (leading [B]).  Returns (packed, aux, carry').  ``k``
    stays the carried beam's width under the sparse model too: a
    session's beam cannot change width."""
    return _step(_KERNELS, dg, du, xin, p, k, carry, sp=sp, kernel=kernel)


def session_step_packed_plain(dg, du, xin, p: MatchParams, k: int,
                              carry: TraceCarry,
                              sp: Optional[SparseParams] = None,
                              kernel: str = "scan"):
    return _step(_PLAIN, dg, du, xin, p, k, carry, sp=sp, kernel=kernel)


def session_step_arena(dg: DeviceGraph, du: DeviceUBODT, xin, p: MatchParams,
                       k: int, slab: TraceCarry, slots, use_carry,
                       sp: Optional[SparseParams] = None,
                       kernel: str = "scan"):
    """``session_step_packed`` against the device-resident session slab
    (leading [S]): row b continues slab[slots[b]] where use_carry[b] (else
    the inactive carry) and its successor is written back to that row in
    place; padding rows carry slot == S and write nothing.  ``slots`` and
    ``use_carry`` are host [B] arrays, live slots distinct.  Returns
    (packed, aux, slab)."""
    return _step(_KERNELS, dg, du, xin, p, k, slab, slots, use_carry, sp,
                 kernel)


def session_step_arena_plain(dg, du, xin, p: MatchParams, k: int,
                             slab: TraceCarry, slots, use_carry,
                             sp: Optional[SparseParams] = None,
                             kernel: str = "scan"):
    return _step(_PLAIN, dg, du, xin, p, k, slab, slots, use_carry, sp,
                 kernel)


# -- the slot-sharded session slab on a mesh (kernel 11c) -----------------------
#
# On a device mesh the slab's [S] slot axis is split over the dp ranks,
# rank r holding slots [r * S_local, (r + 1) * S_local).  A step gathers
# each row's beam from whichever rank owns its slot as int32 bit patterns
# (zeros from every other rank), sums the ranks' blocks (exact: one
# nonzero pattern and zeros), decodes each rank's own rows on host carries
# (kernel 5's [B]-leading mode), all-gathers the successors and scatters
# each into the rank that owns its slot: the reference's
# ``_arena_gather_mesh``, ``_arena_scatter_mesh`` and
# ``session_step_arena_mesh``.

def carry_words(carry: TraceCarry) -> torch.Tensor:
    """[B, 3K + 5] int32: each row's carry as bit patterns, in the order
    scores [K], edge [K], offset [K], x, y, t, active (0/1), committed."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t.to(torch.int32)
    return torch.cat([bits(carry.scores), carry.edge, bits(carry.offset)]
                     + [bits(t)[:, None] for t in (carry.x, carry.y, carry.t,
                                                   carry.active, carry.committed)], 1)


def carry_from_words(words: torch.Tensor, k: int) -> TraceCarry:
    """``carry_words``' inverse, bit for bit."""
    def f32(w):
        return w.contiguous().view(torch.float32)
    return TraceCarry(scores=f32(words[:, :k]), edge=words[:, k:2 * k].contiguous(),
                      offset=f32(words[:, 2 * k:3 * k]), x=f32(words[:, 3 * k]),
                      y=f32(words[:, 3 * k + 1]), t=f32(words[:, 3 * k + 2]),
                      active=words[:, 3 * k + 3] != 0,
                      committed=words[:, 3 * k + 4].contiguous())


def _owned(slots: torch.Tensor, lo: int, s_local: int):
    loc = slots.long() - lo
    return loc, (loc >= 0) & (loc < s_local)


@staged("slab-shard")
def slab_gather_owned_plain(shard: TraceCarry, slots: torch.Tensor,
                            lo: int) -> torch.Tensor:
    """Plain version of ``slab_gather_owned``."""
    s_local = shard.scores.shape[0]
    loc, owned = _owned(slots, lo, s_local)
    rows = carry_words(TraceCarry(*(leaf[loc.clamp(0, s_local - 1)]
                                    for leaf in shard)))
    return torch.where(owned[:, None], rows, torch.zeros_like(rows))


@staged("slab-shard")
def slab_scatter_owned_plain(shard: TraceCarry, words: torch.Tensor,
                             slots: torch.Tensor, lo: int) -> TraceCarry:
    """Plain version of ``slab_scatter_owned``."""
    loc, owned = _owned(slots, lo, shard.scores.shape[0])
    new = carry_from_words(words[owned], shard.scores.shape[1])
    for leaf, rows in zip(shard, new):
        leaf.index_copy_(0, loc[owned], rows)
    return shard


def _slab_launch(name: str, shard: TraceCarry, slots, lo: int, words):
    dev = shard.scores.device
    s_local, k = shard.scores.shape
    if not 1 <= k <= 32:
        raise ValueError("%s: k=%d outside 1..32" % (name, k))
    _check_carry(shard, s_local, k, dev)
    check(slots, "slots", torch.int32, dev)
    check(words, "words", torch.int32, dev, (slots.shape[0], 3 * k + 5))
    KERNELS[name].launch(dev, *(ptr(t) for t in shard), s_local, lo,
                         ptr(slots), slots.shape[0], k, ptr(words))


def slab_gather_owned(shard: TraceCarry, slots: torch.Tensor,
                      lo: int) -> torch.Tensor:
    """One dp rank's side of the mesh step's gather: for each row of the
    global [B] slot map ``slots`` (int32 on the shard's device), the
    carry of ``shard`` (the rank's [S_local] slab rows, its first global
    slot ``lo``) as [B, 3K + 5] int32 bit patterns where the rank owns the
    slot, zeros elsewhere.  The CUDA kernel for a CUDA shard, the plain
    version for a CPU one."""
    if shard.scores.device.type == "cpu":
        return slab_gather_owned_plain(shard, slots, lo)
    words = torch.empty((slots.shape[0], 3 * shard.scores.shape[1] + 5),
                        dtype=torch.int32, device=shard.scores.device)
    _slab_launch("slab_gather_owned", shard, slots, lo, words)
    return words


def slab_scatter_owned(shard: TraceCarry, words: torch.Tensor,
                       slots: torch.Tensor, lo: int) -> TraceCarry:
    """One dp rank's side of the mesh step's scatter: the rows of the
    global [B, 3K + 5] carry-out ``words`` whose slots the rank owns are
    written into ``shard`` in place, the rest dropped (padding rows name
    slot S, owned by nobody).  The CUDA kernel for a CUDA shard, the plain
    version for a CPU one.  Returns the shard."""
    if shard.scores.device.type == "cpu":
        return slab_scatter_owned_plain(shard, words, slots, lo)
    _slab_launch("slab_scatter_owned", shard, slots, lo, words)
    return shard


def mesh_slot_rows(slots, use_carry, slab: Sequence[TraceCarry]):
    """A mesh step's host [B] slot map and carry mask checked against the
    ranks' slab shards (S = all shards' slots: a padding row): (the slot
    map on each rank's device, the carry mask on rank 0's)."""
    s_local = slab[0].scores.shape[0]
    sl, use = _slab_rows(slots, use_carry, s_local * len(slab),
                         slab[0].scores.device)
    return [sl.to(sh.scores.device) for sh in slab], use


def mesh_carry_in(words: torch.Tensor, use: torch.Tensor, k: int) -> TraceCarry:
    """A rank's carry-in from its rows of the psum'd [b, 3K + 5] slab
    words: the slab's carry where ``use`` ([b] bool), the inactive carry
    elsewhere."""
    b = words.shape[0]
    return TraceCarry(*(
        torch.where(use.view((b,) + (1,) * (g.dim() - 1)), g, i)
        for g, i in zip(carry_from_words(words, k),
                        initial_carry_batch(b, k, words.device))))


def session_step_arena_mesh(ranks: Sequence[tuple], xins: Sequence[torch.Tensor],
                            p: MatchParams, k: int, slab: Sequence[TraceCarry],
                            slots, use_carry, sp: Optional[SparseParams] = None,
                            kernel: str = "scan"):
    """``session_step_arena`` over a slot-sharded slab: ``ranks`` the dp
    ranks' (dg, du) views, ``xins`` each rank's [4, b_local, W] rows of the
    step (rank r holds global rows r * b_local ...), ``slab`` the ranks'
    slab shards of equal length, ``slots`` / ``use_carry`` the host [B]
    global slot map (S = all shards' slots: a padding row) and carry
    mask.  Gather (kernel 11c), psum, each rank's decode on host carries
    (``mesh_carry_in``, kernel 5), all-gather, scatter (kernel 11c): the
    packed outputs, aux and slab bytes are the single-device step's, bit
    for bit.  Returns (packed, aux) lists, one per rank; the slab shards
    change in place."""
    s_local = slab[0].scores.shape[0]
    sls, use = mesh_slot_rows(slots, use_carry, slab)
    words = collectives.psum([slab_gather_owned(sh, s, r * s_local)
                              for r, (sh, s) in enumerate(zip(slab, sls))])
    outs = []
    b_local = xins[0].shape[1]
    for r, ((dg, du), xin, w) in enumerate(zip(ranks, xins, words)):
        rows = slice(r * b_local, (r + 1) * b_local)
        carry = mesh_carry_in(w[rows], use[rows].to(w.device), k)
        outs.append(session_step_packed(dg, du, xin, p, k, carry, sp, kernel))
    cw = collectives.all_gather([carry_words(o[2]) for o in outs])
    for r, (sh, w, s) in enumerate(zip(slab, cw, sls)):
        slab_scatter_owned(sh, w, s, r * s_local)
    return [o[0] for o in outs], [o[1] for o in outs]


def match_batch_full(dg: DeviceGraph, du, px, py, times, valid,
                     p: MatchParams, k: int, plain: bool = False):
    """The reference's ``match_batch`` over [B, T] arrays (the scan
    forward, the dense model, no dedup), keeping what the segment
    histogram reads: (``TracePre`` with the candidates' every field and the
    route, packed [3, B, T] i32, aux [B, 4] f32, choice [2, B, T] i32 =
    each point's chosen slot and the backpointer there).  ``plain`` runs
    the plain versions."""
    st = _PLAIN if plain else _KERNELS
    valid = valid.to(torch.float32)
    pre = _precompute(st, dg, du, px, py, times, valid, p, k)
    packed, aux, choice = st.scan(pre.emis, pre.logp, pre.gc, valid,
                                  pre.cand.edge, pre.cand.offset,
                                  p.breakage_distance, with_choice=True)
    return pre, packed, aux, choice
