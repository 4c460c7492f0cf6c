"""Batched HMM map matching: emission, transition, Viterbi (kernels 3-5).

The port of ``reporter_tpu/ops/viterbi.py``'s dense and sparse-gap
programs without probe dedup or the associative scan, a window
that starts fresh and a window that continues a carried beam.  Shapes,
per [B, T] padded batch:

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

Discontinuities follow the reference (and Meili): consecutive points
further apart than ``breakage_distance``, or a step that no feasible route
connects, restart the HMM at that point and record a break.

Long traces run in fixed windows: ``precompute_batch_packed`` (kernels
1-3) over all of a group's windows at once, then one
``chain_batch_carry_packed_aux`` (kernel 5) per window, the carry chaining
them.  A session step runs both over one small window, the carry in
[B]-leading tensors (``session_step_packed``) or in the device slab
(``session_step_arena``).

Every entry point takes ``sp=None``: with a ``SparseParams`` it runs the
sparse-gap model (the reference's ``*_packed_sparse`` programs) through
the SPARSE instantiations of kernels 3-5.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors.  Every packed entry point composes
the wrappers; its ``_plain`` twin composes the plain versions (the
reference a chip run holds the kernels against on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import upload
from ..tiles.arrays import DeviceGraph
from ..tiles.ubodt import DeviceUBODT
from ._kernels import KERNELS, check, ptr
from .candidates import (
    NEG_INF, Candidates, _scalar, candidate_sweep, candidate_sweep_plain, fma,
    hypot_like_jax,
)
from .hashtable import ubodt_lookup, ubodt_lookup_plain

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


def viterbi_scan_plain(emis, logp, gc, valid, cand_edge, cand_offset,
                       breakage_distance, times=None,
                       sp: Optional[SparseParams] = None):
    """Plain PyTorch version of the carry-free scan ``chain_trace`` +
    ``backtrace`` + ``_compact`` + the confidence block + ``pack_compact``.
    emis [B, T, K]; logp [B, T-1, K, K]; gc [B, T-1]; valid [B, T] float
    0/1; cand_edge/cand_offset [B, T, K]; with ``sp`` (the sparse model's
    gap-conditioned breakage) also times [B, T].  Returns (packed
    [3, B, T] i32, aux [B, 4] f32)."""
    vb = valid != 0
    brk = (_scalar(breakage_distance, emis) if sp is None
           else sparse_breakage(breakage_distance, sp, _step_dt(times)))
    S, BP, BR = _forward_plain(emis[:, 0], torch.ones_like(vb[:, 0]), emis,
                               logp, gc, vb, brk)
    idx = _backtrace_plain(S, BP, vb)
    return _pack_plain(idx, BR, cand_edge, cand_offset), _aux_plain(S, vb, cand_edge)


def viterbi_scan(emis, logp, gc, valid, cand_edge, cand_offset,
                 breakage_distance, times=None,
                 sp: Optional[SparseParams] = None):
    """Per-trace Viterbi over a batch: the CUDA kernel (its sparse
    instantiation with ``sp``, which reads ``times``) for CUDA tensors, the
    plain version for CPU tensors.  Returns (packed [3, B, T] i32, aux
    [B, 4] f32)."""
    if emis.device.type == "cpu":
        return viterbi_scan_plain(emis, logp, gc, valid, cand_edge,
                                  cand_offset, breakage_distance, times, sp)
    dev = emis.device
    B, T, K = emis.shape
    if K not in (1, 2, 4, 8, 16, 32):
        raise ValueError("viterbi_scan: K=%d must be a power of two <= 32" % K)
    check(emis, "emis", torch.float32, dev, (B, T, K))
    check(logp, "logp", torch.float32, dev, (B, T - 1, K, K))
    check(gc, "gc", torch.float32, dev, (B, T - 1))
    check(valid, "valid", torch.float32, dev, (B, T))
    check(cand_edge, "cand_edge", torch.int32, dev, (B, T, K))
    check(cand_offset, "cand_offset", torch.float32, dev, (B, T, K))
    packed = torch.empty((3, B, T), dtype=torch.int32, device=dev)
    aux = torch.empty((B, 4), dtype=torch.float32, device=dev)
    if sp is not None:
        check(times, "times", torch.float32, dev, (B, T))
    if B and T:
        args = [ptr(emis), ptr(logp), ptr(gc), ptr(valid), ptr(cand_edge),
                ptr(cand_offset), B, T, K, float(breakage_distance),
                ptr(packed), ptr(aux)]
        if sp is None:
            KERNELS["viterbi_scan"].launch(dev, *args)
        else:
            KERNELS["viterbi_scan[sparse]"].launch(dev, *args, ptr(times),
                                                   *sp.floats())
    return packed, aux


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
    edge2 = two(carry.edge, cand_edge)  # [B, 2, K]
    rows = dg.edge_rows[torch.where(edge2 >= 0, edge2, 0).long()]
    to_a = rows[:, :1, :, 0].contiguous().view(torch.int32)  # [B, 1, K]
    from_b = rows[:, 1:, :, 1].contiguous().view(torch.int32)
    sp_dist, sp_time, _ = ubodt_lookup_plain(du, to_a[..., :, None],
                                             from_b[..., None, :], False)
    cand = Candidates(edge2, two(carry.offset, cand_offset), None, None, None)
    logp0, _, gc0 = transition_build_plain(
        dg, cand, two(carry.x, px), two(carry.y, py), two(carry.t, times),
        sp_dist, sp_time, p, with_route=False, sp=sp)
    return logp0[:, 0], gc0[:, 0]


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
                        use_carry=None, sp: Optional[SparseParams] = None):
    """Plain PyTorch version of the carry branch of ``chain_trace`` (the
    seam transition from the carried beam, the recursion, the seam check
    and the carry-out) + ``backtrace`` + ``_compact`` + the confidence
    block + ``pack_compact``.  Shapes as ``viterbi_scan_plain`` plus
    px/py/times [B, T] and ``carry`` with leading [B].  Returns (packed,
    aux, carry').  With ``sp`` the seam transition and every step's
    breakage follow the sparse model (the seam's gap is times[:, 0] minus
    the carried time).

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
    S_, BP, BR = _forward_plain(
        init, broke0, emis, logp, gc, vb,
        sparse_breakage(p.breakage_distance, sp, _step_dt(times)))
    idx = _backtrace_plain(S_, BP, vb)
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
                  sp: Optional[SparseParams] = None):
    """A window continuing a carried beam: the CUDA kernel (its sparse
    instantiation with ``sp``) for CUDA tensors, the plain version for CPU
    tensors.  Arguments and results as ``viterbi_chain_plain``; with
    ``slots`` the kernel gathers, selects and scatters the slab rows
    itself, in place."""
    if emis.device.type == "cpu":
        return viterbi_chain_plain(dg, du, emis, logp, gc, px, py, times,
                                   valid, cand_edge, cand_offset, p, carry,
                                   slots, use_carry, sp)
    dev = emis.device
    B, T, K = emis.shape
    if K not in (1, 2, 4, 8, 16, 32):
        raise ValueError("viterbi_chain: K=%d must be a power of two <= 32" % K)
    check(emis, "emis", torch.float32, dev, (B, T, K))
    check(logp, "logp", torch.float32, dev, (B, T - 1, K, K))
    check(gc, "gc", torch.float32, dev, (B, T - 1))
    for name, t in (("px", px), ("py", py), ("times", times),
                    ("valid", valid)):
        check(t, name, torch.float32, dev, (B, T))
    check(cand_edge, "cand_edge", torch.int32, dev, (B, T, K))
    check(cand_offset, "cand_offset", torch.float32, dev, (B, T, K))
    check(dg.edge_rows, "edge_rows", torch.float32, dev)
    check(du.packed, "packed", torch.int32, dev)
    if du.packed.data_ptr() % 16:
        raise ValueError("packed table must be 16-byte aligned")
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
        args = [ptr(emis), ptr(logp), ptr(gc), ptr(valid), ptr(cand_edge),
                ptr(cand_offset), ptr(px), ptr(py), ptr(times),
                ptr(dg.edge_rows), ptr(du.packed), du.bmask, B, T, K,
                float(p.breakage_distance), float(p.sigma_z), float(p.beta),
                float(p.search_radius), float(p.max_route_distance_factor),
                float(p.max_route_time_factor), float(p.turn_penalty_factor),
                *(ptr(t) for t in carry), *(ptr(t) for t in out), ptr(sl),
                ptr(use), S, ptr(packed), ptr(aux)]
        if sp is None:
            KERNELS["viterbi_chain"].launch(dev, *args)
        else:
            KERNELS["viterbi_chain[sparse]"].launch(dev, *args, *sp.floats())
    return packed, aux, out


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
                sp=None):
    """The first three stages.  ``full=False`` (the packed path) leaves
    out what the scan never reads: the candidates' dist, cx, cy and the
    route.  The probe's first edge is never needed here."""
    sw = st.sweep(dg, px, py, valid, k, p.search_radius, p.sigma_z, full)
    sp_dist, sp_time, _ = st.probe(du, sw.to_node[:, :-1, :, None],
                                   sw.from_node[:, 1:, None, :], False)
    logp, route, gc = st.build(dg, sw.cand, px, py, times, sp_dist, sp_time,
                               p, full, sp)
    return TracePre(cand=sw.cand, emis=sw.emis, logp=logp, route=route, gc=gc)


def precompute_batch(dg: DeviceGraph, du: DeviceUBODT, px, py, times, valid,
                     p: MatchParams, k: int,
                     sp: Optional[SparseParams] = None) -> TracePre:
    """Candidates, emissions and the [B, T-1, K, K] transition build over a
    [B, T] batch (``valid`` float 0/1).  The reference's ``precompute_batch``
    with probe dedup off, the dense model or, with ``sp``, the sparse one."""
    return _precompute(_KERNELS, dg, du, px, py, times, valid, p, k, sp=sp)


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


def _match(st: _Stages, dg, du, xin, p, k, sp=None):
    pre = _pre_packed(st, dg, du, xin, p, k, sp)
    px, py, times, valid = unpack_inputs(xin)
    return st.scan(pre.emis, pre.logp, pre.gc, valid, pre.cand.edge,
                   pre.cand.offset, p.breakage_distance, times, sp)


def _pre_packed(st: _Stages, dg, du, xin, p, k, sp=None) -> TracePre:
    px, py, times, valid = unpack_inputs(xin)
    return _precompute(st, dg, du, px, py, times, valid, p, k, False, sp)


def _chain(st: _Stages, dg, du, pre: TracePre, xin, p, carry, slots=None,
           use_carry=None, sp=None):
    px, py, times, valid = unpack_inputs(xin)
    return st.chain(dg, du, pre.emis, pre.logp, pre.gc, px, py, times, valid,
                    pre.cand.edge, pre.cand.offset, p, carry, slots,
                    use_carry, sp)


def _step(st: _Stages, dg, du, xin, p, k, carry, slots=None, use_carry=None,
          sp=None):
    return _chain(st, dg, du, _pre_packed(st, dg, du, xin, p, k, sp), xin, p,
                  carry, slots, use_carry, sp)


def match_batch_compact_packed_aux(dg: DeviceGraph, du: DeviceUBODT,
                                   xin: torch.Tensor, p: MatchParams, k: int,
                                   sp: Optional[SparseParams] = None):
    """The match program over a packed [4, B, T] f32 input: (packed
    [3, B, T] i32 = edge, offset bits, break; aux [B, 4] f32)."""
    return _match(_KERNELS, dg, du, xin, p, k, sp)


def match_batch_compact_packed_aux_plain(dg: DeviceGraph, du: DeviceUBODT,
                                         xin: torch.Tensor, p: MatchParams,
                                         k: int,
                                         sp: Optional[SparseParams] = None):
    """``match_batch_compact_packed_aux`` through the plain versions, on
    whatever device the inputs are."""
    return _match(_PLAIN, dg, du, xin, p, k, sp)


def precompute_batch_packed(dg: DeviceGraph, du: DeviceUBODT, xin,
                            p: MatchParams, k: int,
                            sp: Optional[SparseParams] = None) -> TracePre:
    """The carry-independent stages (kernels 1-3) over a packed [4, B, W]
    input.  For long traces B is the chunk-major rows of many windows of a
    trace group, so one dispatch precomputes them all; the result feeds
    ``chain_batch_carry_packed_aux`` window by window (``slice_pre``).
    Leaves the scan never reads (dist, cx, cy, route) are None."""
    return _pre_packed(_KERNELS, dg, du, xin, p, k, sp)


def precompute_batch_packed_plain(dg, du, xin, p: MatchParams, k: int,
                                  sp: Optional[SparseParams] = None):
    return _pre_packed(_PLAIN, dg, du, xin, p, k, sp)


def chain_batch_carry_packed_aux(dg: DeviceGraph, du: DeviceUBODT,
                                 pre: TracePre, xin, p: MatchParams, k: int,
                                 carry: TraceCarry,
                                 sp: Optional[SparseParams] = None):
    """The carry-dependent rest of a window (kernel 5) over a precomputed
    ``pre`` (leading [B]) and the window's packed [4, B, W] input:
    (packed [3, B, W], aux [B, 4], carry').  Aux components combine across
    seams as min / + / + / +."""
    return _chain(_KERNELS, dg, du, pre, xin, p, carry, sp=sp)


def chain_batch_carry_packed_aux_plain(dg, du, pre: TracePre, xin,
                                       p: MatchParams, k: int,
                                       carry: TraceCarry,
                                       sp: Optional[SparseParams] = None):
    return _chain(_PLAIN, dg, du, pre, xin, p, carry, sp=sp)


def session_step_packed(dg: DeviceGraph, du: DeviceUBODT, xin,
                        p: MatchParams, k: int, carry: TraceCarry,
                        sp: Optional[SparseParams] = None):
    """One incremental session step: each row of the packed [4, B, W] input
    is one session's newly arrived points (a valid prefix), continued from
    its carried beam (leading [B]).  Returns (packed, aux, carry').  ``k``
    stays the carried beam's width under the sparse model too: a
    session's beam cannot change width."""
    return _step(_KERNELS, dg, du, xin, p, k, carry, sp=sp)


def session_step_packed_plain(dg, du, xin, p: MatchParams, k: int,
                              carry: TraceCarry,
                              sp: Optional[SparseParams] = None):
    return _step(_PLAIN, dg, du, xin, p, k, carry, sp=sp)


def session_step_arena(dg: DeviceGraph, du: DeviceUBODT, xin, p: MatchParams,
                       k: int, slab: TraceCarry, slots, use_carry,
                       sp: Optional[SparseParams] = None):
    """``session_step_packed`` against the device-resident session slab
    (leading [S]): row b continues slab[slots[b]] where use_carry[b] (else
    the inactive carry) and its successor is written back to that row in
    place; padding rows carry slot == S and write nothing.  ``slots`` and
    ``use_carry`` are host [B] arrays, live slots distinct.  Returns
    (packed, aux, slab)."""
    return _step(_KERNELS, dg, du, xin, p, k, slab, slots, use_carry, sp)


def session_step_arena_plain(dg, du, xin, p: MatchParams, k: int,
                             slab: TraceCarry, slots, use_carry,
                             sp: Optional[SparseParams] = None):
    return _step(_PLAIN, dg, du, xin, p, k, slab, slots, use_carry, sp)
