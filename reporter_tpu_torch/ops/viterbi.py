"""Batched HMM map matching: emission, transition, Viterbi (kernels 3, 4).

The port of the dense, carry-free scan path of
``reporter_tpu/ops/viterbi.py``.  Shapes, per [B, T] padded batch:

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

Discontinuities follow the reference (and Meili): consecutive points
further apart than ``breakage_distance``, or a step that no feasible route
connects, restart the HMM at that point and record a break.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors.  ``match_batch_compact_packed_aux``
composes the four wrappers; ``match_batch_compact_packed_aux_plain``
composes the four plain versions (the reference a chip run holds the
kernels against on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

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


class TracePre(NamedTuple):
    """Everything the Viterbi forward consumes, [B, ...] leaves."""

    cand: Candidates  # [B, T, K]
    emis: torch.Tensor  # [B, T, K] emission log-probs
    logp: torch.Tensor  # [B, T-1, K, K] transition log-probs per step
    route: Optional[torch.Tensor]  # [B, T-1, K, K] route distances per step (None on the packed path)
    gc: torch.Tensor  # [B, T-1] straight-line metres between consecutive points


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
                           with_route: bool = True):
    """Plain PyTorch version of the dense ``_transition_matrix`` over a
    batch.  cand leaves [B, T, K]; px/py/times [B, T]; sp_dist/sp_time
    [B, T-1, K, K].  Returns (logp, route [B, T-1, K, K], gc [B, T-1]);
    route is None unless ``with_route``."""
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
    beta = f(p.beta)
    logp = -(route - gc4).abs() / beta
    turn = angle_diff(era[..., 5], erb[..., 4]).abs()
    pen = p.turn_penalty_factor.to(px.device) * turn / (_PI * beta)
    logp = logp - torch.where(same_known, torch.zeros_like(pen), pen)
    logp = torch.where(feasible, logp, torch.full_like(logp, NEG_INF))
    route = torch.where(feasible, route, torch.full_like(route, float("inf")))
    return logp, route if with_route else None, gc


def transition_build(dg: DeviceGraph, cand: Candidates, px, py, times,
                     sp_dist, sp_time, p: MatchParams, with_route: bool = True):
    """Transition log-probs and routes for every step of a batch: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  With
    ``with_route=False`` the route is neither written nor returned (None):
    the Viterbi scan never reads it."""
    if px.device.type == "cpu":
        return transition_build_plain(dg, cand, px, py, times, sp_dist,
                                      sp_time, p, with_route)
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
        KERNELS["transition_build"].launch(
            dev, ptr(cand.edge), ptr(cand.offset), ptr(px), ptr(py),
            ptr(times), ptr(dg.edge_rows), ptr(sp_dist), ptr(sp_time), B, T,
            K, float(p.sigma_z), float(p.beta), float(p.search_radius),
            float(p.max_route_distance_factor),
            float(p.max_route_time_factor), float(p.turn_penalty_factor),
            ptr(logp), ptr(route), ptr(gc))
    return logp, route, gc


# -- kernel 4: scan recursion, backtrace, compact gather, confidence -----------

def viterbi_scan_plain(emis, logp, gc, valid, cand_edge, cand_offset,
                       breakage_distance):
    """Plain PyTorch version of the carry-free scan ``chain_trace`` +
    ``backtrace`` + ``_compact`` + the confidence block + ``pack_compact``.
    emis [B, T, K]; logp [B, T-1, K, K]; gc [B, T-1]; valid [B, T] float
    0/1; cand_edge/cand_offset [B, T, K].  Returns (packed [3, B, T] i32,
    aux [B, 4] f32)."""
    B, T, K = emis.shape
    dev = emis.device
    vb = valid != 0
    brk = _scalar(breakage_distance, emis)
    scores = emis[:, 0]
    scores_mat = [scores]
    backptr = [torch.full((B, K), -1, dtype=torch.int64, device=dev)]
    breaks = [vb[:, 0]]
    for t in range(1, T):
        total = scores[:, :, None] + logp[:, t - 1]  # [B, K src, K dst]
        best_src = torch.argmax(total, dim=1)  # first maximum
        best_val = torch.gather(total, 1, best_src[:, None, :])[:, 0]
        connected = best_val > NEG_INF / 2
        broke = (gc[:, t - 1] > brk) | ~connected.any(1)
        new = torch.where(broke[:, None], emis[:, t], best_val + emis[:, t])
        vt = vb[:, t, None]
        new = torch.where(vt, new, scores)  # padding: freeze
        bp = torch.where(broke[:, None] | ~connected, -1, best_src)
        bp = torch.where(vt, bp, -2)  # -2 = padded step
        scores = new
        scores_mat.append(scores)
        backptr.append(bp)
        breaks.append(broke & vb[:, t])
    S = torch.stack(scores_mat, 1)  # [B, T, K]
    BP = torch.stack(backptr, 1)
    BR = torch.stack(breaks, 1)

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
    idx = torch.stack(idx, 1)  # [B, T]

    sel = idx.clamp(min=0)[..., None]
    edge = torch.gather(cand_edge, 2, sel)[..., 0]
    edge = torch.where(idx >= 0, edge, torch.full_like(edge, -1))
    offset = torch.gather(cand_offset, 2, sel)[..., 0]
    packed = torch.stack([edge.to(torch.int32),
                          offset.contiguous().view(torch.int32),
                          BR.to(torch.int32)])

    # confidence: winner-vs-runner-up margin per point, pool exhaustion
    am = torch.argmax(S, dim=2, keepdim=True)
    masked = S.scatter(2, am, NEG_INF)
    top2 = masked.amax(2)
    top1 = torch.gather(S, 2, am)[..., 0]
    two_alive = (top1 > NEG_INF / 2) & (top2 > NEG_INF / 2) & vb
    marg = top1 - top2
    exhausted = (cand_edge[:, :, K - 1] >= 0) & vb
    inf = torch.full_like(marg, float("inf"))
    aux = torch.stack([
        torch.where(two_alive, marg, inf).amin(1),
        torch.where(two_alive, marg, torch.zeros_like(marg)).sum(1),
        two_alive.sum(1).to(torch.float32),
        exhausted.sum(1).to(torch.float32),
    ], 1)
    return packed, aux


def viterbi_scan(emis, logp, gc, valid, cand_edge, cand_offset,
                 breakage_distance):
    """Per-trace Viterbi over a batch: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Returns (packed [3, B, T] i32,
    aux [B, 4] f32)."""
    if emis.device.type == "cpu":
        return viterbi_scan_plain(emis, logp, gc, valid, cand_edge,
                                  cand_offset, breakage_distance)
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
    if B and T:
        KERNELS["viterbi_scan"].launch(
            dev, ptr(emis), ptr(logp), ptr(gc), ptr(valid), ptr(cand_edge),
            ptr(cand_offset), B, T, K, float(breakage_distance), ptr(packed),
            ptr(aux))
    return packed, aux


# -- composition ---------------------------------------------------------------

def _precompute(sweep, probe, build, dg, du, px, py, times, valid, p, k,
                full=True):
    """The first three stages.  ``full=False`` (the packed path) leaves
    out what the scan never reads: the candidates' dist, cx, cy and the
    route.  The probe's first edge is never needed here."""
    sw = sweep(dg, px, py, valid, k, p.search_radius, p.sigma_z, full)
    sp_dist, sp_time, _ = probe(du, sw.to_node[:, :-1, :, None],
                                sw.from_node[:, 1:, None, :], False)
    logp, route, gc = build(dg, sw.cand, px, py, times, sp_dist, sp_time, p,
                            full)
    return TracePre(cand=sw.cand, emis=sw.emis, logp=logp, route=route, gc=gc)


def precompute_batch(dg: DeviceGraph, du: DeviceUBODT, px, py, times, valid,
                     p: MatchParams, k: int) -> TracePre:
    """Candidates, emissions and the [B, T-1, K, K] transition build over a
    [B, T] batch (``valid`` float 0/1).  The reference's ``precompute_batch``
    with probe dedup off and the dense model."""
    return _precompute(candidate_sweep, ubodt_lookup, transition_build,
                       dg, du, px, py, times, valid, p, k)


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


def _match(stages, dg, du, xin, p, k):
    sweep, probe, build, scan = stages
    px, py, times, valid = unpack_inputs(xin)
    pre = _precompute(sweep, probe, build, dg, du, px, py, times, valid, p, k,
                      full=False)
    return scan(pre.emis, pre.logp, pre.gc, valid, pre.cand.edge,
                pre.cand.offset, p.breakage_distance)


def match_batch_compact_packed_aux(dg: DeviceGraph, du: DeviceUBODT,
                                   xin: torch.Tensor, p: MatchParams, k: int):
    """The match program over a packed [4, B, T] f32 input: (packed
    [3, B, T] i32 = edge, offset bits, break; aux [B, 4] f32)."""
    return _match((candidate_sweep, ubodt_lookup, transition_build,
                   viterbi_scan), dg, du, xin, p, k)


def match_batch_compact_packed_aux_plain(dg: DeviceGraph, du: DeviceUBODT,
                                         xin: torch.Tensor, p: MatchParams,
                                         k: int):
    """``match_batch_compact_packed_aux`` through the four plain versions,
    on whatever device the inputs are."""
    return _match((candidate_sweep_plain, ubodt_lookup_plain,
                   transition_build_plain, viterbi_scan_plain),
                  dg, du, xin, p, k)
