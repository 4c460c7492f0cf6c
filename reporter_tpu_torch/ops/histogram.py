"""The per-segment histogram of a decoded batch (kernel 11b).

The reduction of ``reporter_tpu/parallel/mesh.py:75``
``match_and_histogram``: per OSMLR segment, matched points, traces that
touched it (exactly one per trace and segment, re-entries included),
seconds and route metres between consecutive points on it.  The inputs
are the scan's ``choice`` output ([2, B, T]: each point's chosen slot and
the backpointer there), the transition build's route [B, T-1, K, K], the
candidates' edges, the packed output's break plane, the times and the
graph's ``edge_seg``.

``segment_histogram`` launches ``csrc/segment_histogram.cu`` for CUDA
tensors and runs ``segment_histogram_plain`` (the reference's four
``segment_sum``s and its per-row sort with first occurrence) for CPU
tensors.  The counts are exact; the two float sums are taken in another
order by the kernel (each row's runs, then atomics), so they agree to
rounding.  The kernel's launch zeroes its output itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.attrib import staged
from ._kernels import KERNELS, check, ptr


class SegmentHistogram(NamedTuple):
    """Per-OSMLR-segment aggregates over the batch, each [S] float32."""

    point_count: torch.Tensor  # matched points per segment
    trace_count: torch.Tensor  # traces that touched the segment
    time_in_segment: torch.Tensor  # summed seconds between consecutive points
    distance_in_segment: torch.Tensor  # summed route metres


def chosen_route(choice: torch.Tensor, route: torch.Tensor) -> torch.Tensor:
    """[B, T] f32: the route metres of the step into each point's chosen
    slot from its backpointer, +inf where the point is unmatched, the step
    broke or nothing connected (and at t = 0): the reference's
    ``route_dist``."""
    idx, src = choice[0].long(), choice[1].long()
    B, T = idx.shape
    inf = torch.full((B, 1), float("inf"), dtype=torch.float32,
                     device=route.device)
    if T < 2:
        return inf[:, :T]
    K = route.shape[-1]
    flat = route.reshape(B, T - 1, K * K)
    at = (src[:, 1:].clamp(min=0) * K + idx[:, 1:].clamp(min=0))[..., None]
    r = torch.gather(flat, 2, at)[..., 0]
    r = torch.where((idx[:, 1:] >= 0) & (src[:, 1:] >= 0), r,
                    torch.full_like(r, float("inf")))
    return torch.cat([inf, r], 1)


def point_segments(choice: torch.Tensor, cand_edge: torch.Tensor,
                   edge_seg: torch.Tensor) -> torch.Tensor:
    """[B, T] i64: each point's segment, -1 where unmatched or the chosen
    edge has none."""
    idx = choice[0].long()
    edge = torch.gather(cand_edge, 2, idx.clamp(min=0)[..., None])[..., 0]
    seg = edge_seg[edge.clamp(min=0).long()].long()
    return torch.where(idx >= 0, seg, torch.full_like(seg, -1))


def _segment_sum(values: torch.Tensor, bins: torch.Tensor, S: int):
    """``jax.ops.segment_sum`` over S + 1 bins, [:S]: a bin outside [0, S]
    (an ``edge_seg`` entry past the segment count) is dropped, as there."""
    bins = bins.reshape(-1)
    bins = torch.where((bins >= 0) & (bins <= S), bins, torch.full_like(bins, S))
    out = torch.zeros(S + 1, dtype=torch.float32, device=values.device)
    return out.scatter_add_(0, bins, values.reshape(-1))[:S]


@staged("segment-histogram")
def segment_histogram_plain(choice, route, cand_edge, breaks, times,
                            edge_seg, num_segments: int) -> SegmentHistogram:
    """Plain PyTorch version of ``segment_histogram``: the reference's
    overflow-bin segment sums and its per-row sort, first occurrences kept."""
    S = int(num_segments)
    seg = point_segments(choice, cand_edge, edge_seg)
    flat = torch.where(seg >= 0, seg, torch.full_like(seg, S))
    ones = torch.ones_like(flat, dtype=torch.float32)
    point_count = _segment_sum(ones, flat, S)
    brk = breaks != 0
    same = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] >= 0) & ~brk[:, 1:]
    zero = torch.zeros_like(times[:, 1:])
    dt = torch.where(same, times[:, 1:] - times[:, :-1], zero)
    rd = chosen_route(choice, route)[:, 1:]
    dd = torch.where(same & torch.isfinite(rd), rd, zero)
    step = torch.where(same, seg[:, 1:], torch.full_like(seg[:, 1:], S))
    srt = torch.sort(flat, dim=1).values
    first = torch.cat([torch.ones_like(srt[:, :1], dtype=torch.bool),
                       srt[:, 1:] != srt[:, :-1]], 1)
    touch = torch.where(first, srt, torch.full_like(srt, S))
    return SegmentHistogram(point_count, _segment_sum(ones, touch, S),
                            _segment_sum(dt, step, S), _segment_sum(dd, step, S))


def segment_histogram(choice, route, cand_edge, breaks, times, edge_seg,
                      num_segments: int) -> SegmentHistogram:
    """The per-segment histogram of a decoded [B, T] batch: ``choice``
    [2, B, T] i32 (the scan's chosen slots and backpointers), ``route``
    [B, T-1, K, K] f32, ``cand_edge`` [B, T, K] i32, ``breaks`` [B, T] i32
    (the packed output's break plane), ``times`` [B, T] f32, ``edge_seg``
    [E] i32.  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if choice.device.type == "cpu":
        return segment_histogram_plain(choice, route, cand_edge, breaks,
                                       times, edge_seg, num_segments)
    dev = choice.device
    _, B, T = choice.shape
    K = cand_edge.shape[2]
    S = int(num_segments)
    check(choice, "choice", torch.int32, dev, (2, B, T))
    check(route, "route", torch.float32, dev, (B, max(T - 1, 0), K, K))
    check(cand_edge, "cand_edge", torch.int32, dev, (B, T, K))
    check(breaks, "breaks", torch.int32, dev, (B, T))
    check(times, "times", torch.float32, dev, (B, T))
    check(edge_seg, "edge_seg", torch.int32, dev)
    if not (B and T and S):
        return SegmentHistogram(*torch.zeros((4, S), dtype=torch.float32, device=dev))
    out = torch.empty((4, S), dtype=torch.float32, device=dev)  # zeroed by the launch
    KERNELS["segment_histogram"].launch(
        dev, ptr(choice), ptr(route), ptr(cand_edge), ptr(breaks),
        ptr(times), ptr(edge_seg), B, T, K, S, ptr(out))
    return SegmentHistogram(*out)
