"""UBODT probe-outcome counters: a sampled diagnostic, off the match
program.

The port of ``reporter_tpu/ops/diagnostics.py`` ``ubodt_probe_stats``: how
often the fleet's candidate pairs miss the delta-bounded table, how many
of those misses force a transition break, how many are provable delta
truncations, and the in-batch probe redundancy that dedup removes.  The
composition is kernel 1 (candidates) -> kernel 2 (the plain probe) ->
``probe_stats`` (``csrc/probe_stats.cu``) -> the claim kernel in count
mode over the pairs that needed a probe.
"""

from __future__ import annotations

import torch

from ..obs.attrib import staged
from ._kernels import KERNELS, check, ptr
from .candidates import candidate_sweep, candidate_sweep_plain, hypot_like_jax
from .hashtable import (
    count_distinct_pairs, count_distinct_pairs_plain, ubodt_lookup,
    ubodt_lookup_plain,
)
from .viterbi import MatchParams, unpack_inputs


def _keys(sw):
    """The probe's [B, T-1, K, K] key grid as a broadcast of [B, T, K]."""
    return sw.to_node[:, :-1, :, None], sw.from_node[:, 1:, None, :]


@staged("probe-stats")
def probe_outcomes_plain(dist, cand_edge, valid, px, py, breakage_distance,
                         delta: float):
    """Plain version of ``probe_outcomes``: (counts int32 [4], need bool
    [B, T-1, K, K])."""
    ea = cand_edge[:, :-1, :, None]
    eb = cand_edge[:, 1:, None, :]
    v = (valid[:, :-1] != 0) & (valid[:, 1:] != 0)
    gc = hypot_like_jax(px[:, 1:] - px[:, :-1], py[:, 1:] - py[:, :-1])
    need = (ea >= 0) & (eb >= 0) & v[:, :, None, None] & (ea != eb)
    miss = need & ~torch.isfinite(dist)
    costly = miss & (gc <= breakage_distance)[:, :, None, None]
    beyond = costly & (gc > torch.tensor(delta, dtype=torch.float32))[
        :, :, None, None]
    counts = torch.stack([m.sum().to(torch.int32)
                          for m in (need, miss, costly, beyond)])
    return counts, need


def probe_outcomes(dist, cand_edge, valid, px, py, breakage_distance,
                   delta: float):
    """The ``probe_stats`` kernel over a probe's [B, T-1, K, K] output
    ``dist`` and its candidates' edges [B, T, K] (``valid``, ``px``, ``py``
    [B, T] f32): (stats int32 [5] = pairs needing a probe, misses, costly
    misses, beyond-delta misses, 0; need uint8 [B, T-1, K, K]).  CPU
    tensors run the plain version; the kernel takes K of at most 32."""
    dev = dist.device
    if dev.type == "cpu":
        counts, need = probe_outcomes_plain(dist, cand_edge, valid, px, py,
                                            breakage_distance, delta)
        return (torch.cat([counts, counts.new_zeros(1)]),
                need.to(torch.uint8))
    B, T = px.shape
    K = cand_edge.shape[-1]
    if K > 32:
        raise ValueError("probe_stats: k=%d outside 1..32" % K)
    check(dist, "dist", torch.float32, dev, (B, T - 1, K, K))
    check(cand_edge, "cand_edge", torch.int32, dev, (B, T, K))
    for name, t in (("valid", valid), ("px", px), ("py", py)):
        check(t, name, torch.float32, dev, (B, T))
    stats = torch.empty(5, dtype=torch.int32, device=dev)
    need = torch.empty(dist.shape, dtype=torch.uint8, device=dev)
    KERNELS["probe_stats"].launch(
        dev, ptr(dist), ptr(cand_edge), ptr(valid), ptr(px), ptr(py), B, T,
        K, float(breakage_distance), float(delta), ptr(stats), ptr(need))
    return stats, need


def ubodt_probe_stats_plain(dg, du, xin, p: MatchParams, k: int,
                            delta: float) -> torch.Tensor:
    """Plain version of ``ubodt_probe_stats``."""
    px, py, _tm, valid = unpack_inputs(xin)
    sw = candidate_sweep_plain(dg, px, py, valid, k, p.search_radius,
                               p.sigma_z, False)
    a, b = _keys(sw)
    dist, _t, _f = ubodt_lookup_plain(du, a, b, False)
    counts, need = probe_outcomes_plain(dist, sw.cand.edge, valid, px, py,
                                        p.breakage_distance, delta)
    return torch.cat([counts, count_distinct_pairs_plain(a, b, need)[None]])


def ubodt_probe_stats(dg, du, xin, p: MatchParams, k: int,
                      delta: float) -> torch.Tensor:
    """Count transition-probe outcomes over a packed [4, B, T] batch at K
    = ``k``: int32 [5] = (pairs needing a table probe (valid, both
    candidates present, not the same edge), misses among them, costly
    misses (gc <= breakage_distance: each forces a break), beyond-delta
    costly misses (gc > ``delta``, the table's build bound: provable
    truncations), distinct (src, dst) pairs among the needed ones).  The
    result stays on the device.  CPU tensors run the plain version."""
    if xin.device.type == "cpu":
        return ubodt_probe_stats_plain(dg, du, xin, p, k, delta)
    px, py, _tm, valid = unpack_inputs(xin)
    sw = candidate_sweep(dg, px, py, valid, k, p.search_radius, p.sigma_z,
                         False)
    a, b = _keys(sw)
    dist, _t, _f = ubodt_lookup(du, a, b, False)
    stats, need = probe_outcomes(dist, sw.cand.edge, valid, px, py,
                                 p.breakage_distance, delta)
    count_distinct_pairs(a, b, need, out=stats[4:])
    return stats
