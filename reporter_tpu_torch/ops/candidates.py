"""Candidate edge lookup: the candidate sweep (kernel 1).

For each GPS point: pick the 2x2 quadrant cells of the point's grid cell,
read their four ``cell_rows``, project the point onto every shape segment,
cut at the search radius, keep the 4K nearest (lower index first on ties),
drop later duplicates of an edge and keep the first K.  Invalid slots carry
edge -1 and dist +inf.  The port of ``reporter_tpu/ops/candidates.py``
``_find_candidates`` and its ``find_candidates_batch`` vmap.

The sweep's epilogue also computes the point's emission log-probability
``-0.5 (d / sigma_z)^2`` (NEG_INF where the slot is empty or the point is
padding; the reference's "emission" stage) and each slot's edge-row node
ids (to-node, from-node), which the UBODT probe reads as its keys.

``candidate_sweep`` launches ``csrc/candidate_sweep.cu`` for CUDA tensors
and runs ``candidate_sweep_plain`` for CPU tensors.  The plain version
repeats the reference's float32 arithmetic operation for operation as XLA
compiles it: ``jnp.hypot``'s expansion, and a fused multiply-add wherever
the compiled reference contracts a product into a sum (XLA's CPU backend
always allows that contraction).  It also keeps the reference's top-k tie
rule (a stable ascending sort = ``lax.top_k(-d)``'s lower-index-first), so
both agree with the reference bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..tiles.arrays import DeviceGraph
from ._kernels import KERNELS, check, ptr

# finite stand-in for +inf during selection (the reference's BIG)
BIG = 1e30
NEG_INF = -1e30


class Candidates(NamedTuple):
    edge: torch.Tensor  # [..., K] i32, -1 invalid
    offset: torch.Tensor  # [..., K] f32 metres along edge
    # the last three are None from a sweep run with full=False
    dist: Optional[torch.Tensor]  # [..., K] f32 perpendicular distance, +inf invalid
    cx: Optional[torch.Tensor]  # [..., K] f32 snapped x
    cy: Optional[torch.Tensor]  # [..., K] f32 snapped y


class Sweep(NamedTuple):
    cand: Candidates
    emis: torch.Tensor  # [..., K] f32 emission log-probs
    to_node: torch.Tensor  # [..., K] i32 to-node of each slot's edge (edge 0 for empty slots)
    from_node: torch.Tensor  # [..., K] i32 from-node of each slot's edge


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device.  Dividing by it is a true
    division on every device (CUDA turns division by a host scalar into
    multiplication by its reciprocal, which rounds differently)."""
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add.  The product
    is exact in float64; the float64 sum is rounded to odd (truncated, last
    bit set when inexact), which makes the final rounding to float32
    correct."""
    p = a.double() * b.double()
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)  # exact: p + c == s + err
    toward_zero = (err != 0) & ((err > 0) != (s > 0))
    s = torch.where(toward_zero, torch.nextafter(s, torch.zeros_like(s)), s)
    bits = s.view(torch.int64)
    s = torch.where(err != 0, bits | 1, bits).view(torch.float64)
    return s.float()


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  PyTorch's CPU float32 sqrt
    is not correctly rounded.  Its float64 sqrt is within an ulp, and a
    float32 value's root never lies that close to a float32 rounding
    midpoint, so rounding it would do; but the first multithreaded float64
    sqrt of a process sometimes returns one thread's share of the roots
    only about 2^-36 relative accurate (over 100,000 float64 ulps off:
    ``tests/test_torch_candidates.py``, run as a script), and those round
    to the wrong float32 where the root is near a midpoint.  So the
    rounded root is moved to the neighbour whose rounding interval holds
    the true root: the midpoints between neighbouring float32 values
    square exactly in float64, whatever the float64 sqrt returned."""
    y = torch.sqrt(x.double()).float()
    inf = torch.full_like(y, float("inf"))
    dn, up = torch.nextafter(y, -inf), torch.nextafter(y, inf)
    xd, yd = x.double(), y.double()
    lo, hi = (dn.double() + yd) * 0.5, (yd + up.double()) * 0.5
    fix = (y > 0) & torch.isfinite(y)  # 0, inf and NaN are exact already
    y = torch.where(fix & (xd < lo * lo), dn, y)
    return torch.where(fix & (xd > hi * hi), up, y)


def hypot_like_jax(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s float32 expansion, max * sqrt(1 + (min/max)^2) with 0
    when max == 0 and inf when either leg is inf, with the 1 + r*r fused as
    XLA compiles it; torch.hypot and libm's hypotf round differently."""
    a = u.abs()
    b = v.abs()
    inf = torch.isposinf(a) | torch.isposinf(b)
    m = torch.maximum(a, b)
    n = torch.minimum(a, b)
    zero = m == 0
    r = n / torch.where(zero, torch.ones_like(m), m)
    x = torch.where(zero, m, m * sqrt_f32(fma(r, r, 1.0)))
    return torch.where(inf, torch.full_like(x, float("inf")), x)


def candidate_sweep_plain(dg: DeviceGraph, px: torch.Tensor, py: torch.Tensor,
                          valid: torch.Tensor, k: int, search_radius,
                          sigma_z, full: bool = True) -> Sweep:
    """Plain PyTorch version of the sweep.  px, py, valid: [B, T] float32
    (valid as 0/1).  Returns [B, T, K] leaves; dist, cx and cy are None
    unless ``full``."""
    shape = px.shape
    px = px.reshape(-1)
    py = py.reshape(-1)
    P = px.shape[0]
    nx, ny = dg.grid_nx, dg.grid_ny
    fx = (px - _scalar(dg.grid_x0, px)) / _scalar(dg.cell_size, px)
    fy = (py - _scalar(dg.grid_y0, px)) / _scalar(dg.cell_size, px)
    flx = torch.floor(fx)
    fly = torch.floor(fy)
    cx0 = flx.to(torch.int32).clamp(0, nx - 1)
    cy0 = fly.to(torch.int32).clamp(0, ny - 1)
    # quadrant neighbour: the half of the cell the point is in decides the
    # only reachable neighbour per axis (cell_size >= 2*search_radius)
    sx = torch.where(fx - flx >= 0.5, 1, -1).to(torch.int32)
    sy = torch.where(fy - fly >= 0.5, 1, -1).to(torch.int32)
    ncx = torch.stack([cx0, (cx0 + sx).clamp(0, nx - 1)], 1)  # [P, 2]
    ncy = torch.stack([cy0, (cy0 + sy).clamp(0, ny - 1)], 1)
    cells = (ncy[:, :, None] * nx + ncx[:, None, :]).reshape(P, 4)
    cap = dg.cap
    block = dg.cell_rows[cells.long()].reshape(P, 4, 8, cap)
    ax, ay, bx, by, off0, slen, edge_f = (
        block[:, :, c, :].reshape(P, 4 * cap) for c in range(7))
    ok = edge_f >= 0

    pxc = px[:, None]
    pyc = py[:, None]
    dx = bx - ax
    dy = by - ay
    len2 = fma(dx, dx, dy * dy)
    pos = len2 > 0
    num = fma(pxc - ax, dx, (pyc - ay) * dy)
    t = torch.where(pos, num / torch.where(pos, len2, torch.ones_like(len2)),
                    torch.zeros_like(len2))
    t = t.clamp(0.0, 1.0)
    qx = fma(t, dx, ax)
    qy = fma(t, dy, ay)
    d = hypot_like_jax(pxc - qx, pyc - qy)
    d = torch.where(ok & (d <= _scalar(search_radius, px)), d,
                    torch.full_like(d, BIG))
    off_full = fma(t, slen, off0)

    # widened pool of nearest shape segments, dedup per edge, then the
    # first K; stable sorts give lax.top_k's lower-index-first ties
    n = d.shape[1]
    m = min(4 * k, n)
    pool_idx = torch.sort(d, dim=1, stable=True).indices[:, :m]
    cols = torch.stack([d, edge_f, off_full, qx, qy], 2)  # [P, N, 5]
    pool = torch.gather(cols, 1, pool_idx[:, :, None].expand(P, m, 5))
    pd = pool[:, :, 0]
    pool_edge = torch.where(pd < BIG / 2, pool[:, :, 1].to(torch.int32),
                            torch.full_like(pd, -1, dtype=torch.int32))
    same = (pool_edge[:, None, :] == pool_edge[:, :, None]) & (pool_edge[:, None, :] >= 0)
    earlier = torch.triu(torch.ones(m, m, dtype=torch.bool, device=px.device), 1)
    dup = (same & earlier).any(1)
    pd = torch.where(dup, torch.full_like(pd, BIG), pd)
    kk = min(k, m)
    sel = torch.sort(pd, dim=1, stable=True).indices[:, :kk]
    pool2 = torch.cat([pd[:, :, None], pool[:, :, 1:]], 2)
    top = torch.gather(pool2, 1, sel[:, :, None].expand(P, kk, 5))
    if kk < k:
        pad = torch.zeros((P, k - kk, 5), dtype=torch.float32, device=px.device)
        pad[:, :, 0] = BIG
        pad[:, :, 1] = -1.0
        top = torch.cat([top, pad], 1)
    td = top[:, :, 0]
    live = td < BIG / 2
    dist = torch.where(live, td, torch.full_like(td, float("inf")))
    edge = torch.where(live, top[:, :, 1].to(torch.int32),
                       torch.full_like(td, -1, dtype=torch.int32))

    emis = -0.5 * torch.square(dist / _scalar(sigma_z, px))
    emis = torch.where(torch.isfinite(dist), emis, torch.full_like(emis, NEG_INF))
    emis = torch.where(valid.reshape(-1)[:, None] != 0, emis,
                       torch.full_like(emis, NEG_INF))
    rows = dg.edge_rows[torch.where(edge >= 0, edge, 0).long()]  # [P, K, 8]
    to_node = rows[..., 0].contiguous().view(torch.int32)
    from_node = rows[..., 1].contiguous().view(torch.int32)

    out = (edge, top[:, :, 2], dist, top[:, :, 3], top[:, :, 4])
    K = (*shape, k)
    cand = [a.reshape(K).contiguous() for a in out]
    if not full:
        cand[2:] = [None] * 3
    return Sweep(Candidates(*cand), emis.reshape(K), to_node.reshape(K),
                 from_node.reshape(K))


def candidate_sweep(dg: DeviceGraph, px: torch.Tensor, py: torch.Tensor,
                    valid: torch.Tensor, k: int, search_radius,
                    sigma_z, full: bool = True) -> Sweep:
    """The sweep over a [B, T] batch: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``valid`` is float32 0/1 (the packed
    input's validity plane).  With ``full=False`` the candidates' dist, cx
    and cy are neither written nor returned (None): the packed match path
    reads none of them.

    PRECONDITION: ``search_radius <= dg.cell_size / 2`` (the 2x2 quadrant
    block covers the search disk only then; SegmentMatcher enforces it)."""
    if px.device.type == "cpu":
        return candidate_sweep_plain(dg, px, py, valid, k, search_radius,
                                     sigma_z, full)
    dev = px.device
    if k < 1 or k > 32:
        raise ValueError("candidate_sweep: k=%d outside 1..32" % k)
    shape = tuple(px.shape)
    for name, t in (("px", px), ("py", py), ("valid", valid)):
        check(t, name, torch.float32, dev, shape)
    check(dg.cell_rows, "cell_rows", torch.float32, dev)
    check(dg.edge_rows, "edge_rows", torch.float32, dev)
    K = (*shape, k)
    edge = torch.empty(K, dtype=torch.int32, device=dev)
    offset, emis = (torch.empty(K, dtype=torch.float32, device=dev)
                    for _ in range(2))
    dist, cx, cy = ((torch.empty(K, dtype=torch.float32, device=dev)
                     for _ in range(3)) if full else (None,) * 3)
    to_node, from_node = (torch.empty(K, dtype=torch.int32, device=dev)
                          for _ in range(2))
    n = px.numel()
    if n:
        KERNELS["candidate_sweep"].launch(
            dev, ptr(px), ptr(py), ptr(valid), ptr(dg.cell_rows),
            ptr(dg.edge_rows), n, dg.cap, dg.grid_nx, dg.grid_ny,
            dg.grid_x0, dg.grid_y0, dg.cell_size, k, float(search_radius),
            float(sigma_z), ptr(edge), ptr(offset), ptr(dist), ptr(cx),
            ptr(cy), ptr(emis), ptr(to_node), ptr(from_node))
    return Sweep(Candidates(edge, offset, dist, cx, cy), emis, to_node,
                 from_node)


def find_candidates_batch(dg: DeviceGraph, px: torch.Tensor, py: torch.Tensor,
                          k: int, search_radius) -> Candidates:
    """px, py: [B, T] -> Candidates with [B, T, K] leaves (the reference's
    ``find_candidates_batch``)."""
    ones = torch.ones_like(px)
    return candidate_sweep(dg, px, py, ones, k, search_radius, 1.0).cand
