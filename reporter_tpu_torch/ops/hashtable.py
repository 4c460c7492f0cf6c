"""UBODT probe and select (kernel 2).

Hash each (src, dst) node pair with two independent uint32 mixes, read the
two 128-lane int32 bucket rows of the cuckoo table, match the src and dst
lanes of each entry and return (dist, time, first_edge), with +inf / -1 on
a miss.  The port of ``reporter_tpu/ops/hashtable.py`` ``_lookup_plain``
(cuckoo layout), ``device_pair_hash``, ``device_pair_hash2``,
``_bucket_rows`` and ``_select``.

``ubodt_lookup`` launches ``csrc/ubodt_probe.cu`` for CUDA tensors and
runs ``ubodt_lookup_plain`` for CPU tensors.  Torch has no uint32
arithmetic and its int32 ``>>`` is arithmetic, so the plain hashes compute
in int64 masked to 32 bits after every multiply and shift (the kernel
uses true uint32).
"""

from __future__ import annotations

import torch

from ..tiles.ubodt import BUCKET, F_DIST, F_DST, F_FE, F_SRC, F_TIME, ROW_W, DeviceUBODT
from ._kernels import KERNELS, check, ptr

_M32 = 0xFFFFFFFF
# probes per chunk of the plain version (bounds its [chunk, 128] row copies)
_PLAIN_CHUNK = 1 << 18


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow:
    the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(src, dst, a, b, s1, c, s2, mask):
    s = src.to(torch.int64) & _M32
    d = dst.to(torch.int64) & _M32
    h = (_mul32(s, a) + _mul32(d, b)) & _M32
    h = h ^ (h >> s1)
    h = _mul32(h, c)
    h = h ^ (h >> s2)
    return h & mask


def device_pair_hash(src: torch.Tensor, dst: torch.Tensor, mask: int) -> torch.Tensor:
    """Bucket choice 1: the uint32 mix of tiles.ubodt.pair_hash, as int64."""
    return _mix(src, dst, 0x9E3779B1, 0x85EBCA6B, 15, 0x2C1B3C6D, 12, mask)


def device_pair_hash2(src: torch.Tensor, dst: torch.Tensor, mask: int) -> torch.Tensor:
    """Bucket choice 2: the uint32 mix of tiles.ubodt.pair_hash2, as int64."""
    return _mix(src, dst, 0x85EBCA77, 0xC2B2AE3D, 13, 0x27D4EB2F, 16, mask)


def _select(rows: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """rows [N, 128] -> (dist, time, first) of the entry whose src and dst
    lanes both match, +inf / -1 when none does (keys are unique)."""
    e = rows.reshape(-1, BUCKET, ROW_W)
    both = (e[:, :, F_SRC] == src[:, None]) & (e[:, :, F_DST] == dst[:, None])
    vf = e.view(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=rows.device)
    dist = torch.where(both, vf[:, :, F_DIST], inf).amin(1)
    time = torch.where(both, vf[:, :, F_TIME], inf).amin(1)
    first = torch.where(both, e[:, :, F_FE], -1).amax(1)
    return dist, time, first


def ubodt_lookup_plain(u: DeviceUBODT, src: torch.Tensor, dst: torch.Tensor,
                       with_first: bool = True):
    """Plain PyTorch probe over broadcastable int32 ``src``/``dst``.
    Returns (dist f32, time f32, first_edge i32) of the broadcast shape;
    first_edge is None unless ``with_first``."""
    src, dst = torch.broadcast_tensors(src, dst)
    shape = src.shape
    s = src.reshape(-1)
    d = dst.reshape(-1)
    outs = ([], [], [])
    for lo in range(0, s.shape[0], _PLAIN_CHUNK):
        sc, dc = s[lo:lo + _PLAIN_CHUNK], d[lo:lo + _PLAIN_CHUNK]
        r1 = _select(u.packed[device_pair_hash(sc, dc, u.bmask)], sc, dc)
        r2 = _select(u.packed[device_pair_hash2(sc, dc, u.bmask)], sc, dc)
        outs[0].append(torch.minimum(r1[0], r2[0]))
        outs[1].append(torch.minimum(r1[1], r2[1]))
        outs[2].append(torch.maximum(r1[2], r2[2]))
    if not outs[0]:
        dev = src.device
        res = (torch.empty(shape, dtype=torch.float32, device=dev),
               torch.empty(shape, dtype=torch.float32, device=dev),
               torch.empty(shape, dtype=torch.int32, device=dev))
    else:
        res = tuple(torch.cat(o).reshape(shape) for o in outs)
    return res if with_first else (res[0], res[1], None)


def ubodt_lookup(u: DeviceUBODT, src: torch.Tensor, dst: torch.Tensor,
                 with_first: bool = True):
    """Vectorised table probe over broadcastable int32 ``src``/``dst`` (at
    most 4-d).  Returns (dist, time, first_edge): dist/time = +inf and
    first_edge = -1 on a miss; with ``with_first=False`` first_edge is
    neither written nor returned (None).  CUDA tensors launch the kernel,
    which reads the broadcast through strides (no materialised key arrays);
    CPU tensors run the plain version."""
    if src.device.type == "cpu":
        return ubodt_lookup_plain(u, src, dst, with_first)
    dev = src.device
    src, dst = torch.broadcast_tensors(src, dst)
    if src.dim() > 4:
        raise ValueError("ubodt_lookup: at most 4 dims, got %d" % src.dim())
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError("%s must be int32 on %s" % (name, dev))
    check(u.packed, "packed", torch.int32, dev)
    if u.packed.data_ptr() % 16:
        raise ValueError("packed table must be 16-byte aligned")
    shape = tuple(src.shape)
    pad = 4 - src.dim()
    dims = torch.tensor((1,) * pad + shape, dtype=torch.int64)
    s_strides = torch.tensor((0,) * pad + src.stride(), dtype=torch.int64)
    d_strides = torch.tensor((0,) * pad + dst.stride(), dtype=torch.int64)
    dist = torch.empty(shape, dtype=torch.float32, device=dev)
    time = torch.empty(shape, dtype=torch.float32, device=dev)
    first = torch.empty(shape, dtype=torch.int32, device=dev) if with_first else None
    if dist.numel():
        KERNELS["ubodt_probe"].launch(
            dev, ptr(src), ptr(dst), ptr(dims), ptr(s_strides),
            ptr(d_strides), ptr(u.packed), u.bmask, ptr(dist), ptr(time),
            ptr(first))
    return dist, time, first
