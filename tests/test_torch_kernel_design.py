"""The host-side half of the redesigned kernels, on the CPU: kernel 2's
32-bit key decode (the fast-divmod parameters ``_grid`` passes, with the
device's uint32 arithmetic emulated in numpy) against ``//``, ``%`` and
``torch.broadcast_tensors``, and the plain probe of the keys whose
answers the warp probe's ballot must merge exactly (the empty marker's
(-1, 0), which meets every empty entry, and keys that miss) against the
JAX package's ``ubodt_lookup``.  The kernels themselves run on the card
only: ``chip_smoke.py`` holds them against these plain versions."""

import jax
import numpy as np
import pytest
import torch

from reporter_tpu.ops.hashtable import ubodt_lookup as ref_lookup
from reporter_tpu.tiles.ubodt import ubodt_from_columns as ref_from_columns
from reporter_tpu_torch import convert
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.tiles.ubodt import F_DST, F_SRC, ROW_W

_ref_lookup = jax.jit(ref_lookup)
M32 = np.uint64(0xFFFFFFFF)


def _divmod32(i, d):
    """(i // d, i % d) as the kernels compute them from ``fast_divmod``'s
    parameters: umulhi, an add and a shift, then one multiply-subtract,
    every step in uint32."""
    mul, shr = H.fast_divmod(d)
    i = np.asarray(i, np.uint64)
    hi = (i * np.uint64(mul)) >> np.uint64(32)  # __umulhi(i, mul)
    q = ((hi + i) & M32) >> np.uint64(shr)
    r = (i - q * np.uint64(d)) & M32
    return q, r


@pytest.mark.parametrize("d", [1, 2, 3, 7, 63, 255, (1 << 16) + 1, (1 << 31) - 1])
def test_fast_divmod_equals_floor_division(d):
    rng = np.random.default_rng(d)
    top = (1 << 31) - 1
    i = np.concatenate([
        [0, 1, d - 1, d, d + 1, top - 1, top],
        np.arange(0, top, d, dtype=np.int64)[:2000],                   # multiples of d
        top - top % d + np.arange(-3, 1) * d,                          # the last multiples
        rng.integers(0, top + 1, 20000),
        rng.integers(0, min(top, 64 * d) + 1, 5000)])
    i = i[(i >= 0) & (i <= top)].astype(np.uint64)
    q, r = _divmod32(i, d)
    assert (q == i // np.uint64(d)).all() and (r == i % np.uint64(d)).all()
    mul, shr = H.fast_divmod(d)
    assert 0 <= mul < 1 << 32 and 0 <= shr <= 31


def test_fast_divmod_refuses_dims_outside_32_bits():
    assert H.fast_divmod(0) == (0, 0) and H.fast_divmod(1 << 31) == (0, 0)


def _decode(dims, s_str, d_str):
    """The kernels' 32-bit decode of every key of a grid (rtt::grid_keys):
    each flat index's coordinates from the innermost dim out by fast
    divmod, dotted with each side's strides; returns (src offsets, dst
    offsets), or None where make_grid would take the int64 decode."""
    dims, s_str, d_str = (t.numpy().astype(np.int64) for t in (dims, s_str, d_str))
    d4, mul, shr = dims[:4], dims[4:8], dims[8:12]
    n = int(np.prod(d4))
    lim = (1 << 31) - 1
    reach = [int(((d4 - 1) * st).sum()) for st in (s_str, d_str)]
    if n >= lim or max(reach) >= lim or (s_str < 0).any() or (d_str < 0).any():
        return None
    for a in range(4):
        assert (mul[a], shr[a]) == H.fast_divmod(int(d4[a]))
    r = np.arange(n, dtype=np.uint64)
    so = np.zeros(n, np.uint64)
    do = np.zeros(n, np.uint64)
    for a in (3, 2, 1):
        q, c = _divmod32(r, int(d4[a]))
        so = (so + c * np.uint64(s_str[a])) & M32
        do = (do + c * np.uint64(d_str[a])) & M32
        r = q
    so = (so + r * np.uint64(s_str[0])) & M32
    do = (do + r * np.uint64(d_str[0])) & M32
    return so.astype(np.int64), do.astype(np.int64)


def _key_view(rng, shape):
    """An int32 view of ``shape`` as the wrappers meet them: a contiguous
    base, some dims of 1 broadcast (0 strides), the dims permuted, an
    offset slice."""
    rank = len(shape)
    keep = [rng.random() < 0.7 or shape[a] == 1 for a in range(rank)]
    base_shape = [shape[a] if keep[a] else 1 for a in range(rank)]
    perm = rng.permutation(rank)
    pad = int(rng.integers(0, 3))  # a leading slice: a nonzero storage offset
    base = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, size=(
        pad + int(np.prod(base_shape)),)).astype(np.int32))
    stored = base[pad:].reshape([base_shape[p] for p in perm])
    view = stored.permute(*np.argsort(perm).tolist())
    assert list(view.shape) == base_shape
    return view.expand(*shape), base


@pytest.mark.parametrize("seed", range(8))
def test_grid_decode_equals_broadcast(seed):
    """_grid's dims, fast-divmod parameters and strides, decoded as the
    kernels decode them, give every key of torch.broadcast_tensors, for
    padded (rank < 4), permuted and broadcast (0-stride) keys."""
    rng = np.random.default_rng(seed)
    rank = int(rng.integers(1, 5))
    shape = [int(x) for x in rng.integers(1, 9, rank)]
    (src, base_s), (dst, base_d) = (_key_view(rng, shape) for _ in range(2))
    if seed == 0:  # the main path's grid: to-nodes [B, T-1, K, 1] x from-nodes [B, T-1, 1, K]
        nodes = torch.from_numpy(rng.integers(0, 1 << 20, (2, 3, 6, 8)).astype(np.int32))
        src, dst = nodes[0][:, :-1, :, None], nodes[1][:, 1:, None, :]
        base_s = base_d = nodes.reshape(-1)  # the storage both views index
    sb, db = torch.broadcast_tensors(src, dst)
    dims, s_str, d_str = H._grid(sb, db)
    assert dims.shape == (12,) and s_str.shape == d_str.shape == (4,)
    so, do = _decode(dims, s_str, d_str)
    got_s = base_s[torch.from_numpy(so) + sb.storage_offset()]
    got_d = base_d[torch.from_numpy(do) + db.storage_offset()]
    assert torch.equal(got_s, sb.reshape(-1)) and torch.equal(got_d, db.reshape(-1))


def test_grid_decode_takes_int64_past_31_bits():
    """A grid of 2^31 keys or more, or an offset past 31 bits, is left to
    the int64 decode: its dims carry no 32-bit parameters it could misuse
    (a dim past 2^31 - 1 gets none)."""
    src = torch.zeros(1, dtype=torch.int32).expand(1 << 16, 1 << 16)
    dims, s_str, d_str = H._grid(src, src)
    assert _decode(dims, s_str, d_str) is None  # 2^32 keys
    big = torch.zeros(1, dtype=torch.int32).expand(1 << 31)
    dims, _s, _d = H._grid(big, big)
    assert dims[3].item() == 1 << 31 and dims[7].item() == dims[11].item() == 0


def _sparse_table(layout, seed=3, n=300):
    """A reference table of n rows in far more slots: most entries empty
    (src -1, zeros elsewhere)."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(1_000_000, size=(n, 2), replace=False)
    cols = (keys[:, 0].astype(np.int32), keys[:, 1].astype(np.int32),
            (rng.random(n) * 1000).astype(np.float32), (rng.random(n) * 100).astype(np.float32),
            rng.integers(0, 1 << 20, n).astype(np.int32))
    return ref_from_columns(*cols, delta=1000.0, load_factor=0.05, layout=layout), cols


@pytest.mark.parametrize("layout", ["cuckoo", "wide32"])
def test_empty_marker_and_miss_keys_equal_reference(layout):
    """The plain probe (kernel 2's plain version) of the empty marker's key
    (-1, 0), which matches every empty entry of its rows (all (0, 0, 0)),
    of all-miss keys and of hits, equals the JAX ubodt_lookup bit for bit:
    the answers the warp probe's ballot must give when it merges several
    hits of one key, or none."""
    ru, cols = _sparse_table(layout)
    flat = ru.packed.reshape(-1, ROW_W)
    assert (flat[:, F_SRC] == -1).mean() > 0.9 and (flat[flat[:, F_SRC] == -1, 1:] == 0).all()
    rng = np.random.default_rng(5)
    hits = rng.integers(0, len(cols[0]), 40)
    s = np.concatenate([np.full(7, -1), rng.integers(2_000_000, 3_000_000, 50), cols[0][hits],
                        [-1, -1, -2, 0]]).astype(np.int32)
    d = np.concatenate([np.zeros(7), rng.integers(0, 1_000_000, 50), cols[1][hits],
                        [-1, 5, -2, 0]]).astype(np.int32)
    du = convert.ubodt_from_numpy(ru.packed, ru.bmask, layout)
    got = H.ubodt_lookup_plain(du, torch.from_numpy(s), torch.from_numpy(d))
    want = [np.asarray(x) for x in _ref_lookup(ru.to_device(), s, d)]
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype and g.numpy().tobytes() == w.tobytes()
    # the empty marker hit (several empty entries in its rows), every miss missed
    b = H.device_pair_hash(torch.tensor([-1]), torch.tensor([0]), du.bmask)
    row = du.packed[b].reshape(-1, ROW_W)
    assert int(((row[:, F_SRC] == -1) & (row[:, F_DST] == 0)).sum()) > 1
    dist, time, first = (x.numpy() for x in got)
    assert (dist[:7] == 0).all() and (time[:7] == 0).all() and (first[:7] == 0).all()
    assert np.isinf(dist[7:57]).all() and (first[7:57] == -1).all()
    assert np.isfinite(dist[57:97]).all()
