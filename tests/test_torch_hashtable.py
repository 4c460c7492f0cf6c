"""The port's UBODT probe (kernel 2's plain version on the CPU) against
the reference's jitted ``ubodt_lookup``: dist, time and first_edge exact,
on present and absent pairs, flat and broadcast."""

import jax
import numpy as np
import pytest
import torch

from reporter_tpu.ops.hashtable import ubodt_lookup as ref_lookup
from reporter_tpu_torch.ops.hashtable import ubodt_lookup
from reporter_tpu_torch.tiles.ubodt import F_DST, F_SRC, ROW_W
from test_torch_builders import device_views, scenario

_ref_lookup = jax.jit(ref_lookup)


def _pairs(ru, rng, n):
    flat = ru.packed.reshape(-1, ROW_W)
    occ = flat[flat[:, F_SRC] >= 0]
    pick = occ[rng.integers(0, len(occ), n)]
    present = pick[:, [F_SRC, F_DST]]
    hi = int(flat[:, F_SRC].max()) + 3
    absent = rng.integers(-2, hi, (n, 2)).astype(np.int32)
    return np.concatenate([present, absent]).astype(np.int32)


def _check(ref, got):
    for r, g in zip(ref, got):
        r = np.asarray(r)
        g = g.numpy()
        assert r.dtype == g.dtype and r.shape == g.shape
        assert r.tobytes() == g.tobytes()


@pytest.mark.parametrize("seed", [7, 19])
def test_lookup_matches_reference_flat(seed):
    _net, ra, ru, _pa, _pu = scenario(seed)
    pairs = _pairs(ru, np.random.default_rng(seed), 3000)
    _dg, du = device_views(ra, ru)
    ref = _ref_lookup(ru.to_device(), pairs[:, 0], pairs[:, 1])
    got = ubodt_lookup(du, torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1]))
    _check(ref, got)
    hit = np.isfinite(got[0].numpy())
    assert 0.2 < hit.mean() < 0.8  # both outcomes exercised
    assert (got[2].numpy()[~hit] == -1).all() and np.isinf(got[1].numpy()[~hit]).all()


def test_lookup_matches_reference_broadcast():
    """The main path's key grid: to-nodes [B, T-1, K, 1] against from-nodes
    [B, T-1, 1, K]."""
    _net, ra, ru, _pa, _pu = scenario(43)
    rng = np.random.default_rng(1)
    nodes = rng.integers(0, ra.num_nodes, (2, 3, 5, 8)).astype(np.int32)
    a, b = nodes[0][..., :, None], nodes[1][..., None, :]
    _dg, du = device_views(ra, ru)
    ref = _ref_lookup(ru.to_device(), a, b)
    got = ubodt_lookup(du, torch.from_numpy(a), torch.from_numpy(b))
    assert got[0].shape == (3, 5, 8, 8)
    _check(ref, got)
