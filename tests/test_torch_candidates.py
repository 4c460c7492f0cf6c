"""The port's candidate sweep (kernel 1's plain version on the CPU)
against the reference's jitted ``find_candidates_batch``.

Tolerance: edge ids exact; dist, offset, cx, cy within 1e-4 m (the plain
version repeats the compiled reference's float32 arithmetic, so they are
expected to be exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reporter_tpu.ops.candidates import find_candidates_batch as ref_find
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu_torch import convert
from reporter_tpu_torch.ops.candidates import find_candidates_batch
from test_fuzz_differential import random_traces
from test_torch_builders import scenario

ATOL_M = 1e-4

_ref_find = jax.jit(ref_find, static_argnums=(3,))


def points(arrays, traces):
    """Projected [B, T] float32 coordinates of equal-length traces."""
    xy = [arrays.proj.to_xy([p["lat"] for p in t["trace"]],
                            [p["lon"] for p in t["trace"]]) for t in traces]
    px = np.stack([x for x, _ in xy]).astype(np.float32)
    py = np.stack([y for _, y in xy]).astype(np.float32)
    return px, py


def graph_views(ra):
    dg = convert.graph_from_numpy(
        ra._edge_rows(), ra._cell_rows(), [ra.grid_x0, ra.grid_y0],
        [ra.grid_nx, ra.grid_ny], ra.cell_size)
    return ra.to_device(), dg


def compare(ref, got, where=""):
    assert np.array_equal(np.asarray(ref.edge), got.edge.numpy()), where
    for f in ("dist", "offset", "cx", "cy"):
        np.testing.assert_allclose(got.__getattribute__(f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=ATOL_M, err_msg="%s %s" % (where, f))


@pytest.mark.parametrize("seed,k", [(3, 8), (11, 8), (29, 16)])
def test_find_candidates_matches_reference(seed, k):
    net, ra, _ru, _pa, _pu = scenario(seed)
    traces = random_traces(np.random.default_rng(seed + 100), net, ra, 12, n_pts=20)
    px, py = points(ra, traces)
    dg0, dg1 = graph_views(ra)
    ref = _ref_find(dg0, jnp.asarray(px), jnp.asarray(py), k, jnp.float32(50.0))
    got = find_candidates_batch(dg1, torch.from_numpy(px), torch.from_numpy(py), k, 50.0)
    compare(ref, got, "seed %d" % seed)
    assert (got.edge.numpy() >= 0).any() and (got.edge.numpy() < 0).any()


def test_find_candidates_ties_on_nodes():
    """Points exactly on intersections are equidistant from every edge that
    meets there (8 directed edges on an interior grid node): the order of
    the tied candidates must follow the reference's lower-index-first."""
    ra = ref_build_graph_arrays(ref_grid_city(8, 8, 200.0), cell_size=100.0)
    nodes = np.arange(ra.num_nodes)
    px = ra.node_x[nodes].reshape(4, 16).astype(np.float32)
    py = ra.node_y[nodes].reshape(4, 16).astype(np.float32)
    dg0, dg1 = graph_views(ra)
    ref = _ref_find(dg0, jnp.asarray(px), jnp.asarray(py), 8, jnp.float32(50.0))
    got = find_candidates_batch(dg1, torch.from_numpy(px), torch.from_numpy(py), 8, 50.0)
    d = got.dist.numpy()
    assert (np.abs(d[..., 0] - d[..., 1]) < 1e-4).mean() > 0.9  # ties everywhere
    compare(ref, got, "nodes")
