"""The port's candidate sweep (kernel 1's plain version on the CPU)
against the reference's jitted ``find_candidates_batch``.

Tolerance: edge ids exact; dist, offset, cx, cy within 1e-4 m (the plain
version repeats the compiled reference's float32 arithmetic, so they are
expected to be exact)."""

import json
import subprocess
import sys

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


def test_sqrt_f32_is_correctly_rounded():
    """The plain versions' float32 square root equals the correctly rounded
    one (numpy's, as XLA's and the kernels' __fsqrt_rn) bit for bit: on
    random magnitudes, on 1 + k ulp (roots close to a rounding midpoint)
    and on 0, denormals and inf."""
    from reporter_tpu_torch.ops.candidates import sqrt_f32

    rng = np.random.default_rng(3)
    near_one = 1.0 + np.arange(1, 200_001, dtype=np.float64) * 2.0 ** -23
    vals = np.concatenate([near_one, 10.0 ** rng.uniform(-44, 38, 500_000),
                           [0.0, 1e-45, 3e-45, np.inf, 4.0]]).astype(np.float32)
    got = sqrt_f32(torch.from_numpy(vals)).numpy()
    assert got.tobytes() == np.sqrt(vals).tobytes()


# float32 values whose roots lie near a float32 rounding midpoint (1 + k
# ulp, k odd: the root is 1 + k/2 ulp less about k^2 ulp^2 / 8), where an
# inaccurate float64 root rounds to the wrong float32
_NEAR_MIDPOINT = np.tile((1.0 + np.arange(1, 200, 2) * 2.0 ** -23).astype(np.float32), 2000)


def test_sqrt_f32_survives_an_inaccurate_float64_root(monkeypatch):
    """sqrt_f32 stays correctly rounded when PyTorch's float64 root is off
    by as much as a process's first multithreaded float64 sqrt was seen
    to be (117,483 to 121,872 float64 ulps, ``_first_call`` below).  That
    fault is a race; here every root carries such an error, alternately
    high and low, so the check is deterministic (rounding the roots, as
    sqrt_f32 did before, gets 62,000 of these 200,000 values wrong)."""
    from reporter_tpu_torch.ops.candidates import sqrt_f32

    real = torch.sqrt

    def inaccurate(x):
        y = real(x)
        if y.dtype != torch.float64:
            return y
        off = torch.where(torch.arange(y.numel()).reshape(y.shape) % 2 == 0, 117_483, -117_483)
        return (y.view(torch.int64) + off).view(torch.float64)

    monkeypatch.setattr(torch, "sqrt", inaccurate)
    got = sqrt_f32(torch.from_numpy(_NEAR_MIDPOINT)).numpy()
    assert got.tobytes() == np.sqrt(_NEAR_MIDPOINT).tobytes()


_FIRST_CALL = """
import json, sys, numpy as np, torch
sys.path.insert(0, %r)
from reporter_tpu_torch.ops import candidates
v = np.tile((1.0 + np.arange(1, 200, 2) * 2.0 ** -23).astype(np.float32), 2000)
seen = []
real = torch.sqrt
torch.sqrt = lambda x: seen.append(real(x)) or seen[-1]
got = candidates.sqrt_f32(torch.from_numpy(v)).numpy()  # the process's first sqrt
ulps = np.abs(seen[0].numpy().view(np.int64) - np.sqrt(v.astype(np.float64)).view(np.int64))
print(json.dumps({"float64_ulps_max": int(ulps.max()), "float64_off": int((ulps > 1).sum()),
                  "float32_wrong": int((got != np.sqrt(v)).sum())}))
"""


def _first_call(n):
    """``n`` fresh processes, 8 at a time, each taking sqrt_f32 of the
    near-midpoint values as its first sqrt: per process, the float64
    root's largest error in ulps, how many roots were more than an ulp
    off, and how many float32 results were wrong."""
    import os

    code = _FIRST_CALL % os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for lo in range(0, n, 8):
        procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                  text=True) for _ in range(min(8, n - lo))]
        out += [json.loads(p.communicate(timeout=120)[0]) for p in procs]
    return out


def test_sqrt_f32_exact_on_a_process_first_call():
    """sqrt_f32 is exact when it makes a fresh process's first float64
    sqrt, the call that is sometimes inaccurate (4 fresh processes)."""
    assert all(r["float32_wrong"] == 0 for r in _first_call(4))


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_candidates.py [n]: how often a fresh
    # process's first float64 sqrt comes back inaccurate, and whether
    # sqrt_f32 was exact in every one
    runs = _first_call(int(sys.argv[1]) if len(sys.argv) > 1 else 60)
    bad = [r for r in runs if r["float64_off"]]
    print("%d of %d fresh processes: first float64 sqrt off by more than an ulp "
          "(worst %d ulps, %s roots); sqrt_f32 wrong in %d processes"
          % (len(bad), len(runs), max([r["float64_ulps_max"] for r in runs]),
             sorted({r["float64_off"] for r in bad}), sum(r["float32_wrong"] > 0 for r in runs)))
