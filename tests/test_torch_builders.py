"""The port's host builders against the reference's: the same networks
give the same graph-array and UBODT bytes, and the port's pair hashes
equal the reference's.  Also the shared scenario helpers of the other
test_torch_* files."""

import numpy as np
import pytest
import torch

from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu.tiles.ubodt import pair_hash as ref_pair_hash
from reporter_tpu.tiles.ubodt import pair_hash2 as ref_pair_hash2
from reporter_tpu_torch import convert
from reporter_tpu_torch.ops.hashtable import device_pair_hash, device_pair_hash2
from reporter_tpu_torch.tiles import network as port_network
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.ubodt import build_ubodt, pair_hash, pair_hash2
from test_fuzz_differential import random_network


def to_port_network(net):
    """The reference RoadNetwork as the port's (same nodes, edges, ids)."""
    return port_network.RoadNetwork.from_dict(net.to_dict())


def scenario(seed: int, delta: float = 1500.0, cell_size: float = 100.0):
    """(reference net, reference arrays, reference ubodt, port arrays, port
    ubodt) for the fuzz network of ``seed``."""
    net = random_network(np.random.default_rng(seed))
    ra = ref_build_graph_arrays(net, cell_size=cell_size)
    ru = ref_build_ubodt(ra, delta=delta)
    pa = build_graph_arrays(to_port_network(net), cell_size=cell_size)
    pu = build_ubodt(pa, delta=delta)
    return net, ra, ru, pa, pu


def device_views(ra, ru):
    """The port's device views built from the reference's bytes."""
    dg = convert.graph_from_numpy(
        ra._edge_rows(), ra._cell_rows(), [ra.grid_x0, ra.grid_y0],
        [ra.grid_nx, ra.grid_ny], ra.cell_size)
    du = convert.ubodt_from_numpy(ru.packed, ru.bmask)
    return dg, du


def _same_bytes(a, b):
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [7, 19, 43])
def test_graph_and_ubodt_bytes_equal_reference(seed):
    _net, ra, ru, pa, pu = scenario(seed)
    assert _same_bytes(pa.cell_rows(), ra._cell_rows())
    assert _same_bytes(pa.edge_rows(), ra._edge_rows())
    assert (pa.grid_x0, pa.grid_y0, pa.grid_nx, pa.grid_ny) == (
        ra.grid_x0, ra.grid_y0, ra.grid_nx, ra.grid_ny)
    assert pu.bmask == ru.bmask and pu.num_rows == ru.num_rows
    assert _same_bytes(pu.packed, ru.packed)
    # the Python builder and packer give the same table as the native core
    py = build_ubodt(pa, delta=1500.0, use_native=False)
    assert _same_bytes(py.packed, ru.packed)


@pytest.mark.parametrize("two_edge", [False, True])
def test_grid_city_bytes_equal_reference(two_edge):
    ra = ref_build_graph_arrays(ref_grid_city(8, 8, 200.0, two_edge_segments=two_edge))
    pa = build_graph_arrays(port_network.grid_city(8, 8, 200.0, two_edge_segments=two_edge))
    for f in ("edge_seg", "edge_seg_off", "seg_ids", "seg_len", "edge_way",
              "node_x", "node_y", "out_start", "out_edges"):
        assert _same_bytes(getattr(pa, f), getattr(ra, f)), f
    assert _same_bytes(pa.cell_rows(), ra._cell_rows())
    assert _same_bytes(pa.edge_rows(), ra._edge_rows())
    assert _same_bytes(build_ubodt(pa, delta=3000.0).packed,
                       ref_build_ubodt(ra, delta=3000.0).packed)


def test_pair_hashes_equal_reference():
    rng = np.random.default_rng(0)
    # full uint32 range: values >= 2**31 are negative as int32
    src = rng.integers(0, 1 << 32, 100_000, dtype=np.uint64).astype(np.uint32).view(np.int32)
    dst = rng.integers(0, 1 << 32, 100_000, dtype=np.uint64).astype(np.uint32).view(np.int32)
    src[:4] = [0, -1, np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    mask = (1 << 20) - 1
    want1 = ref_pair_hash(src, dst, mask)
    want2 = ref_pair_hash2(src, dst, mask)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    assert np.array_equal(device_pair_hash(s, d, mask).numpy(), want1)
    assert np.array_equal(device_pair_hash2(s, d, mask).numpy(), want2)
    assert np.array_equal(pair_hash(src, dst, mask), want1)
    assert np.array_equal(pair_hash2(src, dst, mask), want2)


def test_convert_equals_port_device_views():
    _net, ra, ru, pa, pu = scenario(7)
    dg, du = device_views(ra, ru)
    own = pa.device_graph()
    assert torch.equal(dg.edge_rows, own.edge_rows)
    assert torch.equal(dg.cell_rows, own.cell_rows)
    assert (dg.grid_x0, dg.grid_y0, dg.grid_nx, dg.grid_ny, dg.cell_size) == (
        own.grid_x0, own.grid_y0, own.grid_nx, own.grid_ny, own.cell_size)
    assert torch.equal(du.packed, pu.device_ubodt().packed)
    assert du.bmask == pu.bmask
