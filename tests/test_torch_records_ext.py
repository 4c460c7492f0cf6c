"""The records extension on the CPU (``native/records_ext.c``, built by the
port into ``build/reporter_tpu_torch/``): ``build_records`` over the
native core's association columns equal to the port's Python loop and to
the JAX package's ``associate_segments_batch`` on the same matches, byte
for byte through ``json.dumps`` (the 6 x 6 grid's cohorts and an empty
batch); a float64 column where int64 belongs refused with TypeError, then
the port's logged Python loop taken and counted; ``require_records_ext``
raising with the compiler's output on a source that does not compile; the
extension loaded from the build directory, never from ``native/``.  The
tests skip only where this machine lacks gcc or the interpreter's
Python.h."""

import json
import logging
import os
import shutil
import sysconfig

import numpy as np
import pytest

from reporter_tpu.matching.assoc_native import associate_segments_batch as ref_associate
from reporter_tpu.tiles.arrays import build_graph_arrays as ref_build_graph_arrays
from reporter_tpu.tiles.network import grid_city as ref_grid_city
from reporter_tpu.tiles.ubodt import build_ubodt as ref_build_ubodt
from reporter_tpu_torch import native
from reporter_tpu_torch._build import BUILD_DIR, REPO_ROOT
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.matching import assoc_native
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city
from reporter_tpu_torch.tiles.ubodt import build_ubodt


@pytest.fixture(autouse=True)
def _toolchain():
    """Skip where the extension cannot be compiled here: no gcc, or no
    Python.h for this interpreter."""
    if shutil.which("gcc") is None:
        pytest.skip("gcc is not installed on this machine")
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        pytest.skip("this interpreter's Python.h is not installed (%s)" % inc)


@pytest.fixture(scope="module")
def world():
    """The 6 x 6 grid in both packages and a port matcher on the CPU."""
    ra = ref_build_graph_arrays(ref_grid_city(rows=6, cols=6, spacing_m=150.0),
                                cell_size=100.0)
    pa = build_graph_arrays(grid_city(rows=6, cols=6, spacing_m=150.0), cell_size=100.0)
    pu = build_ubodt(pa, delta=1500.0)
    m = SegmentMatcher(arrays=pa, ubodt=pu, device="cpu",
                       config=MatcherConfig(length_buckets=[16, 64]))
    return ra, ref_build_ubodt(ra, delta=1500.0), m


def _matches(m, b, t, seed):
    """(edge, offset, breaks, abs_tm, n_pts) of a seeded b x t cohort
    matched by ``m``, as association receives them."""
    traces = [s.trace for s in TraceSynthesizer(m.arrays, seed=seed).batch(
        b, t, dt=5.0, sigma=4.0)]
    idxs = list(range(b))
    px, py, tm, valid, times = m._fill_rows(traces, idxs, m._bucket_len(t))
    (edge, offset, breaks), _aux = m._collect_batch(m._dispatch_batch(px, py, tm, valid))
    abs_tm = np.zeros(edge.shape, np.float64)
    n_pts = np.zeros(b, np.int32)
    for row in range(b):
        n_pts[row] = len(times[row])
        abs_tm[row, :n_pts[row]] = times[row]
    return edge[:b], offset[:b], breaks[:b], abs_tm, n_pts


def _columns(m, edge, offset, breaks, abs_tm, n_pts):
    return assoc_native.association_columns(
        m.arrays, m.ubodt, edge, offset, breaks, abs_tm, n_pts,
        m.cfg.queue_speed_threshold_kph / 3.6, 2.0 * m.cfg.sigma_z + 5.0,
        native.require_lib())


@pytest.mark.parametrize("b,t,seed", [(16, 12, 7), (8, 40, 8), (4, 64, 9), (0, 16, 1)])
def test_build_records_equals_python_loop_and_reference(world, b, t, seed):
    ra, ru, m = world
    ext = native.require_records_ext()
    if b:
        edge, offset, breaks, abs_tm, n_pts = _matches(m, b, t, seed)
    else:  # an empty batch
        edge = np.zeros((0, t), np.int32)
        offset, abs_tm = np.zeros((0, t), np.float32), np.zeros((0, t))
        breaks, n_pts = np.zeros((0, t), bool), np.zeros(0, np.int32)
    cols = _columns(m, edge, offset, breaks, abs_tm, n_pts)
    got = ext.build_records(b, *cols)
    assert len(got) == b
    assert json.dumps(got) == json.dumps(assoc_native.records_py(b, *cols))
    before = (assoc_native.records_ext_calls, assoc_native.records_py_calls)
    batch = assoc_native.associate_segments_batch(
        m.arrays, m.ubodt, edge, offset, breaks, abs_tm, n_pts,
        queue_thresh_mps=m.cfg.queue_speed_threshold_kph / 3.6,
        back_tol=2.0 * m.cfg.sigma_z + 5.0)
    assert (assoc_native.records_ext_calls, assoc_native.records_py_calls) == \
        (before[0] + 1, before[1])
    want = ref_associate(ra, ru, edge, offset, breaks, abs_tm, n_pts,
                         queue_thresh_mps=m.cfg.queue_speed_threshold_kph / 3.6,
                         back_tol=2.0 * m.cfg.sigma_z + 5.0)
    assert json.dumps(batch) == json.dumps(got) == json.dumps(want)
    if b:
        assert sum(len(r) for r in got) > 0


def test_wrong_dtype_raises_then_the_logged_loop_counts(world, caplog):
    """seg_id as float64: the extension's buffer check raises TypeError;
    ``build_records`` logs it and the Python loop builds the records."""
    _ra, _ru, m = world
    cols = list(_columns(m, *_matches(m, 8, 12, 11)))
    cols[2] = cols[2].astype(np.float64)  # seg_id, int64 in the contract
    with pytest.raises(TypeError):
        native.require_records_ext().build_records(8, *cols)
    before = (assoc_native.records_ext_calls, assoc_native.records_py_calls)
    with caplog.at_level(logging.WARNING, logger=assoc_native.__name__):
        got = assoc_native.build_records(8, *cols)
    assert (assoc_native.records_ext_calls, assoc_native.records_py_calls) == \
        (before[0], before[1] + 1)
    assert any("records extension rejected" in r.getMessage() for r in caplog.records)
    assert json.dumps(got) == json.dumps(assoc_native.records_py(8, *cols))


def test_require_records_ext_raises_on_a_broken_source(tmp_path, monkeypatch):
    """A copy of the source with a syntax error under tmp_path (the
    repository's native/ untouched): ``require_records_ext`` raises with
    the compiler's message, and ``get_records_ext`` answers None."""
    src = tmp_path / "records_ext.c"
    src.write_text(open(native.RECORDS_SRC).read() + "\nthis is not C;\n")
    monkeypatch.setattr(native, "RECORDS_SRC", str(src))
    monkeypatch.setattr(native, "RECORDS_EXT", str(tmp_path / "_records.so"))
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "_ext_error", None)
    with pytest.raises(RuntimeError, match="records extension could not be built") as e:
        native.require_records_ext()
    assert "error" in str(e.value) and "records_ext.c" in str(e.value)
    assert native.get_records_ext() is None
    assert not (tmp_path / "_records.so").exists()


def test_extension_lives_in_the_build_directory():
    ext = native.require_records_ext()
    path = os.path.realpath(ext.__file__)
    assert path == os.path.realpath(native.RECORDS_EXT)
    assert path.startswith(os.path.realpath(BUILD_DIR) + os.sep)
    assert not path.startswith(os.path.realpath(os.path.join(REPO_ROOT, "native")) + os.sep)
    assert native.RECORDS_EXT.endswith(sysconfig.get_config_var("EXT_SUFFIX"))
    assert native.RECORDS_SRC == os.path.join(REPO_ROOT, "native", "records_ext.c")
