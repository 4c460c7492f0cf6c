"""The quality_skew fault seam of the port's packer against the JAX
package's, and the fleet supervisor's default working directory.

An armed ``REPORTER_FAULT_QUALITY_SKEW`` perturbs the projected
coordinates the device sees with seeded noise of its magnitude (the
reference's ``SegmentMatcher._skew_rows``): the port's packed rows and
its answers must equal the reference's bit for bit armed, and be the
plain pack unarmed."""

import os
import re
import tempfile

import numpy as np
import pytest

from reporter_tpu import faults as ref_faults
from reporter_tpu.matching import MatcherConfig as RefConfig
from reporter_tpu.matching import SegmentMatcher as RefMatcher
from reporter_tpu_torch import faults
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
from reporter_tpu_torch.tools import fleet
from test_fuzz_differential import _canon
from test_torch_tiering import _world, fleet_traces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKEW = "REPORTER_FAULT_QUALITY_SKEW"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("REPORTER_HOST_PACK", "REPORTER_SPARSE", "REPORTER_UBODT_HOT_BYTES",
                "REPORTER_DEVICES", SKEW):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _matchers():
    ra, pa, tables = _world()
    ref = RefMatcher(arrays=ra, ubodt=tables["cuckoo"][0], backend="jax",
                     config=RefConfig(length_buckets=[16]))
    port = SegmentMatcher(arrays=pa, ubodt=tables["cuckoo"][1], device="cpu",
                          config=MatcherConfig(length_buckets=[16]))
    return ra, ref, port


def _rows(m, traces, T=16):
    px, py, tm, valid, times = m._fill_rows(traces, list(range(len(traces))), T)
    return [np.asarray(a).tobytes() for a in (px, py, tm, valid)], [list(t) for t in times]


@pytest.mark.parametrize("spec", ["30.0", "7.5:2"])
def test_armed_skew_equals_reference(monkeypatch, spec):
    """Armed, the port's packed rows equal the reference's bit for bit and
    differ from the plain pack in x and y only; ``match_many`` answers
    equal the reference's; a count-limited spec stops after its count."""
    ra, ref, port = _matchers()
    traces = fleet_traces(ra, n=6)
    plain = _rows(port, traces)
    monkeypatch.setenv(SKEW, spec)
    got, want = _rows(port, traces), _rows(ref, traces)
    assert got == want
    assert got[0][0] != plain[0][0] and got[0][1] != plain[0][1]
    assert got[0][2:] == plain[0][2:] and got[1] == plain[1]
    assert faults.injected("quality_skew") >= 1
    if spec.endswith(":2"):
        # the second firing, then the count is spent: the plain pack
        assert _rows(port, traces) == got and _rows(port, traces) == plain
    faults.reset()
    ref_faults.reset()
    assert [_canon(r) for r in port.match_many(traces)] == \
        [_canon(r) for r in ref.match_many(traces)]


def test_unarmed_skew_changes_nothing(monkeypatch):
    """Unarmed (unset or "off"), the pack is the reference's plain pack
    and no fault fires."""
    ra, ref, port = _matchers()
    traces = fleet_traces(ra, n=4)
    before = faults.injected("quality_skew")
    assert _rows(port, traces) == _rows(ref, traces)
    monkeypatch.setenv(SKEW, "off")
    assert _rows(port, traces) == _rows(ref, traces)
    assert faults.injected("quality_skew") == before


def test_fleet_workdir_default_is_the_references():
    """The supervisor's --workdir default is the reference's
    /tmp/reporter-fleet, under the temporary directory."""
    want = os.path.join(tempfile.gettempdir(), "reporter-fleet")
    assert fleet.parser().get_default("workdir") == want == fleet.DEFAULT_WORKDIR
    assert fleet.parser().parse_args(["--config", "c.json"]).workdir == want
    with open(os.path.join(REPO, "tools", "fleet.py")) as f:
        ref_default = re.search(r'"--workdir", default="([^"]+)"', f.read()).group(1)
    assert ref_default == "/tmp/reporter-fleet"
    if tempfile.gettempdir() == "/tmp":
        assert want == ref_default
