"""The port stands alone: it imports neither JAX nor anything of the
reference package ``reporter_tpu``, and its entry points refuse to run on
a CUDA device that is not there instead of falling back to the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = r'''
import importlib.abc, sys

def blocked(name):
    return name.startswith("jax") or name == "reporter_tpu" or name.startswith("reporter_tpu.")

for mod in [m for m in sys.modules if blocked(m)]:
    del sys.modules[mod]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if blocked(name):
            raise ImportError("blocked import of %s" % name)
        return None

sys.meta_path.insert(0, Block())

import reporter_tpu_torch
import reporter_tpu_torch.convert
import reporter_tpu_torch.matching.arena
import reporter_tpu_torch.matching.session
import reporter_tpu_torch.matching.sparse
import reporter_tpu_torch.serve.__main__
from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher, SessionEngine, SessionStore
from reporter_tpu_torch.synth import TraceSynthesizer
from reporter_tpu_torch.tiles.arrays import build_graph_arrays
from reporter_tpu_torch.tiles.network import grid_city

arrays = build_graph_arrays(grid_city(5, 5, 150.0))
m = SegmentMatcher(arrays=arrays, device="cpu",
                   config=MatcherConfig(ubodt_delta=1500.0, length_buckets=[16],
                                        session_arena=True))
traces = [s.trace for s in TraceSynthesizer(arrays, seed=1).batch(3, 20, dt=5.0)]
out = m.match_many(traces)  # 20 points: two windows of 16 with carried state
assert len(out) == 3 and all(r["segments"] for r in out)
eng = SessionEngine(m, SessionStore())
for j in range(0, 20, 4):
    res = eng.match_many([dict(t, trace=t["trace"][j:j + 4]) for t in traces])
assert all(r["_stream"]["session"]["points_total"] == 20 for r in res)
assert m.session_arena.summary()["hot_used"] == 3
# the sparse model, calibrated: windowed, long and streaming 60 s traffic
sm = SegmentMatcher(arrays=arrays, ubodt=m.ubodt, device="cpu",
                    config=MatcherConfig(length_buckets=[16], sparse=True,
                                         calibration="CALIBRATION.json"))
assert sm.sparse.summary()["calibrated"]
# one fix a minute: the 5 s traces' points, 60 s apart
sparse = [dict(t, uuid=t["uuid"] + "-60", trace=[dict(p, time=p["time"] * 12.0)
                                                 for p in t["trace"]]) for t in traces[:2]]
out = sm.match_many(sparse + [dict(t, trace=t["trace"][:8]) for t in sparse])
assert all(r["segments"] for r in out) and sm.sparse.dispatch == {"ge60": 4}
eng = SessionEngine(sm, SessionStore())
res = eng.match_many([dict(t, trace=t["trace"][:4]) for t in sparse])
assert sm.sparse.dispatch == {"ge60": 6}
assert not [m for m in sys.modules if blocked(m)]
print("ISOLATED-OK")
'''


def test_port_imports_and_matches_with_jax_and_reference_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b)"
    r"|reporter_tpu\.|from\s+reporter_tpu\s", re.M)


def test_no_jax_or_reference_imports_in_port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "reporter_tpu_torch")):
        files.extend(os.path.join(root, n) for n in names if n.endswith(".py"))
    hits = []
    for path in files:
        with open(path) as f:
            text = f.read()
        hits.extend("%s: %s" % (os.path.relpath(path, REPO), m.group(0).strip())
                    for m in _FORBIDDEN.finditer(text))
    assert len(files) > 20
    assert hits == []


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from reporter_tpu_torch import resolve_device
    from reporter_tpu_torch.matching import MatcherConfig, SegmentMatcher
    from reporter_tpu_torch.serve.__main__ import main
    from reporter_tpu_torch.tiles.arrays import build_graph_arrays
    from reporter_tpu_torch.tiles.network import grid_city
    from reporter_tpu_torch.tiles.ubodt import build_ubodt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = build_graph_arrays(grid_city(4, 4, 150.0))
    ubodt = build_ubodt(arrays, delta=1000.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegmentMatcher(arrays=arrays, ubodt=ubodt, config=MatcherConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        arrays.to_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ubodt.to_device()
    cfg = tmp_path / "config.json"
    cfg.write_text('{"network": {"type": "grid", "rows": 4, "cols": 4}}')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(cfg), "127.0.0.1:0"])
    # asked for explicitly, the CPU runs the plain versions
    assert SegmentMatcher(arrays=arrays, ubodt=ubodt, config=MatcherConfig(),
                          device="cpu").device.type == "cpu"
