"""The port's multi-controller entry point against the JAX package.

Two processes of ``python -m reporter_tpu_torch.parallel.multihost`` on
the CPU rendezvous under gloo on a free port and match the global batch
over their combined devices; their lines must be byte-identical, and the
numbers in them the reference's for the same global batch: its
single-process ``sharded_match_fn`` / ``graph_sharded_match_fn`` over
conftest's virtual CPU devices (tests/test_multihost.py runs the
reference's own two processes).  At gp 2 with one device a process, every
UBODT probe's pmin / pmax crosses the two processes.  The NCCL rule (one
rank a GPU) is held by its argument check alone: no NCCL runs here."""

import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from reporter_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^multihost dryrun ok: (\d+) devices \((\d+) local, gp (\d+)\), "
                  r"batch (\d+), (\d+) matched points, hist_total ([\d.]+)$")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               GLOO_LOG_LEVEL="ERROR", CUDA_VISIBLE_DEVICES="")
    return env


def _run(*args, processes=2, timeout=120):
    """Run the CLI in ``processes`` processes; (return codes, outputs)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "reporter_tpu_torch.parallel.multihost",
         "--coordinator", "127.0.0.1:%d" % port, "--processes", str(processes),
         "--process-id", str(pid), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(), cwd=REPO)
        for pid in range(processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:  # a failed rendezvous must not leak its peer
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return [p.returncode for p in procs], outs


def _ref_numbers(n_dev, n_gp, T=16):
    """The reference's (matched points, hist_total) for the dryrun's global
    batch over n_dev virtual devices, gp n_gp, in one process."""
    import jax.numpy as jnp

    from reporter_tpu.ops.viterbi import MatchParams
    from reporter_tpu.parallel.mesh import (
        graph_sharded_match_fn, make_mesh, make_mesh2, sharded_match_fn,
    )
    from reporter_tpu.synth.generator import dryrun_scenario, example_grid_batch

    cfg, arrays, ubodt = dryrun_scenario()
    devs = jax.devices()[:n_dev]
    S = len(arrays.seg_ids)
    if n_gp > 1:
        fn = graph_sharded_match_fn(make_mesh2(n_dev // n_gp, n_gp, devs), cfg.beam_k, S)
    else:
        fn = sharded_match_fn(make_mesh(n_dev, devs), cfg.beam_k, S)
    px, py, times, valid = example_grid_batch(arrays, 2 * n_dev, T, seed=3)
    res, hist = fn(arrays.to_device(), ubodt.to_device(), jnp.asarray(px), jnp.asarray(py),
                   jnp.asarray(times), jnp.asarray(valid), MatchParams.from_config(cfg))
    return int(np.sum(np.asarray(res.idx) >= 0)), float(np.asarray(hist.point_count).sum())


@pytest.mark.parametrize("local,gp", [(4, 1), (4, 2), (1, 2)])
def test_two_processes_equal_the_reference(local, gp):
    """Two gloo processes print one line, byte for byte, whose numbers are
    the reference's over the same 2 x local devices and global batch."""
    n_dev = 2 * local
    if len(jax.devices()) < n_dev:
        pytest.skip("needs %d virtual devices" % n_dev)
    rcs, outs = _run("--device", "cpu", "--backend", "gloo", "--local-devices", str(local),
                     "--graph-devices", str(gp))
    assert rcs == [0, 0], outs
    lines = [[ln for ln in out.splitlines() if ln.startswith("multihost dryrun ok")]
             for out in outs]
    assert all(len(ls) == 1 for ls in lines), outs
    assert lines[0] == lines[1]
    m = LINE.match(lines[0][0])
    assert m, lines[0][0]
    devices, n_local, n_gp, batch, matched, hist_total = m.groups()
    assert (int(devices), int(n_local), int(n_gp), int(batch)) == (n_dev, local, gp, 2 * n_dev)
    assert (int(matched), float(hist_total)) == _ref_numbers(n_dev, gp)
    # the CPU runs the plain versions: no kernel launched
    assert all("multihost kernel launches: {}" in out for out in outs)


def test_nccl_refuses_two_ranks_on_one_card():
    """NCCL runs one rank a GPU: two processes on this host with one card
    (or none) are refused with a message, by the argument check, before
    any rendezvous; nothing switches the backend."""
    why = multihost.backend_refusal("nccl", "cuda", 2, 1, "127.0.0.1:9911")
    assert why and "one rank a GPU" in why and "--backend gloo" in why
    assert multihost.backend_refusal("nccl", "cuda", 1, 1, "127.0.0.1:9911") is None
    assert multihost.backend_refusal("nccl", "cuda", 2, 2, "localhost:9911") is None
    assert multihost.backend_refusal("gloo", "cuda", 2, 1, "127.0.0.1:9911") is None
    assert "cards" in multihost.backend_refusal("nccl", "cpu", 1, 0, "127.0.0.1:1")
    rcs, outs = _run("--device", "cuda", "--backend", "nccl", timeout=60)
    assert rcs == [2, 2]
    assert all("one rank a GPU" in out and "Traceback" not in out for out in outs)
    rcs, outs = _run("--device", "cpu", "--backend", "nccl", processes=1, timeout=60)
    assert rcs == [2] and "--backend nccl runs on the cards" in outs[0]


def test_placement():
    """Which rows and gp ranks a process holds in the global mesh."""
    import torch

    cpu = torch.device("cpu")
    pl = multihost.Placement(2, 1, [cpu] * 4, 2)
    assert (pl.n_devices, pl.n_dp, list(pl.dp_rows()), pl.gp_offset, pl.leads_row) == \
        (8, 4, [2, 3], 0, True)
    pl = multihost.Placement(4, 3, [cpu] * 2, 8)
    assert (pl.row_span, list(pl.dp_rows()), pl.gp_offset, pl.leads_row) == (4, [0], 6, False)
    x = np.arange(16 * 3).reshape(16, 3)
    pl = multihost.Placement(2, 1, [cpu] * 4, 1)
    assert multihost.put_global(pl, ("dp",), x).tolist() == x[8:].tolist()
    reps = multihost.put_global(pl, (), x)
    assert len(reps) == 4 and all(r.tolist() == x.tolist() for r in reps)
    rows = multihost.global_batch(multihost.Placement(4, 3, [cpu] * 2, 8), (x, x[:, 0]))
    assert rows[0].tolist() == x.tolist() and rows[1].tolist() == x[:, 0].tolist()
