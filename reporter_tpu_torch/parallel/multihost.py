"""Multi-controller execution of the matcher: one process per host, one mesh
across them.

The port of ``reporter_tpu/parallel/multihost.py`` on ``torch.distributed``.
Each process is one controller: it holds ``--local-devices`` ranks of the
global mesh (one device each; they may share a card, as the mesh's ranks
may within a process) and feeds the global batch's rows those ranks own.
The global mesh is the reference's: ``processes x local`` devices in
process order, gp innermost, dp rows of ``gp`` consecutive devices.

  - within a process the mesh runs as it does in one process
    (``sharded_match_fn`` / ``graph_sharded_match_fn`` over the local dp
    rows, the collectives of ``ops/collectives.py``);
  - a dp row wider than one process (gp > local) spans several: each of
    them matches the row's batch block with its own gp ranks' bucket
    ranges, and every probe's pmin / pmax crosses the processes of the row
    as ``dist.all_reduce`` MIN / MAX (``ShardedUBODT.group``);
  - the per-segment histogram and the matched count reduce over every
    process with ``dist.all_reduce`` SUM, each dp row counted once (by the
    process that holds its gp rank 0).

Every process prints the same line (the reference's, byte for byte)::

    python -m reporter_tpu_torch.parallel.multihost \\
        --coordinator 127.0.0.1:9911 --processes 2 --process-id {0,1} \\
        [--device cuda|cpu] [--local-devices N] [--backend nccl|gloo] \\
        [--graph-devices G]

The backend is the caller's choice: NCCL by default on cards, gloo on the
CPU, and nothing switches it.  NCCL runs one rank a GPU (it refuses a
second rank on a card: "Duplicate GPU detected"), so ``--backend nccl``
with more processes on this host than visible cards exits 2 with a message
before any rendezvous; run such processes under ``--backend gloo``, whose
``all_reduce`` takes CUDA tensors too.  A process on the cards uses card
``process_id % cards``.
"""

from __future__ import annotations

import argparse
import datetime
import ipaddress
import json
import socket
import sys
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["Placement", "backend_refusal", "init_multihost", "put_global",
           "global_batch", "run_dryrun", "main"]

BACKENDS = ("nccl", "gloo")


class Placement(NamedTuple):
    """This process's part of the global mesh: ``processes`` x ``local``
    devices, ``n_gp`` of them a dp row, process ``process_id`` holding
    global devices [process_id * local, (process_id + 1) * local) on
    ``devices``."""

    processes: int
    process_id: int
    devices: List[torch.device]
    n_gp: int

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def n_devices(self) -> int:
        return self.processes * self.local

    @property
    def n_dp(self) -> int:
        return self.n_devices // self.n_gp

    @property
    def row_span(self) -> int:
        """Processes a dp row spans (1 when a process holds whole rows)."""
        return max(1, self.n_gp // self.local)

    def dp_rows(self) -> range:
        """The global dp rows this process holds, or the one it shares."""
        if self.n_gp <= self.local:
            per = self.local // self.n_gp
            return range(self.process_id * per, (self.process_id + 1) * per)
        r = self.process_id // self.row_span
        return range(r, r + 1)

    @property
    def gp_offset(self) -> int:
        """The first gp rank this process holds in its dp row."""
        return (self.process_id % self.row_span) * self.local if \
            self.n_gp > self.local else 0

    @property
    def leads_row(self) -> bool:
        """Whether this process holds gp rank 0 of its dp rows (the one
        that counts them in the global sums)."""
        return self.gp_offset == 0


def _loopback(coordinator: str) -> bool:
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return socket.gethostname() == host


def backend_refusal(backend: str, device: str, processes: int, cards: int,
                    coordinator: str) -> Optional[str]:
    """Why this launch cannot run on ``backend``, or None: NCCL needs the
    cards, and one card a process, which a loopback coordinator (every
    process on this host) lets us count here."""
    if backend not in BACKENDS:
        return "unknown backend %r (expected one of %s)" % (backend, BACKENDS)
    if backend != "nccl":
        return None
    if device != "cuda":
        return "--backend nccl runs on the cards (--device cuda), not on %s" % device
    if _loopback(coordinator) and processes > cards:
        return ("--backend nccl runs one rank a GPU (NCCL refuses a second rank "
                "on a card: Duplicate GPU detected), but %d processes on this "
                "host share %d visible card(s); run them under --backend gloo, "
                "or one process a card" % (processes, cards))
    return None


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str, timeout_s: float = 300.0):
    """The rendezvous: ``torch.distributed.init_process_group`` at
    ``tcp://coordinator`` with the world size and rank given.  Returns the
    ``torch.distributed`` module."""
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method="tcp://" + coordinator, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return dist


def put_global(pl: Placement, spec: tuple, x: np.ndarray):
    """This process's part of the host array ``x`` (byte-identical in every
    process) under a rule spec: ("dp",) the batch rows of its dp rows, as
    one tensor on its first device; () the whole value on each of its
    devices."""
    from .rules import BATCH_AXIS

    if BATCH_AXIS in spec:
        ax = spec.index(BATCH_AXIS)
        rows = x.shape[ax] // pl.n_dp
        r = pl.dp_rows()
        part = np.take(x, np.arange(r.start * rows, r.stop * rows), axis=ax)
        return torch.from_numpy(np.ascontiguousarray(part)).to(pl.devices[0])
    return [torch.from_numpy(np.ascontiguousarray(x)).to(d) for d in pl.devices]


def global_batch(pl: Placement, arrays: Sequence[np.ndarray]) -> tuple:
    """[B_global, ...] host arrays -> this process's rows of each."""
    from .rules import BATCH_AXIS

    return tuple(put_global(pl, (BATCH_AXIS,), a) for a in arrays)


def _row_groups(dist, pl: Placement):
    """The process group of this process's dp row when the row spans
    processes (every process creates every row's group, in order)."""
    mine = None
    if pl.row_span > 1:
        for r in range(pl.processes // pl.row_span):
            g = dist.new_group(list(range(r * pl.row_span, (r + 1) * pl.row_span)))
            if r == pl.dp_rows().start:
                mine = g
    return mine


def _match_local(dist, pl: Placement, arrays, ubodt, cfg, batch, p):
    """Match this process's rows: (idx [rows, T] on its first device, the
    histogram it adds to the global sum)."""
    from ..tiles.ubodt import ShardedUBODT
    from .mesh import (
        check_ubodt_shardable, graph_sharded_match_fn, make_mesh, make_mesh2,
        match_and_histogram, sharded_match_fn,
    )

    S = len(arrays.seg_ids)
    if pl.n_gp <= pl.local:
        if pl.n_gp > 1:
            check_ubodt_shardable(ubodt, pl.n_gp)
            fn = graph_sharded_match_fn(
                make_mesh2(pl.local // pl.n_gp, pl.n_gp, pl.devices), cfg.beam_k, S)
        else:
            fn = sharded_match_fn(make_mesh(pl.local, pl.devices), cfg.beam_k, S)
        res, hist = fn(arrays.device_graph(), ubodt.device_ubodt(), *batch, p)
        return res.idx, hist
    # a dp row across processes: this process's gp ranks, merged with the
    # row's other processes on every probe
    check_ubodt_shardable(ubodt, pl.n_gp)
    group = _row_groups(dist, pl)
    du = ubodt.device_ubodt()
    dev = pl.devices[0]
    views = ShardedUBODT((du.shard(pl.gp_offset + j, pl.n_gp, d)
                          for j, d in enumerate(pl.devices)), group=group)
    res, hist = match_and_histogram(arrays.to_device(dev), views, *batch, p,
                                    cfg.beam_k, S)
    return res.idx, hist


def run_dryrun(coordinator: str, num_processes: int, process_id: int,
               backend: str, device: str = "cuda", local_devices: int = 1,
               rows: int = 5, cols: int = 5, T: int = 16,
               graph_devices: int = 1) -> dict:
    """Build the reference's tiny deterministic scenario, match a global
    batch of 2 x devices rows over every process's devices and return
    {"devices", "local_devices", "graph_devices", "batch", "matched",
    "hist_total", "launches"}: all but the launches are globally reduced,
    so every process returns the same numbers."""
    from ..ops import _kernels
    from ..ops.viterbi import MatchParams
    from ..synth.generator import dryrun_scenario, example_grid_batch

    n_gp = int(graph_devices)
    if n_gp < 1:
        raise ValueError("graph_devices must be >= 1, got %d" % n_gp)
    n_local = int(local_devices)
    if device == "cuda":
        dev = torch.device("cuda", process_id % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    pl = Placement(num_processes, process_id, [dev] * n_local, n_gp)
    if pl.n_devices % n_gp:
        raise ValueError("graph_devices=%d must divide device count %d"
                         % (n_gp, pl.n_devices))
    if n_gp > n_local and n_gp % n_local:
        raise ValueError("graph_devices=%d must be a multiple of local_devices=%d"
                         % (n_gp, n_local))
    if n_gp < n_local and n_local % n_gp:
        raise ValueError("graph_devices=%d must divide local_devices=%d"
                         % (n_gp, n_local))
    dist = init_multihost(coordinator, num_processes, process_id, backend)
    try:
        cfg, arrays, ubodt = dryrun_scenario(rows=rows, cols=cols)
        B = 2 * pl.n_devices
        batch = global_batch(pl, example_grid_batch(arrays, B, T, seed=3))
        before = {k: v.launches for k, v in _kernels.KERNELS.items()}
        idx, hist = _match_local(dist, pl, arrays, ubodt, cfg, batch,
                                 MatchParams.from_config(cfg))
        launches = {k: v.launches - before[k] for k, v in _kernels.KERNELS.items()}
        lead = 1 if pl.leads_row else 0
        # the global sums: matched points and the histogram's point count
        sums = torch.stack([(idx >= 0).sum().to(torch.float64) * lead,
                            hist.point_count.to(torch.float64).sum() * lead])
        sums = sums.to(dev)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        matched, hist_total = sums.cpu().tolist()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return {"devices": pl.n_devices, "local_devices": n_local,
            "graph_devices": n_gp, "batch": B, "matched": int(matched),
            "hist_total": float(hist_total), "launches": launches}


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="mesh ranks this process holds (on its one device)")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="torch.distributed backend (default: nccl on cuda, "
                         "gloo on cpu; never switched)")
    ap.add_argument("--rows", type=int, default=5)
    ap.add_argument("--cols", type=int, default=5)
    ap.add_argument("--t", type=int, default=16)
    ap.add_argument("--graph-devices", type=int, default=1,
                    help="shard the UBODT over a gp mesh axis of this size")
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    why = backend_refusal(backend, args.device, args.processes, cards,
                          args.coordinator)
    if why is None and args.device == "cuda" and not cards:
        why = "--device cuda but no card is visible"
    if why is not None:
        sys.stderr.write("multihost: %s\n" % why)
        return 2
    import logging

    from ..obs import log as obs_log

    obs_log.configure()  # REPORTER_LOG_FORMAT / REPORTER_LOG_LEVEL
    out = run_dryrun(args.coordinator, args.processes, args.process_id, backend,
                     device=args.device, local_devices=args.local_devices,
                     rows=args.rows, cols=args.cols, T=args.t,
                     graph_devices=args.graph_devices)
    assert out["matched"] > 0, "multi-host dryrun matched nothing"
    assert out["hist_total"] > 0, "multi-host histogram reduction empty"
    launches = out.pop("launches")
    obs_log.event(logging.getLogger(__name__), "multihost_dryrun_ok", **out)
    # every controller prints this line byte-identical: no per-process field
    print("multihost dryrun ok: %(devices)d devices (%(local_devices)d local, "
          "gp %(graph_devices)d), batch %(batch)d, %(matched)d matched "
          "points, hist_total %(hist_total).1f" % out)
    print("multihost kernel launches: %s"
          % json.dumps({k: v for k, v in launches.items() if v}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
