"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for sm_90a into its own shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  ``--fmad=false`` stops nvcc from contracting
``a*b+c`` on its own: the kernels fuse a multiply-add (``__fmaf_rn``)
exactly where the reference, as XLA compiles it, does, and round every
other operation separately (``__f*_rn``).  Nothing is built when a
module is imported: the first launch (or ``build_kernels()``) builds every
kernel, one ``nvcc`` per source, all started together.

Every kernel has a ``launches`` counter that its wrapper bumps once per
launch; ``reset_launches()`` zeroes them all.  The same launch also adds
one to ``reporter_kernel_launches_total{kernel}`` on /metrics, which is
never reset (the port's own family: the JAX package has no hand-written
kernels), so a fleet's federated /metrics shows each replica's launches.  Each launch call runs inside
the profiler range ``rs.<stage>/<name>`` of its stage label
(``Kernel.stage``, one of ``obs.attrib.STAGES``), which attributes its
device time.  The SPARSE instantiations
of kernels 3-5 (the sparse-gap model) and the wide32 instantiation of
kernel 2 are entry points of the same libraries, counted apart under
``<name>[sparse]`` and ``ubodt_probe[wide32]``; the dedup claim and
scatter kernels share one library, and so do the four log-depth (assoc)
Viterbi kernels, ``viterbi_assoc`` and ``viterbi_chain_assoc`` with their
``[sparse]`` instantiations.  Kernel 2's tiered instantiations (rows from
a hot arena or pinned host pages) are counted apart as
``ubodt_probe[tiered]`` and ``ubodt_probe[wide32,tiered]``;
``host_register`` maps a tiered table's host pages into the card's
address space.  The device mesh's kernels: kernel 2's bucket-range
instantiations for a gp rank, ``ubodt_probe[sharded]`` and
``ubodt_probe[wide32,sharded]``, and for a gp rank of a tiered table
``ubodt_probe[tiered,sharded]`` and ``ubodt_probe[wide32,tiered,sharded]``,
the ``segment_histogram`` and the slot-sharded slab's
``slab_gather_owned`` and ``slab_scatter_owned`` (one library).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Dict, List, Optional

import torch

from .._build import BUILD_DIR, PKG_DIR, build_all
from ..obs import metrics as obs
from ..obs.attrib import stage

CSRC = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

C_LAUNCHES = obs.counter(
    "reporter_kernel_launches_total",
    "Hand-written CUDA kernel launches by entry point, counted where each "
    "wrapper launches its kernel (never reset)",
    ("kernel",))

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F = ctypes.c_float


class Kernel:
    """One CUDA kernel entry point: its source, its C function
    ``<entry>_launch``, its launch count and its stage label (the JAX
    package's stages it fuses, joined by ``+``; obs/attrib.py).
    ``source`` defaults to ``name`` and ``entry`` to the source's name."""

    def __init__(self, name: str, stage: str, argtypes: List[type],
                 source: Optional[str] = None, entry: Optional[str] = None):
        self.name = name
        base = source or name
        self.base = base
        self.entry = entry or base
        self.source = os.path.join(CSRC, base + ".cu")
        self.library = os.path.join(BUILD_DIR, "lib%s.so" % base)
        self.argtypes = argtypes
        self.launches = 0
        self._counted = C_LAUNCHES.labels(name)
        self.stage = stage
        self._fn = None
        self._err = None

    def _bind(self) -> None:
        lib = ctypes.CDLL(self.library)
        fn = getattr(lib, self.entry + "_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = self.argtypes + [_P]  # + stream
        err = getattr(lib, self.base + "_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        self._fn, self._err = fn, err

    def launch(self, device: torch.device, *args) -> None:
        """Launch on the current stream of ``device`` and count it; raises
        when the launch is refused."""
        if self._fn is None:
            build_kernels()
        stream = torch.cuda.current_stream(device).cuda_stream
        # the profiler's range rs.<stage>/<name> around the launch call
        # (obs/attrib.py); it synchronises nothing
        with stage(self.stage, self.name):
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError("%s launch failed: %s (cudaError %d)" % (
                self.name, self._err(rc).decode(errors="replace"), rc))
        # the service launches from several threads (dispatch, bisect on
        # the finisher, the re-attach probe): no count may be lost
        with _count_lock:
            self.launches += 1
        self._counted.inc()


_SPARSE = [_F] * 6  # the sparse model's scalars, after the dense arguments
_BUILD = [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32,
          _F, _F, _F, _F, _F, _F, _P, _P, _P]
_SCAN = [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _F, _P, _P]
_TIER = [_P] * 4  # slot_map, arena, counts, totals (all null: untiered)
# + seam_dist, seam_time (null: the seam probes the table itself)
_CHAIN = ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32] + _TIER
          + [_P, _P] + [_I64, _I32, _I32, _F, _F, _F, _F, _F, _F, _F] + [_P] * 16
          + [_P, _P, _I64, _P, _P])
_PROBE = [_P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P]
_GRID = [_P, _P, _P, _P, _P]  # src, dst, dims, src strides, dst strides
_SLAB = [_P] * 8 + [_I64, _I64, _P, _I64, _I32, _P]  # leaves, s_local, lo, slots, B, K, words

_SWEEP = "candidate-sweep"
_PRB = "ubodt-probe+select"
_CLAIM = "dedup-sort+dedup-compact"
_BLD = "emission+transition-build"
_VIT = "scan-recursion+backtrace+compact-gather"
_ASSOC = "assoc-recursion"  # its backtrace and gather run in the same launch

KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("candidate_sweep", _SWEEP, [
        _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _F, _F, _F, _I32, _F, _F,
        _P, _P, _P, _P, _P, _P, _P, _P]),
    Kernel("ubodt_probe", _PRB, _PROBE),
    Kernel("ubodt_probe[wide32]", _PRB, _PROBE, "ubodt_probe", "ubodt_probe_wide32"),
    Kernel("ubodt_probe[tiered]", _PRB, _PROBE + _TIER, "ubodt_probe",
           "ubodt_probe_tiered"),
    Kernel("ubodt_probe[wide32,tiered]", _PRB, _PROBE + _TIER, "ubodt_probe",
           "ubodt_probe_wide32_tiered"),
    # a gp rank's bucket range: + lo, L
    Kernel("ubodt_probe[sharded]", _PRB, _PROBE + [_I32, _I32], "ubodt_probe",
           "ubodt_probe_sharded"),
    Kernel("ubodt_probe[wide32,sharded]", _PRB, _PROBE + [_I32, _I32], "ubodt_probe",
           "ubodt_probe_wide32_sharded"),
    # a gp rank of a tiered table: its tier, then lo, L
    Kernel("ubodt_probe[tiered,sharded]", _PRB, _PROBE + _TIER + [_I32, _I32],
           "ubodt_probe", "ubodt_probe_tiered_sharded"),
    Kernel("ubodt_probe[wide32,tiered,sharded]", _PRB, _PROBE + _TIER + [_I32, _I32],
           "ubodt_probe", "ubodt_probe_wide32_tiered_sharded"),
    Kernel("ubodt_dedup_claim", _CLAIM, _GRID + [_P, _P, _I64, _P, _P, _P, _P, _I64,
                                                 _P], "ubodt_dedup", "ubodt_dedup_claim"),
    Kernel("ubodt_dedup_scatter", "dedup-scatter",
           _GRID + [_P, _P, _P, _I64, _P, _P, _P, _P, _I32, _I32, _P, _P, _P] + _TIER,
           "ubodt_dedup", "ubodt_dedup_scatter"),
    Kernel("probe_stats", "probe-stats", [_P, _P, _P, _P, _P, _I64, _I32, _I32, _F, _F,
                                          _P, _P]),
    Kernel("transition_build", _BLD, _BUILD),
    Kernel("viterbi_scan", _VIT, _SCAN + [_P]),  # + choice (null: not written)
    Kernel("viterbi_chain", _VIT, _CHAIN),
    Kernel("transition_build[sparse]", _BLD, _BUILD + _SPARSE,
           "transition_build", "transition_build_sparse"),
    Kernel("viterbi_scan[sparse]", _VIT, _SCAN + [_P] + _SPARSE,  # + times
           "viterbi_scan", "viterbi_scan_sparse"),
    Kernel("viterbi_chain[sparse]", _VIT, _CHAIN + _SPARSE,
           "viterbi_chain", "viterbi_chain_sparse"),
    # the log-depth forward: kernel 4's and 5's arguments + the workspace
    Kernel("viterbi_assoc", _ASSOC, _SCAN + [_P]),
    Kernel("viterbi_assoc[sparse]", _ASSOC, _SCAN + [_P, _P] + _SPARSE,  # + times
           "viterbi_assoc", "viterbi_assoc_sparse"),
    Kernel("viterbi_chain_assoc", _ASSOC, _CHAIN + [_P], "viterbi_assoc",
           "viterbi_chain_assoc"),
    Kernel("viterbi_chain_assoc[sparse]", _ASSOC, _CHAIN + [_P] + _SPARSE,
           "viterbi_assoc", "viterbi_chain_assoc_sparse"),
    # choice, route, cand_edge, breaks, times, edge_seg, B, T, K, S, out
    Kernel("segment_histogram", "segment-histogram",
           [_P] * 6 + [_I64, _I32, _I32, _I32, _P]),
    Kernel("slab_gather_owned", "slab-shard", _SLAB, "slab_shard", "slab_gather_owned"),
    Kernel("slab_scatter_owned", "slab-shard", _SLAB, "slab_shard", "slab_scatter_owned"),
)}

_build_lock = threading.Lock()


def nvcc_path() -> Optional[str]:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def build_jobs() -> Dict[str, tuple]:
    """{library: (nvcc argv, sources)} for every kernel (``_build.build_all``
    input)."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    headers = [os.path.join(CSRC, n) for n in sorted(os.listdir(CSRC))
               if n.endswith(".cuh")]
    return {k.library: ([nvcc] + NVCC_FLAGS + [k.source], [k.source] + headers)
            for k in KERNELS.values()}  # one job per source


def build_kernels() -> Dict[str, str]:
    """Build (when stale) and bind every kernel; returns {library: nvcc
    output} for those compiled by this call."""
    with _build_lock:
        out = build_all(build_jobs())
        for k in KERNELS.values():
            if k._fn is None:
                k._bind()
        return out


_host_lock = threading.Lock()
# registered host buffers: start address -> [device address, references,
# bytes]
_HOST: Dict[int, list] = {}


def _registered(addr: int, nbytes: int):
    """The start of the registered buffer that holds [addr, addr + nbytes),
    None when none overlaps it; raises on a partial overlap, which CUDA
    would refuse (cudaErrorHostMemoryAlreadyRegistered)."""
    for start, (_dev, _refs, size) in _HOST.items():
        if start <= addr and addr + nbytes <= start + size:
            return start
        if addr < start + size and start < addr + nbytes:
            raise ValueError(
                "host range [%#x, %#x) overlaps the registered buffer "
                "[%#x, %#x) without lying inside it" % (
                    addr, addr + nbytes, start, start + size))
    return None


def _probe_lib():
    if KERNELS["ubodt_probe"]._fn is None:
        build_kernels()
    lib = ctypes.CDLL(KERNELS["ubodt_probe"].library)
    lib.ubodt_host_register.argtypes = [_P, ctypes.c_size_t,
                                        ctypes.POINTER(_P)]
    lib.ubodt_host_unregister.argtypes = [_P]
    lib.ubodt_memory_type.argtypes = [_P]
    for fn in (lib.ubodt_host_register, lib.ubodt_host_unregister,
               lib.ubodt_memory_type):
        fn.restype = ctypes.c_int
    return lib


def host_register(addr: int, nbytes: int) -> int:
    """Page-lock ``nbytes`` of host memory at ``addr`` and map it into the
    card's address space; returns the address kernels read it by.  A range
    inside a buffer already registered is not registered again: it takes
    a reference to that buffer and its address at the same offset.
    Raises when CUDA refuses or the range straddles a registered buffer."""
    with _host_lock:
        start = _registered(addr, nbytes)
        if start is None:
            lib = _probe_lib()
            dev = _P()
            rc = lib.ubodt_host_register(_P(addr), nbytes, ctypes.byref(dev))
            if rc != 0:
                raise RuntimeError("cudaHostRegister of %d bytes failed: %s "
                                   "(cudaError %d)" % (nbytes, KERNELS[
                                       "ubodt_probe"]._err(rc).decode(), rc))
            start = addr
            _HOST[addr] = [int(dev.value), 0, int(nbytes)]
        ent = _HOST[start]
        ent[1] += 1
        return ent[0] + (addr - start)


def host_unregister(addr: int) -> None:
    """Drop one reference that ``host_register`` gave for ``addr``; the
    buffer's last one unregisters it."""
    with _host_lock:
        start = _registered(addr, 1)
        if start is None:
            return
        ent = _HOST[start]
        ent[1] -= 1
        if ent[1] == 0:
            del _HOST[start]
            _probe_lib().ubodt_host_unregister(_P(start))


def memory_type(addr: int) -> int:
    """CUDA's memory type of an address: 1 page-locked host, 2 device, 0
    unregistered host memory, -1 when CUDA cannot tell."""
    return int(_probe_lib().ubodt_memory_type(_P(addr)))


def library_function(kernel: str, symbol: str, restype, argtypes):
    """A plain C function of ``kernel``'s library (a size query), after
    building and binding the kernels if needed."""
    k = KERNELS[kernel]
    if k._fn is None:
        build_kernels()
    fn = getattr(ctypes.CDLL(k.library), symbol)
    fn.restype, fn.argtypes = restype, argtypes
    return fn


_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in KERNELS.values():
            k.launches = 0


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """The tensor's device address; None gives a null pointer (an output
    the kernel skips)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device,
          shape=None) -> None:
    """Validate a kernel argument: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, t.dtype, dtype))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
