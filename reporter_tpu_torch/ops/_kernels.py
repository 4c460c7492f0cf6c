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
launch; ``reset_launches()`` zeroes them all.  The SPARSE instantiations
of kernels 3-5 (the sparse-gap model) are entry points of the same
libraries, counted apart under ``<name>[sparse]``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Dict, List, Optional

import torch

from .._build import BUILD_DIR, PKG_DIR, build_all

CSRC = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F = ctypes.c_float


class Kernel:
    """One CUDA kernel entry point: its source, its C function
    ``<entry>_launch`` and its launch count.  ``source`` defaults to
    ``name`` and ``entry`` to the source's name."""

    def __init__(self, name: str, argtypes: List[type],
                 source: Optional[str] = None, entry: Optional[str] = None):
        self.name = name
        base = source or name
        self.base = base
        self.entry = entry or base
        self.source = os.path.join(CSRC, base + ".cu")
        self.library = os.path.join(BUILD_DIR, "lib%s.so" % base)
        self.argtypes = argtypes
        self.launches = 0
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
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError("%s launch failed: %s (cudaError %d)" % (
                self.name, self._err(rc).decode(errors="replace"), rc))
        self.launches += 1


_SPARSE = [_F] * 6  # the sparse model's scalars, after the dense arguments
_BUILD = [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32,
          _F, _F, _F, _F, _F, _F, _P, _P, _P]
_SCAN = [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _F, _P, _P]
_CHAIN = ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I64, _I32, _I32,
           _F, _F, _F, _F, _F, _F, _F] + [_P] * 16 + [_P, _P, _I64, _P, _P])

KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("candidate_sweep", [
        _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _F, _F, _F, _I32, _F, _F,
        _P, _P, _P, _P, _P, _P, _P, _P]),
    Kernel("ubodt_probe", [_P, _P, _P, _P, _P, _P, _I32, _P, _P, _P]),
    Kernel("transition_build", _BUILD),
    Kernel("viterbi_scan", _SCAN),
    Kernel("viterbi_chain", _CHAIN),
    Kernel("transition_build[sparse]", _BUILD + _SPARSE,
           "transition_build", "transition_build_sparse"),
    Kernel("viterbi_scan[sparse]", _SCAN + [_P] + _SPARSE,  # + times
           "viterbi_scan", "viterbi_scan_sparse"),
    Kernel("viterbi_chain[sparse]", _CHAIN + _SPARSE,
           "viterbi_chain", "viterbi_chain_sparse"),
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


def reset_launches() -> None:
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
