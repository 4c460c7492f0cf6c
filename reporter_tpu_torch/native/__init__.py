"""ctypes binding for the repository's native core (``native/reporter_native.cc``).

Trimmed to the symbols the serving and batch paths call: the RPTT tile
codec (``rn_tile_write``, ``rn_tile_header``, ``rn_tile_read``), the
parallel bounded Dijkstra UBODT build (``rn_ubodt_build`` /
``rn_ubodt_fetch``), the cuckoo and wide32 packers (``rn_cuckoo_pack``,
``rn_wide_pack``), batched segment association (``rn_associate_batch_mt``)
and the batch pipeline's shard-row parser (``rn_parse_shard``).  The shared C++
source at the repository root is compiled with ``g++`` into
``build/reporter_tpu_torch/`` on first use.

``get_lib()`` returns None when no compiler is available: the tile codec,
the UBODT build, association and the shard parser then run their Python
versions, which produce identical output.  ``require_lib()`` raises instead, for callers that
cannot afford the Python UBODT build (a metro-scale table).
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import threading
from typing import Optional

import numpy as np

from .._build import BUILD_DIR, REPO_ROOT, BuildError, build_all

log = logging.getLogger(__name__)

SRC = os.path.join(REPO_ROOT, "native", "reporter_native.cc")
LIB = os.path.join(BUILD_DIR, "libreporter_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_SYMBOLS = {
    "rn_tile_write": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_uint32, _f64p, _f64p, ctypes.c_uint32,
        _u32p, _u32p, _f32p, _u8p, _u8p, _i64p, _i64p, _u32p,
        ctypes.c_uint32, _f64p, _f64p,
    ]),
    "rn_tile_header": (ctypes.c_int, [ctypes.c_char_p, _u32p]),
    "rn_parse_shard": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_int64, _f64p, _f64p, _i64p, _i32p,
        _i64p, _i32p, ctypes.c_int64,
    ]),
    "rn_tile_read": (ctypes.c_int, [
        ctypes.c_char_p, _f64p, _f64p, _u32p, _u32p, _f32p, _u8p, _u8p,
        _i64p, _i64p, _u32p, _f64p, _f64p,
    ]),
    "rn_ubodt_build": (ctypes.c_void_p, [
        ctypes.c_int64, _i32p, _i32p, _i32p, _f32p, _f32p,
        ctypes.c_double, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
    ]),
    "rn_ubodt_fetch": (None, [
        ctypes.c_void_p, _i32p, _i32p, _f32p, _f32p, _i32p,
    ]),
    "rn_cuckoo_pack": (ctypes.c_int64, [
        ctypes.c_int64, _i32p, _i32p, _f32p, _f32p, _i32p,
        ctypes.c_int64, _i32p,
    ]),
    "rn_wide_pack": (ctypes.c_int64, [
        ctypes.c_int64, _i32p, _i32p, _f32p, _f32p, _i32p,
        ctypes.c_int64, _i32p,
    ]),
    "rn_associate_batch_mt": (ctypes.c_int32, [
        # graph
        _i32p, _i32p, _f32p, _i32p, _f32p, _u8p, _i64p, _i64p, _f32p,
        # ubodt (packed table + bmask + entries-per-bucket + rows)
        _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        # matches
        ctypes.c_int64, ctypes.c_int64, _i32p, _f32p, _u8p, _f64p, _i32p,
        # params
        ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        # outputs
        ctypes.c_int64, ctypes.c_int64, _i64p, _u8p, _i64p, _f64p, _f64p,
        _f64p, _u8p, _f64p, _i32p, _i32p, _i64p, _i64p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]),
}


def build_jobs() -> dict:
    """{library: (g++ argv, sources)} (``_build.build_all`` input)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise BuildError("g++ not found")
    return {LIB: ([cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
                   SRC], [SRC])}


def _load() -> ctypes.CDLL:
    build_all(build_jobs())
    lib = ctypes.CDLL(LIB)
    for name, (restype, argtypes) in _SYMBOLS.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first use; None (once logged)
    when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _load()
            except (BuildError, OSError, AttributeError) as e:
                _error = str(e)
                log.warning("native core unavailable, using Python "
                            "versions: %s", e)
        return _lib


def require_lib() -> ctypes.CDLL:
    """``get_lib()`` that raises when the native core cannot be built."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native core could not be built: %s" % _error)
    return lib


def parse_shard_bytes(data: bytes, lib=None):
    """Parse shard rows 'uuid,epoch,lat,lon,acc' -> (uuids, time, lat, lon,
    acc).  Native when available, numpy/python otherwise; both skip torn
    and malformed rows alike."""
    if lib is None:
        lib = get_lib()
    n_lines = data.count(b"\n") + 1
    if lib is not None:
        lat = np.empty(n_lines, np.float64)
        lon = np.empty(n_lines, np.float64)
        tm = np.empty(n_lines, np.int64)
        acc = np.empty(n_lines, np.int32)
        uoff = np.empty(n_lines, np.int64)
        ulen = np.empty(n_lines, np.int32)
        n = lib.rn_parse_shard(data, len(data), lat, lon, tm, acc, uoff, ulen, n_lines)
        # "replace": a torn multi-byte character must not abort the batch
        uuids = [
            data[uoff[i] : uoff[i] + ulen[i]].decode(errors="replace") for i in range(n)
        ]
        return uuids, tm[:n].copy(), lat[:n].copy(), lon[:n].copy(), acc[:n].copy()
    uuids, tms, lats, lons, accs = [], [], [], [], []
    for line in data.decode(errors="replace").splitlines():
        # parse the whole row before appending anything, so a row that fails
        # on a late field can't leave the columns misaligned
        try:
            uuid, tm_, lat_, lon_, acc_ = line.strip().split(",")
            if not uuid:
                continue
            row = (int(tm_), float(lat_), float(lon_), int(acc_))
        except ValueError:
            continue
        uuids.append(uuid)
        tms.append(row[0])
        lats.append(row[1])
        lons.append(row[2])
        accs.append(row[3])
    return (
        uuids,
        np.asarray(tms, np.int64),
        np.asarray(lats, np.float64),
        np.asarray(lons, np.float64),
        np.asarray(accs, np.int32),
    )
