"""Compile-at-first-use for the port's shared libraries.

Both the host native core (``g++``) and the CUDA kernels (``nvcc``) are
built into ``build/reporter_tpu_torch/`` at the repository root, which git
ignores.  A library is rebuilt when it is missing or older than any of its
sources.  Builds take a file lock (several test workers may ask at once)
and write through a temporary file that is renamed into place, so a
reader never maps a half-written library.  ``build_all`` starts every
compiler it needs at once and waits for all of them.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "reporter_tpu_torch")


class BuildError(RuntimeError):
    pass


def _stale(out: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(os.path.getmtime(s) > t for s in sources)


@contextmanager
def _lock():
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(jobs: Dict[str, Tuple[List[str], Sequence[str]]],
              timeout: float = 600.0) -> Dict[str, str]:
    """Build every stale library of ``jobs`` = {out_path: (argv without the
    output flag, sources)} concurrently.  ``argv`` gets ``-o <tmp>``
    appended.  Returns {output: compiler output} for the libraries that
    were (re)built; raises BuildError with the compiler's output when any
    build fails."""
    built: Dict[str, str] = {}
    with _lock():
        procs = []
        for out, (argv, sources) in jobs.items():
            if not _stale(out, sources):
                continue
            tmp = "%s.%d.tmp" % (out, os.getpid())
            p = subprocess.Popen(list(argv) + ["-o", tmp],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            procs.append((out, tmp, p))
        errors = []
        for out, tmp, p in procs:
            try:
                text, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                errors.append("%s: timed out after %.0fs" % (out, timeout))
                continue
            if p.returncode != 0:
                errors.append("%s: exit %d\n%s" % (
                    out, p.returncode, text.decode(errors="replace")))
                if os.path.exists(tmp):
                    os.remove(tmp)
                continue
            os.replace(tmp, out)
            built[out] = text.decode(errors="replace")
        if errors:
            raise BuildError("\n".join(errors))
    return built
