"""Per-unit done-file journaling for multi-process fan-out phases.

The batch pipeline's phase-1/3 workers (batch/pipeline.py; the port's copy
of the JAX package's module of the same name) share one crash-containment
contract: every worker appends one line per processed
work unit to its own done-file, the parent joins the herd loudly, and a
dead worker's unfinished remainder is requeued ONCE onto the surviving
parent -- at-least-once semantics, never silent loss.  This module is that
contract, factored out so a new fan-out phase cannot re-invent a weaker
one.
"""

from __future__ import annotations

import logging
import math
import os
from typing import List, Optional, Sequence

log = logging.getLogger(__name__)


def mark_done(done_path: Optional[str], unit: str) -> None:
    """Worker-side progress journal: one line per processed work unit, so
    the parent can requeue ONLY what a dead worker left unfinished (a unit
    in flight at the crash replays -- at-least-once, never silent loss)."""
    if not done_path:
        return
    try:
        with open(done_path, "a") as f:
            f.write(unit + "\n")
    except OSError:  # progress journalling must never fail the phase
        log.warning("could not journal progress to %s", done_path)


def unfinished_units(chunks, procs, done_dir: str) -> List[str]:
    """Units assigned to dead workers minus what their done-journals
    record as processed."""
    remaining: List[str] = []
    for i, p in enumerate(procs):
        if p.exitcode == 0:
            continue
        done = set()
        try:
            with open(os.path.join(done_dir, "w%d.done" % i)) as f:
                done = {line.rstrip("\n") for line in f}
        except OSError:
            pass  # worker died before journalling anything
        remaining.extend(k for k in chunks[i] if k not in done)
    return remaining


def split(items: Sequence, n: int) -> List[List]:
    """Balanced n-way split, same contract as simple_reporter.py:70-79."""
    items = list(items)
    size = int(math.ceil(len(items) / float(n)))
    cutoff = len(items) % n
    result = []
    pos = 0
    for i in range(n):
        end = pos + size if cutoff == 0 or i < cutoff else pos + size - 1
        result.append(items[pos:end])
        pos = end
    return result


def join_checked(procs) -> int:
    """Join workers and count the ones that died abnormally -- a crashed
    worker must not read as success."""
    dead = 0
    for p in procs:
        p.join()
        if p.exitcode != 0:
            dead += 1
            log.error("worker %s exited with code %s", p.name, p.exitcode)
    return dead
