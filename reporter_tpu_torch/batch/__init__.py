"""Batch (historical backfill) pipeline.

The reference's simple_reporter.py: three resumable phases over archived
probe data -- gather traces, match them to OSMLR segments, anonymise and
upload time tiles.  Same phases and on-disk formats here (the port's copy of
the JAX package's package of the same name), but phase 2 feeds the card
length-bucketed [B, T] micro-batches through ``SegmentMatcher.match_many``
instead of one serial C++ Match() per trace -- the card's kernels replace
the reference's per-process matcher fan-out.
"""

from .pipeline import (
    get_traces,
    make_matches,
    report_tiles,
    run_pipeline,
    split,
)

__all__ = ["get_traces", "make_matches", "report_tiles", "run_pipeline", "split"]
