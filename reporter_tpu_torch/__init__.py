"""PyTorch/CUDA port of the reporter's serving path.

A `/report` request flows through ``serve.service`` (MicroBatcher), the
bucketed ``matching.matcher.SegmentMatcher``, the dense match program in
``ops/`` (hand-written CUDA kernels for sm_90a, each beside its plain
PyTorch version) and host association, into ``report.report()``.  Traces
longer than the largest bucket run in windows with carried Viterbi state;
streaming submits run as per-vehicle session steps
(``matching.session``), their beams optionally in a device slab
(``matching.arena``).

The package imports ``torch`` and nothing of JAX or of ``reporter_tpu``;
host structures it shares with the JAX package are its own copies.  Entry
points take ``device=`` (default ``"cuda"``) and raise when CUDA is absent
unless the caller asked for ``"cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
