"""Host matchers beside the device program: the CPU baseline
(``CPUViterbiMatcher``, ``SegmentMatcher(backend="cpu")``) and the brute
f64 oracle (``BruteForceMatcher``)."""

from .brute_matcher import BruteForceMatcher
from .cpu_matcher import CPUViterbiMatcher

__all__ = ["BruteForceMatcher", "CPUViterbiMatcher"]
