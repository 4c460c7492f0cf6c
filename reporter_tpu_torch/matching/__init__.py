from .config import MatcherConfig
from .matcher import LongTraceNotSupported, SegmentMatcher

__all__ = ["LongTraceNotSupported", "MatcherConfig", "SegmentMatcher"]
