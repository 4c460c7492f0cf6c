from .config import MatcherConfig
from .matcher import SegmentMatcher
from .session import SessionEngine, SessionStore

__all__ = ["MatcherConfig", "SegmentMatcher", "SessionEngine", "SessionStore"]
