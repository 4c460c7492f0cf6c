from .generator import SyntheticTrace, TraceSynthesizer

__all__ = ["SyntheticTrace", "TraceSynthesizer"]
