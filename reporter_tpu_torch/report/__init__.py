from .reporter import report

__all__ = ["report"]
