from .service import MicroBatcher, ReporterService

__all__ = ["MicroBatcher", "ReporterService"]
