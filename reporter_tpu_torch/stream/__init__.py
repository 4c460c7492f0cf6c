"""Streaming stack: the keyed/windowed probe pipeline.

The reference implements this tier as a Java Kafka Streams app
(src/main/java/io/opentraffic/reporter/, topology Reporter.java:156-181):
raw probe records are formatted and keyed by vehicle uuid, windowed into
per-vehicle batches, matched via the HTTP service, and the resulting segment
observations anonymised into time-quantised tiles.

This package is the port's equivalent (a copy of the JAX package's package
of the same name): the same keying / windowing / anonymisation semantics as
an embeddable Python runtime (with optional Kafka transport when
kafka-python is importable), but the matcher boundary is *micro-batched* --
many ready batches are flushed to the device in one
``/trace_attributes_batch`` call (or one in-process ``match_many``) so the
card's kernels see [B, T] tensors instead of one trace at a time.
"""

from .point import Point
from .formatter import Formatter
from .segment import Segment, INVALID_SEGMENT_ID
from .batch import Batch
from .batcher import BatchingProcessor
from .anonymiser import AnonymisingProcessor
from .client import LocalMatcherClient, HttpMatcherClient

__all__ = [
    "Point",
    "Formatter",
    "Segment",
    "INVALID_SEGMENT_ID",
    "Batch",
    "BatchingProcessor",
    "AnonymisingProcessor",
    "LocalMatcherClient",
    "HttpMatcherClient",
]
