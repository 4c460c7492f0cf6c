"""reporter_tpu_torch.obs — the serving process's metrics, tracing and
logging, as the JAX package's ``obs`` has them.

``metrics``   dependency-free Counter/Gauge/Histogram registry with
              Prometheus text exposition, JSON snapshots (incl. per-bucket
              exemplars), and cross-process snapshot merging
              (docs/observability.md lists every family)
``trace``     always-on per-request trace context: trace_id + Span stage
              timings, carried via contextvars end to end
``flight``    bounded in-memory flight recorder with tail sampling
              (GET /debug/traces; dumped by the serve drain)
``log``       structured one-line-JSON/text event logger; one
              ``configure()`` shared by every entrypoint
``profiler``  on-demand torch.profiler captures (GET /debug/profile),
              single-flight across every capture kind
``attrib``    named-stage device-time attribution: the kernels'
              ``rs.<stage>`` profiler ranges parsed out of captures
              (GET /debug/attrib, the reporter_stage_device_seconds
              gauges) and the host-stage split
``quantile``  ONE implementation of histogram-quantile math (Prometheus
              semantics) + the shared SLO_BUCKETS_S log-bucket table
``slo``       server-side SLO engine: declarative objectives over
              sliding windows, error-budget burn rates with multi-window
              AND-gated alerting, fed from every terminal request
              outcome (GET /debug/slo, the /statusz burn line, the
              reporter_slo_* families)
``adaptive``  windowed quantiles and clamped controllers steering the
              batchers' fill window and width (REPORTER_ADAPTIVE=0 off)
``quality``   shadow-oracle sampling against the brute f64 oracle and
              the per-cohort agreement windows
``economics`` chip-second cost ledger, demand history, capacity headroom
              and the memory gauges (GET /debug/cost, /debug/history)
"""

from .metrics import (  # noqa: F401
    BATCH_FILL_BUCKETS,
    LATENCY_BUCKETS_S,
    REGISTRY,
    Registry,
    counter,
    gauge,
    histogram,
    merge,
)
from .trace import Span, bind, current_span, current_trace_id, new_trace_id  # noqa: F401

__all__ = [
    "BATCH_FILL_BUCKETS",
    "LATENCY_BUCKETS_S",
    "REGISTRY",
    "Registry",
    "Span",
    "bind",
    "counter",
    "current_span",
    "current_trace_id",
    "gauge",
    "histogram",
    "merge",
    "new_trace_id",
]
