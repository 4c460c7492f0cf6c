"""Matcher clients: how the streaming tier reaches the matching service.

The reference POSTs each ready batch to the Python service one trace at a
time (Batch.java:68, HttpClient.java:65-103, budget: 1 s connect / 10 s
socket, 3 retries).  Here the client interface is batched -- ``report_many``
takes all currently-ready batches and returns one response per request -- so
the device sees [B, T] micro-batches.  Two implementations:

  HttpMatcherClient  -- wire-parity: POST /report per trace, or one
                        POST /trace_attributes_batch for a micro-batch; a
                        429 shed and a 503 "draining" answer are retried
                        under the shared budget (utils/retry)
  LocalMatcherClient -- in-process SegmentMatcher + report(), no HTTP;
                        the embedding used by tests and single-box deploys
"""

from __future__ import annotations

import json
import logging
import time as _time
import urllib.error
from typing import List, Optional, Sequence

from .. import faults
from ..obs import metrics as obs
from ..obs import trace as obs_trace
from ..obs.quantile import SLO_BUCKETS_S
from ..utils import retry
from ..utils.httppool import POOL, raise_for_status

log = logging.getLogger(__name__)

RETRIES = retry.RETRIES
TIMEOUT_SEC = retry.BUDGET_S

# the CLIENT side of the serving SLO (the service's SLO engine): what the streaming tier actually experienced per matcher
# call -- whole retry cycle included -- on the same shared bucket axis as
# reporter_slo_latency_seconds, so a server-side p99 that looks healthy
# while clients burn their retry budgets is visible as the gap between
# the two families
H_CLIENT = obs.histogram(
    "reporter_client_request_seconds",
    "Stream-client matcher call latency (full retry cycle) per target",
    ("target",), buckets=SLO_BUCKETS_S)
C_CLIENT_RESP = obs.counter(
    "reporter_client_responses_total",
    "Stream-client matcher call outcomes by target and final status "
    "(HTTP code, or 'error' for transport failure after retries)",
    ("target", "status"))


def _post_json(url: str, payload: dict, timeout: float = TIMEOUT_SEC) -> Optional[dict]:
    body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    # end-to-end trace propagation: reuse the caller's bound trace id (the
    # stream runtime binds one per flush) or mint one per call; the service
    # echoes it, so a failed or slow request is findable in the server's
    # flight recorder (GET /debug/traces) from the client log alone
    trace_id = obs_trace.current_trace_id() or obs_trace.new_trace_id()
    headers = {"Content-Type": "application/json",
               "X-Reporter-Trace": trace_id}

    def _do():
        # chaos seam: a connection reset mid-flight, the failure mode a
        # flaky LB/sidecar hands this client
        if faults.fire("client_post") is not None:
            raise ConnectionResetError("injected connection reset")
        # keep-alive pool (utils/httppool.py): the stream tier POSTs every
        # flush window to the same matcher -- a fresh TCP connect per
        # request was pure overhead; reuse is counted per target
        status, rhdrs, rbody = POOL.request(
            "POST", url, body=body, headers=headers, timeout=timeout,
            target="matcher")
        raise_for_status(url, status, rhdrs, rbody)
        echoed = rhdrs.get("X-Reporter-Trace")
        if echoed and echoed != trace_id:
            log.debug("matcher echoed foreign trace id %s (sent %s)",
                      echoed, trace_id)
        return json.loads(rbody.decode("utf-8"))

    # the reference contract (HttpClient.java:80-88): 3 tries on a ~10 s
    # total budget, exponential backoff + full jitter, Retry-After honoured
    # on the serve tier's 429/503 shed responses, 4xx never retried
    t0 = _time.monotonic()
    status = "error"
    try:
        out = retry.call_with_retries(_do, target="matcher",
                                      budget_s=timeout)
        status = "200"
        return out
    except urllib.error.HTTPError as e:
        status = str(e.code)
        if 400 <= e.code < 500 and e.code != 429:
            log.error("matcher rejected request (trace %s): %s", trace_id, e)
        else:
            log.error("matcher unreachable after %d attempts (trace %s): %s",
                      RETRIES, trace_id, e)
        return None
    except Exception as e:  # noqa: BLE001 - degraded to a dropped response
        log.error("matcher unreachable after %d attempts (trace %s): %s",
                  RETRIES, trace_id, e)
        return None
    finally:
        H_CLIENT.labels("matcher").observe(
            _time.monotonic() - t0, exemplar=trace_id)
        C_CLIENT_RESP.labels("matcher", status).inc()


class HttpMatcherClient:
    def __init__(self, url: str, batch_url: Optional[str] = None):
        """url: the /report endpoint.  batch_url: /trace_attributes_batch;
        derived from url when not given."""
        self.url = url
        if batch_url is None and url.endswith("/report"):
            batch_url = url[: -len("/report")] + "/trace_attributes_batch"
        self.batch_url = batch_url

    def report_one(self, request: dict) -> Optional[dict]:
        return _post_json(self.url, request)

    def report_many(self, requests: Sequence[dict]) -> List[Optional[dict]]:
        if not requests:
            return []
        if self.batch_url is None or len(requests) == 1:
            return [self.report_one(r) for r in requests]
        resp = _post_json(self.batch_url, {"traces": list(requests)})
        if resp is None or "results" not in resp:
            return [None] * len(requests)
        results = resp["results"]
        if len(results) != len(requests):
            log.error(
                "batch response has %d results for %d requests", len(results), len(requests)
            )
            return [None] * len(requests)
        return results


class LocalMatcherClient:
    """Calls the matcher + report() in-process (no HTTP hop)."""

    def __init__(self, matcher, threshold_sec: int = 15, mode: str = "auto"):
        from ..report.reporter import report as _report

        self.matcher = matcher
        self.threshold_sec = threshold_sec
        self.mode = mode
        self._report = _report

    def _levels(self, request: dict):
        opts = request.get("match_options", {})
        return (
            set(opts.get("report_levels", [0, 1])),
            set(opts.get("transition_levels", [0, 1])),
        )

    def warmup(self, **kw) -> float:
        """Pre-dispatch the matcher's configured (B, T, kernel) shapes
        (``SegmentMatcher.warmup``): an embedder running the in-process
        client otherwise pays the kernels' build and the first launch of
        every shape inside its first flush window, which is exactly the
        streaming path's latency budget."""
        fn = getattr(self.matcher, "warmup", None)
        return float(fn(**kw)) if callable(fn) else 0.0

    def report_one(self, request: dict) -> Optional[dict]:
        return self.report_many([request])[0]

    def report_many(self, requests: Sequence[dict]) -> List[Optional[dict]]:
        if not requests:
            return []
        matches = self.matcher.match_many(list(requests))
        out: List[Optional[dict]] = []
        for request, match in zip(requests, matches):
            rl, tl = self._levels(request)
            try:
                out.append(
                    self._report(match, request, self.threshold_sec, rl, tl, self.mode)
                )
            except Exception as e:  # a bad trace must not poison the pool
                log.error("report() failed for %s: %s", request.get("uuid"), e)
                out.append(None)
        return out
