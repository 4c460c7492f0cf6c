"""Bounded egress retries: exponential backoff + full jitter under one
total budget (the port's copy of the JAX package's module of the same
name: same policy, same metric families).

Both network egress paths (the stream client POSTing to the matcher, the
anonymiser's stores shipping tiles) use it.  The policy is the one the
reference's HttpClient contract implies (HttpClient.java:80-88: 3 tries
on a ~10 s budget, 5xx/connection failures retryable, 4xx not):

  - full-jitter exponential backoff: sleep ~ U(0, min(cap, base * 2^n))
  - a TOTAL wall-clock budget (default 10 s): no attempt is started, and
    no sleep taken, past it
  - ``Retry-After`` honoured on 429/503 responses (the serve tier's load
    shedding and its drain speak it), still capped by the budget
  - 4xx other than 429 give up immediately (a malformed request never
    improves on retry)
  - retries and give-ups counted per target and cause (network / 5xx /
    429 / 4xx) so a dashboard can tell a flaky datastore from a client
    bug

``REPORTER_RETRY_BASE_S`` scales the backoff base (tests set it small so
injected transients don't stretch wall time).
"""

from __future__ import annotations

import os
import random
import time
import urllib.error
from typing import Callable, Optional

from ..obs import metrics as obs

C_RETRIES = obs.counter(
    "reporter_egress_retries_total",
    "Egress request retries by target (matcher / store) and cause "
    "(network / 5xx / 429)",
    ("target", "cause"))
C_GIVEUPS = obs.counter(
    "reporter_egress_giveups_total",
    "Egress requests abandoned by target and cause (4xx = immediate, "
    "non-retryable)",
    ("target", "cause"))

RETRIES = 3          # attempts, matching the reference's HttpClient
BUDGET_S = 10.0      # total wall budget across attempts + sleeps
BASE_S = 0.2         # backoff base (attempt n sleeps ~ U(0, base * 2^n))
MAX_SLEEP_S = 2.0    # per-sleep cap


def _retry_after_s(e: urllib.error.HTTPError) -> Optional[float]:
    """Parsed Retry-After seconds from a 429/503, when present/parseable."""
    headers = getattr(e, "headers", None)
    raw = headers.get("Retry-After") if headers is not None else None
    if raw is None:
        return None
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return None


def call_with_failover(do: Callable[[int], object], target: str,
                       retries: int = RETRIES, budget_s: float = BUDGET_S,
                       base_s: Optional[float] = None,
                       hold_429: bool = True):
    """The retry contract above, with the attempt NUMBER passed to ``do``
    so the caller can rotate endpoints between attempts under the same
    total budget/backoff/Retry-After policy as a single-endpoint retry.

    ``hold_429=False`` skips the backoff sleep on a 429/503 with a
    Retry-After hint: the next attempt lands on a DIFFERENT endpoint, so
    one endpoint's load hint must not stall the failover (the hint is
    still surfaced to the caller via the final raised error when every
    endpoint sheds)."""
    if base_s is None:
        try:
            base_s = float(os.environ.get("REPORTER_RETRY_BASE_S", BASE_S))
        except ValueError:
            base_s = BASE_S
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    cause = "network"
    for attempt in range(max(1, retries)):
        try:
            return do(attempt)
        except urllib.error.HTTPError as e:
            if 400 <= e.code < 500 and e.code != 429:
                C_GIVEUPS.labels(target, "4xx").inc()
                raise
            last = e
            cause = "429" if e.code == 429 else "5xx"
            hinted = _retry_after_s(e)
            if not hold_429:
                hinted = None
        except Exception as e:  # URLError, timeouts, resets
            last = e
            cause = "network"
            hinted = None
        remaining = budget_s - (time.monotonic() - t0)
        if attempt + 1 >= max(1, retries) or remaining <= 0:
            break
        sleep = random.uniform(0.0, min(MAX_SLEEP_S, base_s * (2 ** attempt)))
        if hinted is not None:
            sleep = max(sleep, hinted)
        sleep = min(sleep, remaining)
        if sleep > 0:
            time.sleep(sleep)
        C_RETRIES.labels(target, cause).inc()
    C_GIVEUPS.labels(target, cause).inc()
    assert last is not None
    raise last


def call_with_retries(do: Callable, target: str, retries: int = RETRIES,
                      budget_s: float = BUDGET_S,
                      base_s: Optional[float] = None):
    """Run ``do()`` under the retry contract above; returns its value or
    re-raises the last failure once attempts or the budget are exhausted
    (callers keep their own error semantics -- log-and-None for the matcher
    client, raise-RuntimeError for the tile store)."""
    return call_with_failover(lambda _attempt: do(), target,
                              retries=retries, budget_s=budget_s,
                              base_s=base_s)
