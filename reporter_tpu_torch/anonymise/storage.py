"""Tile storage backends: local directory, HTTP POST, S3 PUT.

Mirrors the egress options of the reference's anonymiser
(AnonymisingProcessor.java:177-220): a tile flush goes to exactly one of
  - a local directory (tests / batch staging)
  - an HTTP datastore endpoint (POST body = CSV)
  - an S3 bucket, authenticated with AWS signature V2 (HMAC-SHA1 over
    "PUT\n\n{content-type}\n{date}\n/{bucket}/{key}", HttpClient.java:44-58)
    using urllib only -- no boto dependency.

All network backends honour the reference's budget: 10 s total, 3 retries
(HttpClient.java:80-88), with exponential backoff + full jitter and
``Retry-After`` honoured on 429/503 (utils/retry) so a fleet of writers
doesn't hammer a struggling datastore in lock-step.  ``S3Store`` needs no
extra package; the batch pipeline's S3 *archive* needs boto3.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import logging
import os
import urllib.error
import urllib.request
from email.utils import formatdate
from typing import Optional

from .. import faults
from ..utils import retry

log = logging.getLogger(__name__)

RETRIES = retry.RETRIES
TIMEOUT_SEC = retry.BUDGET_S


class DirStore:
    def __init__(self, root: str):
        self.root = root

    def put(self, key: str, body: str) -> None:
        path = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(body)

    def __repr__(self):
        return "DirStore(%r)" % (self.root,)


class HttpStore:
    def __init__(self, url: str):
        self.url = url.rstrip("/")

    def put(self, key: str, body: str) -> None:
        req = urllib.request.Request(
            self.url + "/" + key,
            data=body.encode("utf-8"),
            headers={"Content-Type": "text/csv"},
            method="POST",
        )
        _do_with_retries(req)

    def __repr__(self):
        return "HttpStore(%r)" % (self.url,)


class S3Store:
    def __init__(
        self,
        bucket: str,
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        endpoint: str = "https://{bucket}.s3.amazonaws.com",
        prefix: str = "",
    ):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.endpoint = endpoint.format(bucket=bucket)

    def put(self, key: str, body: str) -> None:
        if self.prefix:
            key = self.prefix + "/" + key
        content_type = "text/csv"
        date = formatdate(usegmt=True)
        to_sign = "PUT\n\n%s\n%s\n/%s/%s" % (content_type, date, self.bucket, key)
        sig = base64.b64encode(
            hmac.new(self.secret_key.encode(), to_sign.encode(), hashlib.sha1).digest()
        ).decode()
        req = urllib.request.Request(
            "%s/%s" % (self.endpoint, key),
            data=body.encode("utf-8"),
            headers={
                "Content-Type": content_type,
                "Date": date,
                "Authorization": "AWS %s:%s" % (self.access_key, sig),
            },
            method="PUT",
        )
        _do_with_retries(req)

    def __repr__(self):
        return "S3Store(%r)" % (self.bucket,)


def _do_with_retries(req: urllib.request.Request) -> None:
    def _do():
        # chaos seams: the datastore answering 5xx or hanging to timeout,
        # armed only by REPORTER_FAULT_STORE_PUT
        tok = faults.fire("store_put")
        if tok == "5xx":
            raise urllib.error.HTTPError(
                req.full_url, 503, "injected store fault", None, None)
        if tok == "timeout":
            raise TimeoutError("injected store timeout")
        with urllib.request.urlopen(req, timeout=TIMEOUT_SEC) as resp:
            resp.read()

    # reference budget (HttpClient.java:80-88) via the shared policy:
    # backoff + jitter, Retry-After on 429/503, 4xx gives up immediately
    try:
        retry.call_with_retries(_do, target="store")
    except urllib.error.HTTPError as e:
        if 400 <= e.code < 500 and e.code != 429:
            raise  # a malformed upload won't improve on retry
        raise RuntimeError(
            "store failed after %d attempts: %s" % (RETRIES, e)) from e
    except Exception as e:  # URLError, socket timeouts
        raise RuntimeError(
            "store failed after %d attempts: %s" % (RETRIES, e)) from e


def make_store(spec: str):
    """'dir:/path', 'http://...', 'https://...', 's3://bucket'."""
    if spec.startswith("dir:"):
        return DirStore(spec[4:])
    if spec.startswith("s3://"):
        rest = spec[5:].strip("/")
        bucket, _, prefix = rest.partition("/")
        return S3Store(bucket, prefix=prefix)
    if spec.startswith("http://") or spec.startswith("https://"):
        return HttpStore(spec)
    # bare path: directory
    return DirStore(spec)
