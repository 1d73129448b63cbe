"""S3 model provider over the plain S3 REST API with hand-rolled AWS
Signature Version 4 (counterpart of ``tfservingcache_tpu/cache/providers/s3.py``;
stdlib only: hmac, hashlib, urllib). Paginated ListObjectsV2 under
``<base_path>/<model>/<version>/`` and a GET an object; works against AWS,
MinIO and the in-process fakes of the tests. A custom ``endpoint`` is
addressed path-style, bare AWS virtual-hosted style.

Credentials: ``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY``
[/ ``AWS_SESSION_TOKEN``] env vars; unsigned anonymous requests when unset
(public buckets, test fakes).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET

from tfservingcache_tpu_torch.cache.providers.base import ProviderError
from tfservingcache_tpu_torch.cache.providers.object_store import (
    ObjectInfo,
    ObjectStoreProvider,
    http_call,
    http_download,
)

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    url: str,
    region: str,
    access_key: str,
    secret_key: str,
    session_token: str = "",
    service: str = "s3",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """AWS Signature Version 4 for a bodyless request.

    Canonical request -> string-to-sign -> derived signing key, per the S3
    REST authentication spec. Query params are signed in sorted order;
    payload hash is the empty-body constant (all our calls are GETs).
    """
    parsed = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    # callers pass an already-percent-encoded URL; re-quoting here would
    # double-encode ('%20' -> '%2520') and sign a different path than S3
    # canonicalizes, failing every key that needs escaping
    canonical_uri = parsed.path or "/"
    query_pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(query_pairs)
    )
    headers = {"host": parsed.netloc, "x-amz-content-sha256": _EMPTY_SHA256, "x-amz-date": amz_date}
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed_names = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join(
        [method, canonical_uri, canonical_query, canonical_headers, signed_names, _EMPTY_SHA256]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )
    k_date = _hmac(f"AWS4{secret_key}".encode(), datestamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}"
    )
    del headers["host"]  # urllib sets Host itself; signing included it already
    return headers


class S3ModelProvider(ObjectStoreProvider):
    def __init__(
        self,
        bucket: str,
        base_path: str = "",
        region: str = "",
        endpoint: str = "",
    ) -> None:
        super().__init__(base_path)
        if not bucket:
            raise ProviderError("s3 provider requires a bucket")
        self.bucket = bucket
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        # Custom endpoint (MinIO / test fake) uses path-style addressing;
        # bare AWS uses virtual-hosted style.
        if endpoint:
            self._base_url = f"{endpoint.rstrip('/')}/{bucket}"
        else:
            self._base_url = f"https://{bucket}.s3.{self.region}.amazonaws.com"
        self.access_key = os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.session_token = os.environ.get("AWS_SESSION_TOKEN", "")

    def _request(self, url: str) -> urllib.request.Request:
        req = urllib.request.Request(url)
        if self.access_key and self.secret_key:
            for k, v in sigv4_headers(
                "GET", url, self.region, self.access_key, self.secret_key, self.session_token
            ).items():
                req.add_header(k, v)
        return req

    # -- ObjectStoreProvider primitives -------------------------------------
    def _list_page(
        self, prefix: str, delimiter: str, marker: str, max_keys: int = 0,
        timeout: float = 30.0, retries: int = 3,
    ) -> tuple[list[ObjectInfo], list[str], str]:
        params = {"list-type": "2", "prefix": prefix}
        if delimiter:
            params["delimiter"] = delimiter
        if marker:
            params["continuation-token"] = marker
        if max_keys:
            params["max-keys"] = str(max_keys)
        url = f"{self._base_url}?{urllib.parse.urlencode(sorted(params.items()))}"
        status, _, body = http_call(self._request(url), timeout=timeout, retries=retries)
        if status != 200:
            raise ProviderError(f"s3 list failed: HTTP {status}: {body[:300]!r}")
        ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
        root = ET.fromstring(body)
        # tolerate fakes that omit the namespace
        def findall(tag: str):
            return root.findall(f"s3:{tag}", ns) or root.findall(tag)

        def text(el, tag: str, default: str = "") -> str:
            child = el.find(f"s3:{tag}", ns)
            if child is None:
                child = el.find(tag)
            return child.text if child is not None and child.text else default

        objects = [
            ObjectInfo(key=text(c, "Key"), size=int(text(c, "Size", "0")))
            for c in findall("Contents")
        ]
        prefixes = [text(c, "Prefix") for c in findall("CommonPrefixes")]
        truncated = (text(root, "IsTruncated", "false")).lower() == "true"
        next_marker = text(root, "NextContinuationToken") if truncated else ""
        return objects, prefixes, next_marker

    def _download(self, key: str, dest_path: str) -> None:
        url = f"{self._base_url}/{urllib.parse.quote(key)}"
        http_download(lambda: self._request(url), dest_path)
