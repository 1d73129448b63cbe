"""GCS model provider over the JSON API (storage/v1) (counterpart of
``tfservingcache_tpu/cache/providers/gcs.py``; stdlib only). The provider
pattern of ``object_store``: paginated list under
``<base_path>/<model>/<version>/``, a download an object, size = the sum of
the listed sizes, health = a 1-key list.

Auth: a bearer token from (in order) the ``GCS_ACCESS_TOKEN`` env var, or
the GCE metadata server's default service account. Anonymous when neither
is available (public buckets, test fakes; tests set ``GCS_ACCESS_TOKEN`` so
that nothing probes the metadata server).
"""

from __future__ import annotations

import json
import os
import time
import threading
import urllib.parse
import urllib.request

from tfservingcache_tpu_torch.cache.providers.base import ProviderError
from tfservingcache_tpu_torch.cache.providers.object_store import (
    ObjectInfo,
    ObjectStoreProvider,
    http_call,
    http_download,
)
from tfservingcache_tpu_torch.utils.lockcheck import lockchecked

_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "service-accounts/default/token"
)
_METADATA_RETRY_S = 60.0


@lockchecked
class GCSModelProvider(ObjectStoreProvider):
    # Guarded-field registry (tools/tpusc_check TPUSC001 + TPUSC_LOCKCHECK=1).
    _tpusc_guarded = {"_token": "_token_lock", "_token_expiry": "_token_lock"}

    def __init__(self, bucket: str, base_path: str = "", endpoint: str = "") -> None:
        super().__init__(base_path)
        if not bucket:
            raise ProviderError("gcs provider requires a bucket")
        self.bucket = bucket
        self._base_url = (endpoint or "https://storage.googleapis.com").rstrip("/")
        self._token = ""
        self._token_expiry = 0.0
        # negative-cache with TTL: off-GCP hosts stay anonymous without
        # paying a metadata probe per request, but one transient failure on a
        # real TPU-VM must not downgrade the provider to anonymous forever
        self._no_metadata_until = 0.0
        # load_model's download pool calls _bearer_token from several
        # threads: exactly ONE refreshes an expired token (the rest wait for
        # its result) — unsynchronized, all 8 would race the metadata server
        # and one transient failure could downgrade its siblings' downloads
        # of the same artifact to anonymous mid-flight
        self._token_lock = threading.Lock()

    # -- auth ----------------------------------------------------------------
    def _bearer_token(self) -> str:
        env = os.environ.get("GCS_ACCESS_TOKEN", "")
        if env:
            return env
        with self._token_lock:
            if self._token and time.monotonic() < self._token_expiry - 60:
                return self._token
            if time.monotonic() < self._no_metadata_until:
                return ""
            req = urllib.request.Request(
                _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"}
            )
            try:
                status, _, body = http_call(req, timeout=2.0, retries=1)
            except ProviderError:
                self._no_metadata_until = time.monotonic() + _METADATA_RETRY_S
                return ""  # not on GCP (or transient blip): anonymous for a while
            if status != 200:
                # negative-cache non-200 too (e.g. 404 when the instance has
                # no default service account): without it every list page and
                # object download would serially repeat the metadata
                # round-trip
                self._no_metadata_until = time.monotonic() + _METADATA_RETRY_S
                return ""
            tok = json.loads(body)
            self._token = tok.get("access_token", "")
            self._token_expiry = time.monotonic() + float(tok.get("expires_in", 0))
            return self._token

    def _request(self, url: str) -> urllib.request.Request:
        req = urllib.request.Request(url)
        token = self._bearer_token()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        return req

    # -- ObjectStoreProvider primitives -------------------------------------
    def _list_page(
        self, prefix: str, delimiter: str, marker: str, max_keys: int = 0,
        timeout: float = 30.0, retries: int = 3,
    ) -> tuple[list[ObjectInfo], list[str], str]:
        params = {
            "prefix": prefix,
            "fields": "items(name,size),prefixes,nextPageToken",
        }
        if delimiter:
            params["delimiter"] = delimiter
        if marker:
            params["pageToken"] = marker
        if max_keys:
            params["maxResults"] = str(max_keys)
        url = (
            f"{self._base_url}/storage/v1/b/{urllib.parse.quote(self.bucket)}/o"
            f"?{urllib.parse.urlencode(sorted(params.items()))}"
        )
        status, _, body = http_call(self._request(url), timeout=timeout, retries=retries)
        if status != 200:
            raise ProviderError(f"gcs list failed: HTTP {status}: {body[:300]!r}")
        data = json.loads(body)
        objects = [
            ObjectInfo(key=item["name"], size=int(item.get("size", 0)))
            for item in data.get("items", [])
        ]
        prefixes = list(data.get("prefixes", []))
        return objects, prefixes, data.get("nextPageToken", "")

    def _download(self, key: str, dest_path: str) -> None:
        url = (
            f"{self._base_url}/storage/v1/b/{urllib.parse.quote(self.bucket)}/o/"
            f"{urllib.parse.quote(key, safe='')}?alt=media"
        )
        http_download(lambda: self._request(url), dest_path)
