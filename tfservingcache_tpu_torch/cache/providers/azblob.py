"""Azure Blob model provider over the Blob service REST API with Shared Key
authentication (counterpart of ``tfservingcache_tpu/cache/providers/azblob.py``;
stdlib only): marker-paginated List Blobs under the prefix, the Shared Key
signature (HMAC-SHA256 over the canonicalized headers and resource with the
base64-decoded account key), an error on zero blobs, a 10 s health list.
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
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

_API_VERSION = "2020-10-02"


def shared_key_auth(
    method: str,
    url: str,
    account_name: str,
    account_key_b64: str,
    headers: dict[str, str],
) -> str:
    """Azure Storage Shared Key signature for a bodyless request."""
    parsed = urllib.parse.urlsplit(url)
    canon_headers = "".join(
        f"{k}:{v}\n"
        for k, v in sorted(headers.items())
        if k.startswith("x-ms-")
    )
    canon_resource = f"/{account_name}{parsed.path or '/'}"
    for k, v in sorted(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)):
        canon_resource += f"\n{k.lower()}:{v}"
    string_to_sign = "\n".join(
        [
            method,
            "",  # Content-Encoding
            "",  # Content-Language
            "",  # Content-Length (empty for 0)
            "",  # Content-MD5
            "",  # Content-Type
            "",  # Date (x-ms-date used instead)
            "",  # If-Modified-Since
            "",  # If-Match
            "",  # If-None-Match
            "",  # If-Unmodified-Since
            "",  # Range
        ]
    ) + "\n" + canon_headers + canon_resource
    key = base64.b64decode(account_key_b64)
    sig = base64.b64encode(
        hmac.new(key, string_to_sign.encode(), hashlib.sha256).digest()
    ).decode()
    return f"SharedKey {account_name}:{sig}"


class AZBlobModelProvider(ObjectStoreProvider):
    def __init__(
        self,
        account_name: str,
        account_key: str,
        container: str,
        base_path: str = "",
        endpoint: str = "",
    ) -> None:
        super().__init__(base_path)
        if not container:
            raise ProviderError("azblob provider requires a container")
        self.account_name = account_name
        self.account_key = account_key
        self.container = container
        host = (endpoint or f"https://{account_name}.blob.core.windows.net").rstrip("/")
        self._base_url = f"{host}/{container}"

    def _request(self, url: str) -> urllib.request.Request:
        headers = {
            "x-ms-date": email.utils.formatdate(usegmt=True),
            "x-ms-version": _API_VERSION,
        }
        if self.account_name and self.account_key:
            headers["Authorization"] = shared_key_auth(
                "GET", url, self.account_name, self.account_key, headers
            )
        return urllib.request.Request(url, headers=headers)

    # -- ObjectStoreProvider primitives -------------------------------------
    def _list_page(
        self, prefix: str, delimiter: str, marker: str, max_keys: int = 0,
        timeout: float = 10.0, retries: int = 3,
    ) -> tuple[list[ObjectInfo], list[str], str]:
        params = {"restype": "container", "comp": "list", "prefix": prefix}
        if delimiter:
            params["delimiter"] = delimiter
        if marker:
            params["marker"] = marker
        if max_keys:
            params["maxresults"] = str(max_keys)
        url = f"{self._base_url}?{urllib.parse.urlencode(sorted(params.items()))}"
        status, _, body = http_call(self._request(url), timeout=timeout, retries=retries)
        if status != 200:
            raise ProviderError(f"azblob list failed: HTTP {status}: {body[:300]!r}")
        root = ET.fromstring(body)
        objects = []
        prefixes = []
        blobs = root.find("Blobs")
        if blobs is not None:
            for blob in blobs.findall("Blob"):
                name = blob.findtext("Name", "")
                size = int(blob.findtext("Properties/Content-Length", "0"))
                objects.append(ObjectInfo(key=name, size=size))
            for bp in blobs.findall("BlobPrefix"):
                prefixes.append(bp.findtext("Name", ""))
        next_marker = root.findtext("NextMarker", "") or ""
        return objects, prefixes, next_marker

    def _download(self, key: str, dest_path: str) -> None:
        url = f"{self._base_url}/{urllib.parse.quote(key)}"
        http_download(lambda: self._request(url), dest_path)
