"""Shared machinery of the object-store model providers (S3 / GCS / Azure
Blob; counterpart of ``tfservingcache_tpu/cache/providers/object_store.py``).

A provider lists every object under ``<base_path>/<model>/<version>/``
(paginated), downloads each into the staging dir of ``atomic_dest`` (up to
``_DOWNLOAD_CONCURRENCY`` at once, metadata first), sizes a model as the sum
of its listed objects and probes health with a 1-key list; a listing that
comes back empty is a missing model. The backends supply one page of
listing and one object download, over the stores' plain HTTP APIs with the
standard library only, so in-process fake servers test them.
"""

from __future__ import annotations

import abc
import logging
import os
import shutil
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Iterator

from tfservingcache_tpu_torch.cache.providers.base import (
    STREAM_META_FILES,
    ModelNotFoundError,
    ModelProvider,
    ProviderError,
    _notify_file,
    atomic_dest,
)
from tfservingcache_tpu_torch.types import Model, ModelId

log = logging.getLogger("tpusc_torch.providers.objectstore")

_RETRIES = 3
_RETRY_BACKOFF_S = 0.25
# concurrent object downloads per artifact fetch (the Go tfservingcache's
# provider is sequential; see load_model)
_DOWNLOAD_CONCURRENCY = 8


@dataclass(frozen=True)
class ObjectInfo:
    key: str
    size: int


def http_call(
    req: urllib.request.Request, timeout: float = 30.0, retries: int = _RETRIES
) -> tuple[int, dict[str, str], bytes]:
    """One HTTP round-trip with bounded retries on 5xx / connection errors.

    The Go tfservingcache leans on SDK-internal retry policy; a small explicit one
    keeps behavior observable.
    """
    last_err: Exception | None = None
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, dict(resp.headers.items()), resp.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            if e.code >= 500 and attempt + 1 < retries:
                last_err = e
            else:
                return e.code, dict(e.headers.items()), body
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as e:
            last_err = e
        if attempt + 1 < retries:  # no pointless backoff after the final attempt
            time.sleep(_RETRY_BACKOFF_S * (2**attempt))
    raise ProviderError(f"object store unreachable after {retries} attempts: {last_err}")


def http_download(
    make_req: Callable[[], urllib.request.Request],
    dest_path: str,
    timeout: float = 120.0,
    retries: int = _RETRIES,
) -> None:
    """Stream a GET response straight to ``dest_path`` (multi-GB artifacts
    must not transit host RAM whole). ``make_req`` builds a fresh request per
    attempt so time-sensitive auth headers (SigV4 x-amz-date, Azure
    x-ms-date) stay valid across retries."""
    last_err: Exception | None = None
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(make_req(), timeout=timeout) as resp:
                with open(dest_path, "wb") as fh:
                    shutil.copyfileobj(resp, fh, length=1 << 20)
                return
        except urllib.error.HTTPError as e:
            body = e.read()[:300]
            if e.code >= 500 and attempt + 1 < retries:
                last_err = e
            else:
                raise ProviderError(f"download failed: HTTP {e.code}: {body!r}") from e
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as e:
            last_err = e
        if attempt + 1 < retries:
            time.sleep(_RETRY_BACKOFF_S * (2**attempt))
    raise ProviderError(f"download failed after {retries} attempts: {last_err}")


class ObjectStoreProvider(ModelProvider):
    """Template for providers over a flat key/value object store.

    Key layout mirrors the Go tfservingcache's (s3modelprovider.go:161-170):
    ``<base_path>/<model>/<version>/<artifact files...>``. Like the disk
    provider (and diskmodelprovider.go:46-69), the version segment matches by
    numeric value, so a store dir ``000000042`` serves version 42.
    """

    def __init__(self, base_path: str) -> None:
        self.base_path = base_path.strip("/")

    # -- backend primitives -------------------------------------------------
    @abc.abstractmethod
    def _list_page(
        self,
        prefix: str,
        delimiter: str,
        marker: str,
        max_keys: int = 0,
        timeout: float = 30.0,
        retries: int = _RETRIES,
    ) -> tuple[list[ObjectInfo], list[str], str]:
        """One page of listing -> (objects, common-prefixes, next-marker).
        Empty next-marker = last page; ``max_keys`` 0 = backend default."""

    @abc.abstractmethod
    def _download(self, key: str, dest_path: str) -> None:
        """Fetch one object to a local file."""

    # -- shared listing helpers ---------------------------------------------
    def _list_all(self, prefix: str, delimiter: str = "") -> Iterator[tuple[ObjectInfo | None, str | None]]:
        """Iterate every (object, None) and (None, common_prefix) under
        ``prefix`` across pages (the Go tfservingcache's pagination loops
        s3modelprovider.go:130-158 / azblobmodelprovider.go:125-162)."""
        marker = ""
        while True:
            objects, prefixes, marker = self._list_page(prefix, delimiter, marker)
            for o in objects:
                yield o, None
            for p in prefixes:
                yield None, p
            if not marker:
                return

    def _prefix_for(self, name: str, version: int) -> str:
        parts = [p for p in (self.base_path, name) if p]
        return "/".join(parts) + f"/{self._resolve_version_dir(name, version)}/"

    def _resolve_version_dir(self, name: str, version: int) -> str:
        """Find the stored version-directory segment whose numeric value equals
        ``version`` (zero-padded dirs serve their numeric version, like the
        disk provider). Exact match short-circuits without a list call."""
        base = "/".join(p for p in (self.base_path, name) if p) + "/"
        exact_probe, _, _ = self._list_page(f"{base}{version}/", "", "", max_keys=1)
        if exact_probe:
            return str(version)
        for _, common in self._list_all(base, delimiter="/"):
            if common is None:
                continue
            seg = common[len(base):].strip("/")
            try:
                if int(seg) == version:
                    return seg
            except ValueError:
                continue
        raise ModelNotFoundError(f"version {version} of model {name!r} not found under {base!r}")

    def _list_model_objects(self, name: str, version: int) -> tuple[list[ObjectInfo], str]:
        """-> (objects, resolved prefix). The prefix is resolved exactly once —
        resolution may itself cost a paginated listing for zero-padded version
        dirs, so callers must not re-derive it."""
        prefix = self._prefix_for(name, version)
        objects = [o for o, _ in self._list_all(prefix) if o is not None]
        if not objects:
            # the Go tfservingcache's azblobmodelprovider.go:157-159: zero blobs is an error
            raise ModelNotFoundError(f"no objects under {prefix!r}")
        return objects, prefix

    # -- ModelProvider interface --------------------------------------------
    def load_model(self, name: str, version: int, dest_dir: str) -> Model:
        return self._load(name, version, dest_dir, None)

    def load_model_streaming(
        self, name: str, version: int, dest_dir: str, on_file=None
    ) -> Model:
        """Concurrent fetch with metadata objects submitted first and
        ``on_file`` fired per landed object (from this calling thread, in
        completion order) — model.json typically completes while params.bin
        is still streaming, which is the fetch/compile overlap the
        pipelined cold load feeds on."""
        return self._load(name, version, dest_dir, on_file)

    def _load(self, name: str, version: int, dest_dir: str, on_file) -> Model:
        """Fetch every object of the artifact, CONCURRENTLY (the Go
        tfservingcache downloads sequentially, s3modelprovider.go:124-159 — per-object
        round-trip latency then dominates a many-file artifact; a bounded
        pool overlaps them, which is where the cold-miss seconds live for
        object-store deployments). ``_download`` impls are stateless
        (urllib + per-request auth), so calls are thread-safe."""
        objects, prefix = self._list_model_objects(name, version)
        total = 0
        with atomic_dest(dest_dir) as tmp:
            work: list[tuple[ObjectInfo, str, str]] = []
            for obj in objects:
                rel = obj.key[len(prefix):]
                if not rel or rel.endswith("/"):
                    continue  # zero-byte "directory" placeholder objects
                local = os.path.join(tmp, *rel.split("/"))
                os.makedirs(os.path.dirname(local), exist_ok=True)
                work.append((obj, local, rel))
            # metadata first: with a streaming consumer the precompile hint
            # should leave as early as the store allows (harmless otherwise)
            work.sort(key=lambda w: w[2].rsplit("/", 1)[-1] not in STREAM_META_FILES)
            if len(work) <= 1:
                for obj, local, rel in work:
                    self._download(obj.key, local)
                    total += obj.size
                    _notify_file(on_file, rel, local)
            else:
                from concurrent.futures import ThreadPoolExecutor, as_completed

                # NOT a with-block: the context manager's __exit__ joins all
                # in-flight downloads, which would hold the fail-fast raise
                # (and the cold-load deadline) hostage to the slowest
                # transfer's retries. On error the queued futures are
                # cancelled and the raise propagates immediately; abandoned
                # in-flight workers hit ENOENT once atomic_dest removes the
                # staging dir and die into their unread futures (a residual
                # .tmp-* dir from that race is reaped by the disk cache's
                # restart recovery).
                pool = ThreadPoolExecutor(
                    max_workers=min(_DOWNLOAD_CONCURRENCY, len(work)),
                    thread_name_prefix="tpusc-fetch",
                )
                try:
                    futures = {
                        pool.submit(self._download, obj.key, local): (obj, local, rel)
                        for obj, local, rel in work
                    }
                    for f in as_completed(futures):
                        try:
                            f.result()
                            obj, local, rel = futures[f]
                            total += obj.size
                            _notify_file(on_file, rel, local)
                        except Exception as e:  # noqa: BLE001
                            # fail fast: a multi-GB artifact must not keep
                            # streaming its other objects (egress + the cold
                            # deadline) after one of them already failed.
                            # atomic_dest discards the staging dir on raise.
                            raise ProviderError(
                                f"object download failed (remaining "
                                f"downloads cancelled): {e}"
                            ) from e
                finally:
                    pool.shutdown(wait=False, cancel_futures=True)
        log.info("downloaded %s/%d: %d objects, %d bytes", name, version, len(objects), total)
        return Model(
            identifier=ModelId(name, version), path=dest_dir, size_on_disk=total
        )

    def model_size(self, name: str, version: int) -> int:
        """Sum of listed object sizes (the Go tfservingcache's s3modelprovider.go:108-122)."""
        objects, _ = self._list_model_objects(name, version)
        return sum(o.size for o in objects)

    def list_versions(self, name: str) -> list[int]:
        base = "/".join(p for p in (self.base_path, name) if p) + "/"
        versions = set()
        for _, common in self._list_all(base, delimiter="/"):
            if common is None:
                continue
            seg = common[len(base):].strip("/")
            try:
                versions.add(int(seg))
            except ValueError:
                continue
        if not versions:
            raise ModelNotFoundError(f"no versions of model {name!r} under {base!r}")
        return sorted(versions)

    def check(self) -> None:
        """Health probe = 1-key list, bounded like the Go tfservingcache's
        10s-timeout health list (s3modelprovider.go:172-181 /
        azblobmodelprovider.go:174-186) — a black-holed endpoint must fail
        the probe in ~10s, not stall a liveness loop for minutes of retries."""
        self._list_page(
            self.base_path + "/" if self.base_path else "", "", "",
            max_keys=1, timeout=10.0, retries=1,
        )
