"""CacheManager — per-node JIT load orchestration (counterpart of
``tfservingcache_tpu/cache/manager.py``; ledger, fault-injection, peer and
streaming fetch and metrics are not ported in this slice).

  - HIT: artifact on disk and model resident in the runtime;
  - STALE: artifact on disk, model not resident -> reload without re-fetch;
  - MISS: evict-to-fit on disk, fetch from the provider, then load.

Per-model singleflight: concurrent misses on different models proceed in
parallel, concurrent requests for one model share one fetch and load. A
cold-load deadline (``serving.load_timeout_s``) bounds fetch + load.
"""

from __future__ import annotations

import contextvars
import logging
import threading
import time

from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.providers.base import ModelNotFoundError, ModelProvider
from tfservingcache_tpu_torch.runtime.base import BaseRuntime, LoadTimeoutError
from tfservingcache_tpu_torch.types import Model, ModelId, ModelState

log = logging.getLogger("tpusc_torch.cachemanager")


class CacheManager:
    def __init__(
        self,
        provider: ModelProvider,
        disk_cache: ModelDiskCache,
        runtime: BaseRuntime,
        load_timeout_s: float | None = None,
    ) -> None:
        self.provider = provider
        self.disk_cache = disk_cache
        self.runtime = runtime
        self.load_timeout_s = load_timeout_s or None
        # resolve_version memo: positive entries cache the provider's
        # latest, negative entries "no such model" briefly
        self._version_cache: dict[str, tuple[int, float]] = {}  # guarded-by: _version_cache_lock
        self._negative_cache: dict[str, float] = {}  # guarded-by: _version_cache_lock
        self._version_cache_lock = threading.Lock()
        self.version_cache_ttl_s = 10.0
        self.negative_cache_ttl_s = 2.0
        self._load_workers: set[threading.Thread] = set()  # guarded-by: _load_workers_lock
        self._load_workers_lock = threading.Lock()
        self.max_load_workers = 64
        # a model evicted from disk must not keep serving from the device
        disk_cache.add_evict_callback(self.runtime.unload_and_discard)

    def ensure_servable(self, model_id: ModelId) -> Model:
        """Hit/stale/miss decision + fetch/load; blocks until AVAILABLE."""
        model = self.disk_cache.get(model_id)
        if model is not None and self.runtime.is_loaded(model_id):
            return model
        t0 = time.monotonic()
        deadline = t0 + self.load_timeout_s if self.load_timeout_s else None
        with self.disk_cache.fetch_lock(model_id):  # per-model singleflight
            model = self.disk_cache.get(model_id)
            if model is not None:
                if not self.runtime.is_loaded(model_id):
                    log.info("stale %s: artifact cached, reloading runtime", model_id)
                    self._with_deadline(
                        lambda: self.runtime.ensure_loaded(model), deadline,
                        f"reload {model_id}",
                    )
            else:
                model = self._with_deadline(
                    lambda: self._fetch(model_id), deadline, f"fetch {model_id}"
                )
                self._with_deadline(
                    lambda: self.runtime.ensure_loaded(model), deadline,
                    f"load {model_id}",
                )
        log.info("servable %s in %.2fs", model_id, time.monotonic() - t0)
        return model

    def _with_deadline(self, fn, deadline: float | None, desc: str):
        """Run ``fn`` under the cold-load deadline. A blocking fetch or load
        cannot be interrupted in-thread, so with a deadline the work runs in
        a daemon worker while the caller waits: on expiry the request fails
        (LoadTimeoutError -> 504) and the worker finishes in the background,
        leaving the model warm or STALE for the next request."""
        if deadline is None:
            return fn()
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise LoadTimeoutError(
                f"{desc}: cold-load deadline ({self.load_timeout_s:.1f}s) already spent"
            )
        ctx = contextvars.copy_context()
        box: dict = {}
        done = threading.Event()

        def work() -> None:
            try:
                box["value"] = ctx.run(fn)
            except BaseException as e:  # noqa: BLE001 - re-raised in caller
                box["error"] = e
            finally:
                done.set()
                with self._load_workers_lock:
                    self._load_workers.discard(threading.current_thread())

        worker = threading.Thread(target=work, daemon=True, name="tpusc-load-worker")
        with self._load_workers_lock:
            if len(self._load_workers) >= self.max_load_workers:
                raise LoadTimeoutError(
                    f"{desc}: {self.max_load_workers} cold-load workers already in flight"
                )
            self._load_workers.add(worker)
        worker.start()
        if not done.wait(remaining):
            log.warning("%s exceeded cold-load deadline (%.1fs); work continues in background",
                        desc, self.load_timeout_s)
            raise LoadTimeoutError(
                f"{desc} exceeded cold-load deadline ({self.load_timeout_s:.1f}s)"
            )
        if "error" in box:
            raise box["error"]
        return box.get("value")

    def _fetch(self, model_id: ModelId) -> Model:
        """MISS path: size -> evict-to-fit -> provider fetch -> index."""
        t0 = time.monotonic()
        size = self.provider.model_size(model_id.name, model_id.version)
        self.disk_cache.ensure_free_bytes(size)
        model = self.provider.load_model(
            model_id.name, model_id.version, self.disk_cache.model_path(model_id)
        )
        self.disk_cache.put(model)
        log.info("fetched %s (%d bytes) in %.2fs",
                 model_id, model.size_on_disk, time.monotonic() - t0)
        return model

    def resolve_version(self, name: str, version: int | None) -> int:
        """A request without a version gets the newest known one: resident
        first, then disk-cached, then the provider's listing."""
        if version:
            return version
        loaded = [
            m.version for m, s in self.runtime.states_for(name).items()
            if s == ModelState.AVAILABLE
        ]
        if loaded:
            return max(loaded)
        known = [m.version for m in self.disk_cache.list_models() if m.name == name]
        if known:
            return max(known)
        now = time.monotonic()
        with self._version_cache_lock:
            hit = self._version_cache.get(name)
            if hit is not None and hit[1] > now:
                return hit[0]
            neg = self._negative_cache.get(name)
            if neg is not None and neg > now:
                raise ModelNotFoundError(f"model {name!r} not found (cached)")
        try:
            latest = self.provider.latest_version(name)
        except ModelNotFoundError:
            with self._version_cache_lock:
                if len(self._negative_cache) > 4096:
                    self._negative_cache.clear()
                self._negative_cache[name] = now + self.negative_cache_ttl_s
            raise
        with self._version_cache_lock:
            if len(self._version_cache) > 4096:
                self._version_cache.clear()
            self._version_cache[name] = (latest, now + self.version_cache_ttl_s)
        return latest

    def available_versions(self, name: str) -> list[int]:
        """All versions the node could serve, ascending: the provider's
        listing, else the disk-cached versions."""
        try:
            return self.provider.list_versions(name)
        except ModelNotFoundError:
            cached = sorted(m.version for m in self.disk_cache.list_models() if m.name == name)
            if cached:
                return cached
            raise

    def is_healthy(self) -> bool:
        try:
            self.provider.check()
            self.runtime.check()
            return True
        except Exception as e:  # noqa: BLE001 - health probe reports, never raises
            log.warning("health check failed: %s", e)
            return False

    def list_cached(self) -> list[ModelId]:
        return self.disk_cache.list_models()

    def close(self) -> None:
        self.runtime.close()
        with self._load_workers_lock:
            stragglers = list(self._load_workers)
        for t in stragglers:
            t.join(timeout=5.0)
        self.disk_cache.close()
