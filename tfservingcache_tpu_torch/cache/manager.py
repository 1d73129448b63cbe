"""CacheManager — per-node JIT load orchestration (counterpart of
``tfservingcache_tpu/cache/manager.py``).

  - HIT: artifact on disk and model resident in the runtime;
  - STALE: artifact on disk, model not resident -> reload without re-fetch;
  - MISS: evict-to-fit on disk, fetch from the provider, then load. A
    ``PeerProvider`` that streamed the model from a warm peer stamps
    ``fetch_source: "peer"`` and hands over the packed entry it rebuilt,
    which the runtime promotes (``adopt_packed_entry``).

The scenario lab's ``store_fetch`` site (``stall_store``) sits at the top of
the provider miss. The reference's streaming fetch hook (``on_file`` ->
``precompile_from_meta``) is left out: a torch module has no ahead-of-time
compile to start while the artifact downloads.

Per-model singleflight: concurrent misses on different models proceed in
parallel, concurrent requests for one model share one fetch and load. A
cold-load deadline (``serving.load_timeout_s``) bounds fetch + load.

Observability (reference manager.py:129-209, :330-355): the
``ensure_servable`` and ``provider_fetch`` spans, the ``tfservingcache_cache*``
counters and histograms, ``tpusc_reload_source{tier}``, the disk-cache
bytes gauge, and the tenant ledger's ``note_load`` and disk levels.
"""

from __future__ import annotations

import contextvars
import logging
import threading
import time

from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.providers.base import ModelNotFoundError, ModelProvider
from tfservingcache_tpu_torch.lab import faults as lab_faults
from tfservingcache_tpu_torch.runtime.base import BaseRuntime, LoadTimeoutError
from tfservingcache_tpu_torch.types import Model, ModelId, ModelState
from tfservingcache_tpu_torch.utils.accounting import LEDGER
from tfservingcache_tpu_torch.utils.metrics import Metrics
from tfservingcache_tpu_torch.utils.tracing import TRACER

log = logging.getLogger("tpusc_torch.cachemanager")


class VersionLabelError(LookupError):
    """A version label with no mapping in ``serving.version_labels``: the
    request answers 412 (REST) / FAILED_PRECONDITION (gRPC), as TF Serving
    fails an unmapped label; it never serves the latest version."""


def resolve_version_label(version_labels: dict, name: str, label: str) -> int:
    """``version_labels[name][label]`` as an int, else ``VersionLabelError``
    (reference manager.py:47-57)."""
    try:
        return int(version_labels[name][label])
    except (KeyError, TypeError, ValueError):
        raise VersionLabelError(
            f"version label {label!r} is not mapped for model {name!r} "
            "(serving.version_labels)"
        ) from None


class CacheManager:
    def __init__(
        self,
        provider: ModelProvider,
        disk_cache: ModelDiskCache,
        runtime: BaseRuntime,
        load_timeout_s: float | None = None,
        metrics: Metrics | None = None,
        version_labels: dict | None = None,
    ) -> None:
        self.provider = provider
        self.metrics = metrics
        self.disk_cache = disk_cache
        self.runtime = runtime
        self.load_timeout_s = load_timeout_s or None
        # {model_name: {label: version}} from serving.version_labels
        self.version_labels = version_labels or {}
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
        disk_cache.add_evict_callback(self._on_disk_evict)

    def _on_disk_evict(self, model_id: ModelId) -> None:
        self.runtime.unload_and_discard(model_id)
        self._sync_disk_ledger()

    def _sync_disk_ledger(self) -> None:
        """Stamp per-tenant disk-cache levels into the cost ledger
        (owner-scoped: several managers in one process never zero each
        other's artifacts)."""
        levels: dict[str, float] = {}
        for mid in self.disk_cache.list_models():
            nbytes = self.disk_cache.size_of(mid)
            if nbytes:
                levels[str(mid)] = float(nbytes)
        LEDGER.gauge_sync("disk_bytes", levels, owner=f"disk:{id(self)}")

    def ensure_servable(self, model_id: ModelId) -> Model:
        """Hit/stale/miss decision + fetch/load; blocks until AVAILABLE
        (reference manager.py:131-209)."""
        m = self.metrics
        label = None
        if m is not None:
            label = m.model_label(model_id.name, model_id.version)
            m.cache_total.labels(label).inc()
        t0 = time.monotonic()
        # fast path outside the lock: fully warm
        model = self.disk_cache.get(model_id)
        if model is not None and self.runtime.is_loaded(model_id):
            if m is not None:
                m.cache_hits.labels(label).inc()
                m.reload_source.labels("hbm").inc()
                m.cache_duration.labels(label).observe(time.monotonic() - t0)
            LEDGER.note_load(str(model_id), "hbm", time.monotonic() - t0)
            return model
        deadline = t0 + self.load_timeout_s if self.load_timeout_s else None
        with TRACER.span("ensure_servable", model=str(model_id)) as span, \
                self.disk_cache.fetch_lock(model_id):  # per-model singleflight
            model = self.disk_cache.get(model_id)
            if model is not None:
                hit = True
                source = "hbm"  # another waiter finished the work
                if not self.runtime.is_loaded(model_id):
                    log.info("stale %s: artifact cached, reloading runtime", model_id)
                    source = self._with_deadline(
                        lambda: self.runtime.ensure_loaded(model), deadline,
                        f"reload {model_id}",
                    )
            else:
                hit = False
                model = self._with_deadline(
                    lambda: self._fetch(model_id), deadline, f"fetch {model_id}"
                )
                # a PeerProvider stamps where the bytes came from
                source = model.metadata.get("fetch_source", "store")
                if source not in ("peer", "store"):
                    source = "store"
                # popped whatever happens next: a Model lives in the disk
                # cache's map, and a kept entry would hold the packed bytes
                # in RAM for as long as the artifact stays cached
                packed = model.metadata.pop("packed_entry", None)
                if packed is not None:
                    adopt = getattr(self.runtime, "adopt_packed_entry", None)
                    if adopt is not None:
                        adopt(model_id, packed)
                self._with_deadline(
                    lambda: self.runtime.ensure_loaded(model), deadline,
                    f"load {model_id}",
                )
            span.attrs["reload_source"] = source
            if m is not None:
                (m.cache_hits if hit else m.cache_misses).labels(label).inc()
                m.reload_source.labels(source).inc()
                m.cache_duration.labels(label).observe(time.monotonic() - t0)
                m.disk_bytes_in_use.set(self.disk_cache.total_bytes)
            LEDGER.note_load(str(model_id), source, time.monotonic() - t0)
            self._sync_disk_ledger()
        log.info("servable %s in %.2fs", model_id, time.monotonic() - t0)
        return model

    def residency_warmth(self, model_id: ModelId) -> int:
        """How warm ``model_id`` is on this node: 3 = resident on the device,
        2 = packed in the host tier, 1 = artifact on disk, 0 = cold. The
        router's equal-load tie-break reads it; it never raises and never
        touches LRU order."""
        try:
            if self.runtime.is_loaded(model_id):
                return 3
            contains = getattr(self.runtime, "host_tier_contains", None)
            if contains is not None and contains(model_id):
                return 2
            if self.disk_cache.size_of(model_id) is not None:
                return 1
        except Exception:  # noqa: BLE001 - advisory only
            pass
        return 0

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

    def prefetch(self, model_id: ModelId) -> Model:
        """The host half of a cold miss only: the artifact onto the local
        disk, the runtime untouched (reference manager.py:288). A group that
        spans processes runs it as a joinable first phase
        (``parallel/multihost.py``), so that a provider or disk failure
        surfaces before any process enters a collective."""
        with self.disk_cache.fetch_lock(model_id):
            model = self.disk_cache.get(model_id)
            if model is not None:
                return model
            return self._fetch(model_id)

    def _fetch(self, model_id: ModelId) -> Model:
        """MISS path: size -> evict-to-fit -> provider fetch -> index."""
        t0 = time.monotonic()
        # the scenario lab's stall_store sleeps here (a hung object store),
        # under the caller's cold-load deadline; disarmed, one bool read
        lab_faults.fire("store_fetch", model=str(model_id))
        with TRACER.span("provider_fetch", model=str(model_id)):
            size = self.provider.model_size(model_id.name, model_id.version)
            self.disk_cache.ensure_free_bytes(size)
            model = self.provider.load_model(
                model_id.name, model_id.version, self.disk_cache.model_path(model_id)
            )
        self.disk_cache.put(model)
        if self.metrics is not None:
            self.metrics.cache_fetch_duration.labels(
                self.metrics.model_label(model_id.name, model_id.version)
            ).observe(time.monotonic() - t0)
            # the fetch stage of the cold-stage family (the runtime's load
            # span records the device stages)
            self.metrics.cold_stage_seconds.labels("provider_fetch").observe(
                time.monotonic() - t0)
        log.info("fetched %s (%d bytes) in %.2fs",
                 model_id, model.size_on_disk, time.monotonic() - t0)
        return model

    def resolve_version(self, name: str, version: int | None,
                        label: str | None = None) -> int:
        """A ``label`` resolves through ``version_labels`` or raises
        ``VersionLabelError``. A request without a version gets the newest
        known one: resident first, then disk-cached, then the provider's
        listing."""
        if label:
            return resolve_version_label(self.version_labels, name, label)
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
