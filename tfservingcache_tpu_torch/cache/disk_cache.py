"""Disk artifact cache: versioned model dirs under a byte-budgeted LRU
(counterpart of ``tfservingcache_tpu/cache/disk_cache.py``; the index is
``native.make_lru_cache``'s, the C++ LRU when it is built).

Layout is ``<base_dir>/<name>/<version>/...``. The index is rebuilt from disk
at startup, and eviction removes the artifact's directory tree on a
dedicated worker thread.
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import threading
from contextlib import contextmanager
from typing import Callable, Iterator

from tfservingcache_tpu_torch.cache.lru import LRUEntry
from tfservingcache_tpu_torch.native import make_lru_cache
from tfservingcache_tpu_torch.types import Model, ModelId

log = logging.getLogger("tpusc_torch.disk_cache")


def dir_size_bytes(path: str) -> int:
    """Recursive size of a directory tree."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            fp = os.path.join(root, f)
            try:
                total += os.path.getsize(fp)
            except OSError:
                pass
    return total


class ModelDiskCache:
    def __init__(self, base_dir: str, capacity_bytes: int) -> None:
        self.base_dir = os.path.abspath(base_dir)
        os.makedirs(self.base_dir, exist_ok=True)
        # every subscriber (a runtime's unload) hears of an eviction: a
        # model whose artifact is gone must not stay resident
        self._evict_callbacks: list[Callable[[ModelId], None]] = []
        self.lru = make_lru_cache(capacity_bytes, self._evict)
        # Per-model mutexes shared by eviction and (re)load: a deferred evict
        # rmtree must not race a concurrent re-fetch writing the same path.
        self._key_locks: dict[ModelId, threading.Lock] = {}
        self._key_locks_guard = threading.Lock()
        # Evictions run on one dedicated worker so the thread that *caused*
        # an eviction (holding its own model's fetch_lock) never blocks on
        # another model's key lock — two concurrent misses evicting each
        # other's models would otherwise ABBA-deadlock.
        self._evict_queue: queue.Queue = queue.Queue()
        self._evict_worker = threading.Thread(
            target=self._evict_loop, name="tpusc-disk-evict", daemon=True
        )
        self._evict_worker.start()
        self._recover_index()

    @contextmanager
    def fetch_lock(self, model_id: ModelId) -> Iterator[None]:
        """Hold while fetching/writing ``model_id``'s artifact dir. The evict
        callback takes the same lock, so an in-flight eviction of a model that
        is being re-loaded waits, then sees it resident again and skips."""
        with self._key_locks_guard:
            lock = self._key_locks.setdefault(model_id, threading.Lock())
        try:
            with lock:
                yield
        finally:
            # Failure-path pruning: a fetch that never lands (provider error,
            # deadline) leaves a key the evict-side pruning can never reach —
            # never cached means never evicted — so a storm of misses on bad
            # names would grow this dict without bound. Same rule as
            # _evict_impl: drop the entry once it is idle and non-resident.
            with self._key_locks_guard:
                held = self._key_locks.get(model_id)
                if held is lock and not held.locked() and model_id not in self.lru:
                    del self._key_locks[model_id]

    # -- paths --------------------------------------------------------------
    def model_path(self, model_id: ModelId) -> str:
        return os.path.join(self.base_dir, model_id.name, str(model_id.version))

    # -- LRU facade ---------------------------------------------------------
    def get(self, model_id: ModelId) -> Model | None:
        # a read IS a use: touch to MRU so the hot tail of a churned tenant
        # population survives eviction pressure (touch=False would turn the
        # LRU into FIFO)
        model = self.lru.get(model_id, touch=True)
        if model is None:
            return None
        # Tolerate out-of-band deletion: index says cached but files are gone
        # (the index is rebuilt from disk, so double-check the files).
        if not os.path.exists(model.path):
            self.lru.remove(model_id)
            return None
        return model

    def put(self, model: Model) -> list[ModelId]:
        # charge what is ACTUALLY on disk, not what the provider claimed:
        # a drifted size_on_disk (manifest lies, partial rewrite, compression
        # difference) would otherwise skew the byte budget until restart
        if os.path.isdir(model.path):
            actual = dir_size_bytes(model.path)
            if actual != model.size_on_disk:
                log.warning(
                    "size drift for %s: claimed %d bytes, %d on disk",
                    model.identifier, model.size_on_disk, actual,
                )
                model.size_on_disk = actual
        return self.lru.put(model.identifier, model.size_on_disk, model)

    def ensure_free_bytes(self, n: int) -> list[ModelId]:
        return self.lru.ensure_free_bytes(n)

    def size_of(self, model_id: ModelId) -> int | None:
        """On-disk artifact bytes (None if absent)."""
        model = self.lru.get(model_id, touch=False)
        return None if model is None else model.size_on_disk

    @property
    def total_bytes(self) -> int:
        return self.lru.total_bytes

    def list_models(self) -> list[ModelId]:
        return self.lru.keys_mru_first()

    # -- internals ----------------------------------------------------------
    def _evict(self, model_id: ModelId, entry: LRUEntry[Model]) -> None:
        self._evict_queue.put((model_id, entry))

    def close(self) -> None:
        """Finish queued evictions and stop the eviction worker."""
        self._evict_queue.put(None)
        self._evict_worker.join(timeout=10.0)

    def _evict_loop(self) -> None:
        while True:
            item = self._evict_queue.get()
            try:
                if item is None:
                    return
                self._evict_impl(*item)
            except Exception:  # noqa: BLE001 - worker must survive bad evictions
                log.exception("eviction failed")
            finally:
                self._evict_queue.task_done()

    def drain_evictions(self) -> None:
        """Block until all queued evictions have completed (tests, shutdown)."""
        self._evict_queue.join()

    def _evict_impl(self, model_id: ModelId, entry: LRUEntry[Model]) -> None:
        with self._key_locks_guard:
            lock = self._key_locks.setdefault(model_id, threading.Lock())
        with lock:
            if model_id in self.lru:
                # The key is resident again: either a replacement put() (same
                # path, overwritten in place) or a re-fetch that won the race
                # against this deferred eviction. Nothing to free.
                return
            path = self.model_path(model_id)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            # prune now-empty model dir
            parent = os.path.dirname(path)
            try:
                if os.path.isdir(parent) and not os.listdir(parent):
                    os.rmdir(parent)
            except OSError:
                pass
        log.info("evicted %s from disk cache (%d bytes)", model_id, entry.size_bytes)
        # prune this model's key lock (bounded memory under tenant churn); a
        # racer holding the popped lock at worst repeats idempotent work
        with self._key_locks_guard:
            held = self._key_locks.get(model_id)
            if held is not None and not held.locked():
                del self._key_locks[model_id]
        for cb in list(self._evict_callbacks):
            try:
                cb(model_id)
            except Exception:  # noqa: BLE001 - one group's failure can't block others
                log.exception("disk-evict callback failed for %s", model_id)

    def add_evict_callback(self, cb: Callable[[ModelId], None]) -> None:
        self._evict_callbacks.append(cb)

    def _recover_index(self) -> None:
        """Repopulate the LRU from artifacts already on disk (restart path)."""
        found: list[tuple[float, ModelId, str, int]] = []
        try:
            names = os.listdir(self.base_dir)
        except OSError:
            return
        for name in names:
            model_dir = os.path.join(self.base_dir, name)
            try:
                versions = os.listdir(model_dir)
            except (NotADirectoryError, OSError):
                continue
            for ver in versions:
                vdir = os.path.join(model_dir, ver)
                if ".tmp-" in ver:
                    # stray staging dir from a crash mid-fetch (providers write
                    # to <ver>.tmp-<pid> then atomically rename)
                    shutil.rmtree(vdir, ignore_errors=True)
                    continue
                try:
                    version = int(ver)
                except ValueError:
                    continue
                try:
                    if not os.path.isdir(vdir):
                        continue
                    found.append(
                        (os.path.getmtime(vdir), ModelId(name, version), vdir, dir_size_bytes(vdir))
                    )
                except OSError:
                    # vanished out-of-band between listdir and stat — skip it,
                    # don't abort recovery of the remaining artifacts
                    continue
        # oldest first so mtime order becomes LRU order
        for _mtime, mid, vdir, size in sorted(found):
            try:
                self.lru.put(mid, size, Model(identifier=mid, path=vdir, size_on_disk=size))
            except Exception as e:
                log.warning(
                    "dropping recovered artifact %s (%d bytes) that no longer fits: %s",
                    mid, size, e,
                )
                shutil.rmtree(vdir, ignore_errors=True)
        if found:
            log.info("recovered %d cached artifacts (%d bytes)", len(self.lru), self.lru.total_bytes)
