"""Warming on ring assignment (counterpart of
``tfservingcache_tpu/cluster/warmer.py``).

After a membership change each local group loads the models it now owns
(itself among the key's replicas) that are already in its disk cache, most
recently used first, so the first request after a remap finds them on the
device. Owned models that are not on disk are not fetched (warming all of
them would stampede the store on every remap), and models no longer owned
are left to age out of the LRU. The sweep stops at the runtime's free
resident capacity (``resident_headroom``, sized with
``registry.resident_bytes_estimate``), so it never evicts a model that
serves. One daemon thread does the work, always against the latest
membership: a remap mid-sweep restarts the sweep.
"""

from __future__ import annotations

import logging
import threading

from tfservingcache_tpu_torch.models.registry import resident_bytes_estimate

log = logging.getLogger("tpusc_torch.cluster.warmer")


class AssignmentWarmer:
    def __init__(self, cluster, groups: list[tuple[str, object]], metrics=None) -> None:
        """``cluster`` needs ``find_nodes_for_key``; ``groups`` pairs each
        local ring ident with its group's CacheManager."""
        self.cluster = cluster
        self.groups = groups
        self.metrics = metrics
        self._wake = threading.Event()
        self._stop = False
        self._generation = 0
        self.warmed = 0
        self._thread = threading.Thread(target=self._work_loop, name="tpusc-warmer",
                                        daemon=True)
        self._thread.start()

    def on_update(self, _nodes) -> None:
        """Membership callback: only wakes the worker."""
        self._generation += 1
        self._wake.set()

    def _work_loop(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            if self._stop:
                return
            gen = self._generation
            try:
                self._sweep(gen)
            except Exception:  # noqa: BLE001 - advisory work must not die
                log.exception("assignment warm sweep failed")

    def _sweep(self, gen: int) -> None:
        for ident, manager in self.groups:
            for mid in manager.disk_cache.list_models():  # MRU first
                if self._stop or self._generation != gen:
                    return  # newer membership: restart against it
                owners = {n.ident for n in self.cluster.find_nodes_for_key(mid.key)}
                if ident not in owners:
                    continue
                # re-checked right before warming: an eviction since the
                # listing would send ensure_servable to the store
                cached = manager.disk_cache.get(mid)
                if cached is None:
                    continue
                runtime = getattr(manager, "runtime", None)
                headroom = getattr(runtime, "resident_headroom", None)
                if headroom is not None and not runtime.is_loaded(mid):
                    free_slots, free_bytes = headroom()
                    est = (resident_bytes_estimate(cached.path)
                           or manager.disk_cache.size_of(mid) or 0)
                    if (free_slots is not None and free_slots <= 0) or est > free_bytes:
                        log.info("warm sweep for %s stopped at resident capacity (%s slots "
                                 "free, %d bytes free, next needs ~%d)",
                                 ident, free_slots, free_bytes, est)
                        break  # MRU first: everything after is colder
                try:
                    manager.ensure_servable(mid)
                    self.warmed += 1
                    if self.metrics is not None:
                        self.metrics.assignment_warms.inc()
                except Exception as e:  # noqa: BLE001 - the request path retries
                    log.warning("assignment warm of %s failed: %s", mid, e)

    def close(self) -> None:
        """Stop the worker (joins for 5 s; a load in flight cannot be
        interrupted: the thread exits at the next model boundary)."""
        self._stop = True
        self._generation += 1
        self._wake.set()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            log.warning("warmer thread still mid-load at close; it exits at the next "
                        "model boundary and its errors are swallowed")
