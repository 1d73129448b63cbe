"""Byte-budgeted LRU cache, tier-generic (a pure-Python copy of
``tfservingcache_tpu/cache/lru.py``).

Used for both tiers: the disk artifact tier (payload = artifact dir, evict
callback deletes the tree) and the GPU tier (payload = resident model,
evict callback drops it so its device memory is freed). Thread-safe;
eviction callbacks run outside the lock; oversized items are rejected
rather than evicting the world first.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

EvictCallback = Callable[[K, "LRUEntry[V]"], None]


@dataclass
class LRUEntry(Generic[V]):
    size_bytes: int
    payload: V


class CapacityError(Exception):
    """Item larger than the whole cache budget."""


class LRUCache(Generic[K, V]):
    def __init__(
        self,
        capacity_bytes: int,
        on_evict: EvictCallback | None = None,
        max_items: int | None = None,
    ) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self.max_items = max_items
        self._on_evict = on_evict
        self._lock = threading.RLock()
        self._entries: OrderedDict[K, LRUEntry[V]] = OrderedDict()  # MRU last
        self._total = 0

    # -- introspection ------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._entries

    def keys_mru_first(self) -> list[K]:
        """Reference ``ListModels`` returns MRU-first order (lrucache.go:89-97)."""
        with self._lock:
            return list(reversed(self._entries.keys()))

    # -- core ---------------------------------------------------------------
    def get(self, key: K, touch: bool = True) -> V | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            if touch:
                self._entries.move_to_end(key)
            return entry.payload

    def put(self, key: K, size_bytes: int, payload: V) -> list[K]:
        """Insert/replace and evict LRU entries until the budget fits.

        Returns the keys evicted to make room (reference Put, lrucache.go:41-65).
        Replacing an existing key runs the evict callback on the old entry so
        tier resources (HBM executables, artifact trees) are released.
        """
        size_bytes = int(size_bytes)
        if size_bytes > self.capacity_bytes:
            raise CapacityError(
                f"item {key!r} ({size_bytes}B) exceeds cache capacity {self.capacity_bytes}B"
            )
        with self._lock:
            evicted: list[tuple[K, LRUEntry[V]]] = []
            old = self._entries.pop(key, None)
            if old is not None:
                self._total -= old.size_bytes
                evicted.append((key, old))
            evicted += self._evict_to_fit_locked(size_bytes, extra_items=1)
            self._entries[key] = LRUEntry(size_bytes, payload)
            self._total += size_bytes
        self._run_callbacks(evicted)
        return [k for k, _ in evicted if k != key]

    def remove(self, key: K, run_callback: bool = False) -> V | None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            self._total -= entry.size_bytes
        if run_callback and self._on_evict is not None:
            self._on_evict(key, entry)
        return entry.payload

    def ensure_free_bytes(self, n: int) -> list[K]:
        """Evict LRU entries until at least ``n`` bytes are free
        (reference EnsureFreeBytes, lrucache.go:68-87). Raises CapacityError
        up front when ``n`` can never fit — draining the whole warm cache for
        a load that must fail anyway would be strictly worse."""
        n = int(n)
        if n > self.capacity_bytes:
            raise CapacityError(
                f"requested {n}B free exceeds cache capacity {self.capacity_bytes}B"
            )
        with self._lock:
            evicted = self._evict_to_fit_locked(n, extra_items=0)
        self._run_callbacks(evicted)
        return [k for k, _ in evicted]

    def _evict_to_fit_locked(self, n: int, extra_items: int) -> list[tuple[K, LRUEntry[V]]]:
        """Pop LRU entries until ``n`` extra bytes fit. Callbacks are NOT run
        here — callers run them after releasing the lock so slow eviction work
        (rmtree of a multi-GB artifact, device unload) never blocks readers."""
        evicted: list[tuple[K, LRUEntry[V]]] = []
        while self._entries and (
            self._total + n > self.capacity_bytes
            or (self.max_items is not None and len(self._entries) + extra_items > self.max_items)
        ):
            key, entry = self._entries.popitem(last=False)  # LRU first
            self._total -= entry.size_bytes
            evicted.append((key, entry))
        return evicted

    def _run_callbacks(self, evicted: list[tuple[K, LRUEntry[V]]]) -> None:
        if self._on_evict is None:
            return
        for key, entry in evicted:
            self._on_evict(key, entry)

    def clear(self) -> None:
        with self._lock:
            evicted = [(k, e) for k, e in self._entries.items()]
            self._entries.clear()
            self._total = 0
        self._run_callbacks(evicted)
