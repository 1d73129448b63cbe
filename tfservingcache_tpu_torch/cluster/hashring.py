"""Consistent hash ring (the port's copy of
``tfservingcache_tpu/cluster/hashring.py``): ``native.make_ring``'s
fallback when the C++ tier is not built.

64-bit BLAKE2b points, ``vnodes`` virtual nodes a member (``member#i``),
bisect lookups, and a ``get_n`` that walks the ring for N *distinct*
members (the replicas of a key). Keys are ``name##version`` routing keys;
members are node identity strings ``host:restPort:grpcPort``. The native
ring places every key on the same owners.
"""

from __future__ import annotations

import bisect
import hashlib
import threading

from tfservingcache_tpu_torch.utils.lockcheck import lockchecked


def _point(data: str) -> int:
    return int.from_bytes(hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


@lockchecked
class HashRing:
    _tpusc_guarded = {
        "_points": "_lock",
        "_owners": "_lock",
        "_members": "_lock",
    }

    def __init__(self, vnodes: int = 160) -> None:
        self.vnodes = vnodes
        self._lock = threading.Lock()
        self._points: list[int] = []        # sorted hash points
        self._owners: list[str] = []        # owner member per point (parallel)
        self._members: set[str] = set()

    # -- membership ---------------------------------------------------------
    def set_members(self, members: list[str]) -> None:
        """Atomic full replacement: the whole ring is rebuilt, so the order
        of membership events cannot corrupt incremental state."""
        pairs: list[tuple[int, str]] = []
        for m in set(members):
            for i in range(self.vnodes):
                pairs.append((_point(f"{m}#{i}"), m))
        pairs.sort()
        with self._lock:
            self._points = [p for p, _ in pairs]
            self._owners = [o for _, o in pairs]
            self._members = set(members)

    @property
    def members(self) -> set[str]:
        with self._lock:
            return set(self._members)

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    # -- lookup -------------------------------------------------------------
    def get_n(self, key: str, n: int) -> list[str]:
        """N distinct members for ``key``, walking clockwise from the key's
        point. n is clamped to the member count; n < 1 counts as 1."""
        n = max(n, 1)
        with self._lock:
            if not self._points:
                return []
            n = min(n, len(self._members))
            idx = bisect.bisect_left(self._points, _point(key)) % len(self._points)
            found: list[str] = []
            seen: set[str] = set()
            for step in range(len(self._points)):
                owner = self._owners[(idx + step) % len(self._points)]
                if owner not in seen:
                    seen.add(owner)
                    found.append(owner)
                    if len(found) == n:
                        break
            return found

    def get(self, key: str) -> str | None:
        nodes = self.get_n(key, 1)
        return nodes[0] if nodes else None
