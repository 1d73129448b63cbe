"""Discovery interface (counterpart of
``tfservingcache_tpu/cluster/discovery/base.py``).

A backend pushes whole membership snapshots (lists of ``NodeInfo``) into
every subscriber's queue; a subscriber (``ClusterConnection``) replaces its
ring with each one. The backends run their watch and heartbeat loops on
threads with a stop event, where the reference runs asyncio tasks, so the
queues are ``queue.Queue``: a publish from any thread reaches a reader on
any other.
"""

from __future__ import annotations

import abc
import queue
import threading
from typing import Callable

from tfservingcache_tpu_torch.types import NodeInfo


class DiscoveryService(abc.ABC):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subscribers: list[queue.Queue] = []  # guarded-by: _lock
        self._last: list[NodeInfo] | None = None  # guarded-by: _lock

    def subscribe(self) -> queue.Queue:
        """A queue of membership snapshots; the latest one, if any, is in it
        already."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._subscribers.append(q)
            if self._last is not None:
                q.put_nowait(list(self._last))
        return q

    def _publish(self, nodes: list[NodeInfo]) -> None:
        with self._lock:
            self._last = list(nodes)
            for q in self._subscribers:
                q.put_nowait(list(nodes))

    @abc.abstractmethod
    def register(self, self_node: NodeInfo, is_healthy: Callable[[], bool]) -> None:
        """Announce this node and start watching membership. ``is_healthy``
        feeds the heartbeats of backends with liveness checks (consul,
        etcd)."""

    @abc.abstractmethod
    def unregister(self) -> None:
        """Withdraw this node and stop every loop the backend started
        (returns within a few seconds)."""
