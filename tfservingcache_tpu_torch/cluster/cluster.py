"""ClusterConnection: membership -> ring (counterpart of
``tfservingcache_tpu/cluster/cluster.py``).

An update thread takes each membership snapshot from the discovery's queue
and replaces the consistent ring whole (``native.make_ring``: the C++ ring
when the native tier is built, ``cluster/hashring.py`` otherwise), then
runs the ``on_update`` callbacks with the node list. ``find_nodes_for_key``
returns a routing key's replica set: the ring's first N distinct members
clockwise from the key, N = ``replicas_per_model`` or, with a replica
controller attached (``replicas_for_key``), its per-key count.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
from typing import Callable

from tfservingcache_tpu_torch.cluster.discovery.base import DiscoveryService
from tfservingcache_tpu_torch.native import make_ring
from tfservingcache_tpu_torch.types import NodeInfo

log = logging.getLogger("tpusc_torch.cluster")

_STOP = object()  # ends the update thread


class ClusterConnection:
    def __init__(self, discovery: DiscoveryService, replicas_per_model: int = 1,
                 vnodes: int = 160) -> None:
        self.discovery = discovery
        self.replicas_per_model = replicas_per_model
        # per-key replica count (cluster/replication.py); the ring's walk
        # is prefix-stable in N, so a changing N only adds or drops the tail
        self.replicas_for_key: Callable[[str], int] | None = None
        self.ring = make_ring(vnodes=vnodes)
        self._nodes_by_ident: dict[str, NodeInfo] = {}
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._first_update = threading.Event()
        # called with the node list after each ring swap, on the update thread
        self.on_update: list[Callable[[list[NodeInfo]], None]] = []

    def connect(self, self_node: NodeInfo | list, is_healthy: Callable[[], bool],
                wait_ready_s: float = 5.0) -> None:
        """Register this host's ring member(s) and start consuming
        membership; waits up to ``wait_ready_s`` for the first snapshot.
        Entries are ``NodeInfo`` (heartbeats from ``is_healthy``) or
        ``(NodeInfo, its own is_healthy)`` pairs."""
        self._queue = self.discovery.subscribe()
        self._thread = threading.Thread(target=self._update_loop, args=(self._queue,),
                                        name="tpusc-cluster", daemon=True)
        self._thread.start()
        entries = self_node if isinstance(self_node, list) else [self_node]
        for entry in entries:
            node, health = entry if isinstance(entry, tuple) else (entry, is_healthy)
            self.discovery.register(node, health)
        if not self._first_update.wait(wait_ready_s):
            log.warning("no membership update within %.1fs; ring is empty", wait_ready_s)

    def _update_loop(self, q: queue.Queue) -> None:
        while True:
            nodes = q.get()
            if nodes is _STOP:
                return
            self._nodes_by_ident = {n.ident: n for n in nodes}
            self.ring.set_members(list(self._nodes_by_ident))
            self._first_update.set()
            log.info("cluster updated: %d node(s)", len(nodes))
            for cb in list(self.on_update):
                try:
                    cb(nodes)
                except Exception:  # noqa: BLE001 - one callback must not stop the rest
                    log.exception("cluster on_update callback failed")

    def find_nodes_for_key(self, key: str) -> list[NodeInfo]:
        """The replica set of a routing key."""
        n = self.replicas_per_model
        if self.replicas_for_key is not None:
            try:
                n = max(1, int(self.replicas_for_key(key)))
            except Exception:  # noqa: BLE001 - advisory hook, routing must not fail
                n = self.replicas_per_model
        nodes = self._nodes_by_ident
        return [nodes[i] for i in self.ring.get_n(key, n) if i in nodes]

    def node_for_key(self, key: str) -> NodeInfo | None:
        """A random pick among the replicas."""
        nodes = self.find_nodes_for_key(key)
        return random.choice(nodes) if nodes else None

    @property
    def node_count(self) -> int:
        return len(self.ring)

    def disconnect(self) -> None:
        """Stop the update thread and unregister from discovery."""
        if self._queue is not None:
            self._queue.put(_STOP)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.discovery.unregister()
