"""Static discovery: a fixed list of idents from the config (counterpart of
``tfservingcache_tpu/cluster/discovery/static.py``)."""

from __future__ import annotations

from typing import Callable

from tfservingcache_tpu_torch.cluster.discovery.base import DiscoveryService
from tfservingcache_tpu_torch.types import NodeInfo


class StaticDiscoveryService(DiscoveryService):
    def __init__(self, nodes: list[str]) -> None:
        super().__init__()
        self.nodes = [NodeInfo.from_ident(n) for n in nodes]
        # accumulated across register() calls: each keeps the earlier ones
        self._registered: list[NodeInfo] = []

    def register(self, self_node: NodeInfo, is_healthy: Callable[[], bool]) -> None:
        if all(n.ident != self_node.ident for n in self._registered):
            self._registered.append(self_node)
        nodes = list(self.nodes)
        nodes.extend(n for n in self._registered if all(m.ident != n.ident for m in nodes))
        self._publish(nodes)

    def unregister(self) -> None:
        self._registered.clear()
