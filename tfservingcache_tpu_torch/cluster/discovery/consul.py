"""Consul discovery over the agent and health HTTP APIs (counterpart of
``tfservingcache_tpu/cluster/discovery/consul.py``; the same endpoints and
bodies, on the standard library's HTTP client).

  - registration puts the two ports in tags ``rest:<p>`` / ``grpc:<p>``
    with a TTL check that deregisters after 100 x ttl;
  - a heartbeat thread passes or fails the check from the health function
    every ttl/2;
  - a poll thread reads ``/v1/health/service/<name>?passing=1`` every
    ``poll_interval_s``; an agent error keeps the last membership.
Every request has a timeout and every loop waits on a stop event, so
``unregister`` returns within seconds.
"""

from __future__ import annotations

import json
import logging
import threading
import uuid
from typing import Callable

from tfservingcache_tpu_torch.cluster.discovery.base import DiscoveryService
from tfservingcache_tpu_torch.types import NodeInfo
from tfservingcache_tpu_torch.utils.net import http_request

log = logging.getLogger("tpusc_torch.discovery.consul")

DEREGISTER_AFTER_TTL_MULTIPLE = 100
REQUEST_TIMEOUT_S = 10.0


class ConsulDiscoveryService(DiscoveryService):
    def __init__(self, address: str, service_name: str, ttl_s: float = 5.0,
                 poll_interval_s: float = 5.0) -> None:
        super().__init__()
        self.base = (address or "http://127.0.0.1:8500").rstrip("/")
        self.service_name = service_name
        self.ttl_s = ttl_s
        self.poll_interval_s = poll_interval_s
        # one service id a register() call
        self._service_ids: list[str] = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._polling = False

    def _spawn(self, target, *args) -> None:
        t = threading.Thread(target=target, args=args, name="tpusc-discovery-consul",
                             daemon=True)
        self._threads.append(t)
        t.start()

    def register(self, self_node: NodeInfo, is_healthy: Callable[[], bool]) -> None:
        service_id = f"{self.service_name}-{uuid.uuid4().hex[:12]}"
        self._service_ids.append(service_id)
        self._stop.clear()
        body = {
            "Name": self.service_name,
            "ID": service_id,
            "Address": self_node.host,
            "Port": self_node.rest_port,
            "Tags": [f"rest:{self_node.rest_port}", f"grpc:{self_node.grpc_port}"],
            "Check": {
                "TTL": f"{self.ttl_s:g}s",
                "DeregisterCriticalServiceAfter":
                    f"{self.ttl_s * DEREGISTER_AFTER_TTL_MULTIPLE:g}s",
            },
        }
        status, raw = http_request("PUT", f"{self.base}/v1/agent/service/register", body,
                                   REQUEST_TIMEOUT_S)
        if status != 200:
            raise ConnectionError(
                f"consul register failed: HTTP {status}: {raw.decode(errors='replace')}")
        self._spawn(self._heartbeat_loop, service_id, is_healthy)
        if not self._polling:
            self._polling = True
            self._spawn(self._poll_loop)
        log.info("registered %s with consul at %s", service_id, self.base)

    def _heartbeat_loop(self, service_id: str, is_healthy: Callable[[], bool]) -> None:
        while not self._stop.is_set():
            verb = "pass" if is_healthy() else "fail"
            try:
                status, _ = http_request(
                    "PUT", f"{self.base}/v1/agent/check/{verb}/service:{service_id}",
                    timeout=REQUEST_TIMEOUT_S)
                if status != 200:
                    log.warning("consul heartbeat %s: HTTP %d", verb, status)
            except OSError as e:
                log.warning("consul heartbeat failed: %s", e)
            self._stop.wait(self.ttl_s / 2)

    def _poll_loop(self) -> None:
        last: list[str] | None = None
        while not self._stop.is_set():
            entries = None
            try:
                status, raw = http_request(
                    "GET", f"{self.base}/v1/health/service/{self.service_name}?passing=1",
                    timeout=REQUEST_TIMEOUT_S)
                if status == 200:
                    entries = json.loads(raw)
                else:
                    # an agent error (a leader election's 500) is not "no
                    # peers": publishing [] would empty every ring
                    log.warning("consul poll: HTTP %d", status)
            except (OSError, ValueError) as e:
                log.warning("consul poll failed: %s", e)
            if entries is not None:
                nodes = []
                for entry in entries:
                    node = self._node_from_service(entry.get("Service", {}))
                    if node is not None:
                        nodes.append(node)
                idents = sorted(n.ident for n in nodes)
                if idents != last:
                    last = idents
                    self._publish(nodes)
            self._stop.wait(self.poll_interval_s)

    @staticmethod
    def _node_from_service(svc: dict) -> NodeInfo | None:
        host = svc.get("Address", "")
        rest = grpc = None
        try:
            for tag in svc.get("Tags", []) or []:
                if tag.startswith("rest:"):
                    rest = int(tag[5:])
                elif tag.startswith("grpc:"):
                    grpc = int(tag[5:])
        except ValueError:
            log.warning("consul entry has malformed port tag: %r", svc)
            return None
        if not host or rest is None or grpc is None:
            log.warning("consul entry missing address/port tags: %r", svc)
            return None
        return NodeInfo(host=host, rest_port=rest, grpc_port=grpc)

    def unregister(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=REQUEST_TIMEOUT_S)
        self._threads.clear()
        self._polling = False
        for service_id in self._service_ids:
            try:
                status, _ = http_request(
                    "PUT", f"{self.base}/v1/agent/service/deregister/{service_id}",
                    timeout=REQUEST_TIMEOUT_S)
                if status != 200:
                    log.warning("consul deregister: HTTP %d", status)
            except OSError as e:
                log.warning("consul deregister failed: %s", e)
        self._service_ids.clear()
