"""Kubernetes discovery: an Endpoints watch against the API server
(counterpart of ``tfservingcache_tpu/cluster/discovery/kubernetes.py``; the
same URLs and bodies, on the standard library's HTTP client).

  - a LIST for the whole state and its resourceVersion, then a WATCH from
    it; every event rebuilds its object's node list;
  - ports are the endpoint ports named ``rest`` and ``grpc``; only ready
    addresses count;
  - registration starts the watch and nothing else: the Service's
    selector and readiness own membership;
  - the namespace, bearer token and cluster CA come from the
    serviceaccount mount.
The watch's reads time out after ``WATCH_IDLE_S`` (it lists and watches
again), and ``unregister`` shuts its socket, so it returns within seconds.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import ssl
import threading
from typing import Callable

from tfservingcache_tpu_torch.cluster.discovery.base import DiscoveryService
from tfservingcache_tpu_torch.types import NodeInfo
from tfservingcache_tpu_torch.utils.net import close_stream, http_request, iter_lines, open_stream

log = logging.getLogger("tpusc_torch.discovery.k8s")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
REST_PORT_NAME = "rest"
GRPC_PORT_NAME = "grpc"
REQUEST_TIMEOUT_S = 10.0
WATCH_IDLE_S = 60.0


class K8sDiscoveryService(DiscoveryService):
    def __init__(self, service_name: str, namespace: str = "", field_selector: str = "",
                 poll_interval_s: float = 2.0, api_url: str = "", sa_dir: str = SA_DIR) -> None:
        super().__init__()
        self.service_name = service_name
        self.sa_dir = sa_dir
        self.namespace = namespace or self._read_sa_file("namespace") or "default"
        # default: the Endpoints object that shares the Service's name
        self.field_selector = field_selector or f"metadata.name={service_name}"
        self.poll_interval_s = poll_interval_s
        if not api_url:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise ValueError(
                    "k8s discovery needs an in-cluster environment "
                    "(KUBERNETES_SERVICE_HOST) or an explicit api_url"
                )
            api_url = f"https://{host}:{port}"
        self.api_url = api_url.rstrip("/")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._watch_conn: http.client.HTTPConnection | None = None
        self._endpoints: dict[str, list[NodeInfo]] = {}  # object name -> nodes

    def _read_sa_file(self, name: str) -> str:
        try:
            with open(os.path.join(self.sa_dir, name)) as f:
                return f.read().strip()
        except OSError:
            return ""

    def _ssl_context(self) -> ssl.SSLContext | None:
        if not self.api_url.startswith("https://"):
            return None
        ca = os.path.join(self.sa_dir, "ca.crt")
        return ssl.create_default_context(cafile=ca if os.path.exists(ca) else None)

    def _headers(self) -> dict[str, str]:
        token = self._read_sa_file("token")
        return {"Authorization": f"Bearer {token}"} if token else {}

    def register(self, self_node: NodeInfo, is_healthy: Callable[[], bool]) -> None:
        del self_node, is_healthy
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._watch_loop, name="tpusc-discovery-k8s",
                                            daemon=True)
            self._thread.start()

    # -- watch --------------------------------------------------------------
    def _endpoints_url(self, watch: bool, resource_version: str = "") -> str:
        params = [f"fieldSelector={self.field_selector}"]
        if watch:
            params.append("watch=1")
        if resource_version:
            params.append(f"resourceVersion={resource_version}")
        return (f"{self.api_url}/api/v1/namespaces/{self.namespace}/endpoints"
                f"?{'&'.join(params)}")

    def _watch_loop(self) -> None:
        ctx = self._ssl_context()
        while not self._stop.is_set():
            try:
                status, raw = http_request("GET", self._endpoints_url(watch=False),
                                           timeout=REQUEST_TIMEOUT_S, headers=self._headers(),
                                           context=ctx)
                if status != 200:
                    raise ConnectionError(f"endpoints list HTTP {status}")
                data = json.loads(raw)
                self._endpoints.clear()
                for obj in data.get("items", []) or []:
                    self._apply("ADDED", obj, publish=False)
                self._publish(self._flatten())
                rv = data.get("metadata", {}).get("resourceVersion", "")
                conn, resp = open_stream("GET", self._endpoints_url(True, rv), None,
                                         WATCH_IDLE_S, self._headers(), ctx)
                self._watch_conn = conn
                try:
                    if self._stop.is_set():
                        return
                    if resp.status != 200:
                        raise ConnectionError(f"endpoints watch HTTP {resp.status}")
                    for line in iter_lines(resp):
                        event = json.loads(line)
                        self._apply(event.get("type", ""), event.get("object", {}))
                finally:
                    self._watch_conn = None
                    conn.close()
            except (OSError, http.client.HTTPException, ValueError) as e:
                if self._stop.is_set():
                    break
                log.warning("k8s endpoints watch interrupted: %s; reconnecting", e)
                self._stop.wait(self.poll_interval_s)

    def _apply(self, ev_type: str, obj: dict, publish: bool = True) -> None:
        name = obj.get("metadata", {}).get("name", "")
        if not name:
            return
        if ev_type == "DELETED":
            self._endpoints.pop(name, None)
        else:  # ADDED / MODIFIED: rebuild this object's node list whole
            self._endpoints[name] = self._nodes_from_endpoints(obj)
        if publish:
            self._publish(self._flatten())

    def _flatten(self) -> list[NodeInfo]:
        return [n for nodes in self._endpoints.values() for n in nodes]

    @staticmethod
    def _nodes_from_endpoints(obj: dict) -> list[NodeInfo]:
        """Ready addresses x the named ports, a subset at a time."""
        nodes: list[NodeInfo] = []
        for subset in obj.get("subsets", []) or []:
            rest = grpc = None
            for port in subset.get("ports", []) or []:
                if port.get("name") == REST_PORT_NAME:
                    rest = int(port["port"])
                elif port.get("name") == GRPC_PORT_NAME:
                    grpc = int(port["port"])
            if rest is None or grpc is None:
                log.warning("endpoints %s subset lacks named ports %r/%r; skipping",
                            obj.get("metadata", {}).get("name"), REST_PORT_NAME, GRPC_PORT_NAME)
                continue
            for addr in subset.get("addresses", []) or []:
                ip = addr.get("ip", "")
                if ip:
                    nodes.append(NodeInfo(host=ip, rest_port=rest, grpc_port=grpc))
        return nodes

    def unregister(self) -> None:
        self._stop.set()
        close_stream(self._watch_conn)
        if self._thread is not None:
            self._thread.join(timeout=REQUEST_TIMEOUT_S)
            self._thread = None
