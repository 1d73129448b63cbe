"""etcd discovery over the v3 JSON gateway (counterpart of
``tfservingcache_tpu/cluster/discovery/etcd.py``; the same endpoints and
bodies, on the standard library's HTTP client).

  - registration by leased key heartbeat: every ttl/2 a heartbeat thread
    grants a fresh lease of ttl seconds and puts
    ``/service/<name>/<uuid> = host:rest:grpc`` under it, so a dead node's
    key expires within ttl; an unhealthy node skips the beat;
  - membership by a prefix watch: each (re)connect reads the whole range
    first, then applies the watch's create / modify / delete events. The
    watch thread's reads time out after ``WATCH_IDLE_S`` (it reconnects),
    and ``unregister`` shuts its socket, so it returns within seconds.
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import threading
import uuid
from typing import Callable

from tfservingcache_tpu_torch.cluster.discovery.base import DiscoveryService
from tfservingcache_tpu_torch.types import NodeInfo
from tfservingcache_tpu_torch.utils.net import close_stream, http_request, iter_lines, open_stream

log = logging.getLogger("tpusc_torch.discovery.etcd")

REQUEST_TIMEOUT_S = 10.0
WATCH_IDLE_S = 30.0   # a watch stream silent this long is reopened


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def _unb64(s: str) -> str:
    return base64.b64decode(s).decode()


def prefix_range_end(prefix: str) -> str:
    """etcd prefix query upper bound: prefix with its last byte incremented."""
    b = bytearray(prefix.encode())
    for i in range(len(b) - 1, -1, -1):
        if b[i] < 0xFF:
            b[i] += 1
            return base64.b64encode(bytes(b[: i + 1])).decode()
        del b[i]
    return base64.b64encode(b"\x00").decode()  # whole keyspace


class EtcdDiscoveryService(DiscoveryService):
    def __init__(self, address: str, service_name: str, ttl_s: float = 5.0) -> None:
        super().__init__()
        self.base = (address or "http://127.0.0.1:2379").rstrip("/")
        self.prefix = f"/service/{service_name}/"
        self.ttl_s = max(ttl_s, 1.0)
        # one leased key a register() call
        self._self_keys: list[str] = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._watching = False
        self._watch_conn: http.client.HTTPConnection | None = None
        self._nodes: dict[str, NodeInfo] = {}  # key -> node (watch thread only)

    def _post(self, path: str, body: dict) -> dict:
        status, raw = http_request("POST", f"{self.base}{path}", body, REQUEST_TIMEOUT_S)
        text = raw.decode(errors="replace")
        if status != 200:
            raise ConnectionError(f"etcd {path} failed: HTTP {status}: {text}")
        return json.loads(text)

    def _spawn(self, target, *args) -> None:
        t = threading.Thread(target=target, args=args, name="tpusc-discovery-etcd", daemon=True)
        self._threads.append(t)
        t.start()

    def register(self, self_node: NodeInfo, is_healthy: Callable[[], bool]) -> None:
        key = f"{self.prefix}{uuid.uuid4().hex}"
        self._self_keys.append(key)
        self._stop.clear()
        self._heartbeat_once(key, self_node.ident)  # fail fast if etcd is down
        self._spawn(self._heartbeat_loop, key, self_node, is_healthy)
        if not self._watching:
            self._watching = True
            self._spawn(self._watch_loop)
        log.info("registered %s in etcd at %s", key, self.base)

    def _heartbeat_once(self, key: str, ident: str) -> None:
        lease = self._post("/v3/lease/grant", {"TTL": int(self.ttl_s)})
        self._post("/v3/kv/put", {"key": _b64(key), "value": _b64(ident),
                                  "lease": lease.get("ID")})

    def _heartbeat_loop(self, key: str, self_node: NodeInfo,
                        is_healthy: Callable[[], bool]) -> None:
        while not self._stop.wait(self.ttl_s / 2):
            if not is_healthy():
                log.warning("skipping etcd heartbeat: node unhealthy")
                continue
            try:
                self._heartbeat_once(key, self_node.ident)
            except (OSError, ValueError) as e:
                # ValueError: a gateway answering 200 with a non-JSON body
                log.warning("etcd heartbeat failed: %s", e)

    # -- membership ---------------------------------------------------------
    def _load_initial(self) -> None:
        data = self._post("/v3/kv/range", {"key": _b64(self.prefix),
                                           "range_end": prefix_range_end(self.prefix)})
        self._nodes.clear()
        for kv in data.get("kvs", []) or []:
            self._accept(_unb64(kv["key"]), _unb64(kv["value"]))
        self._publish(list(self._nodes.values()))

    def _accept(self, key: str, value: str) -> None:
        try:
            self._nodes[key] = NodeInfo.from_ident(value)
        except ValueError:
            log.warning("bad node ident under %s: %r", key, value)

    def _watch_loop(self) -> None:
        body = json.dumps({"create_request": {
            "key": _b64(self.prefix), "range_end": prefix_range_end(self.prefix)}}).encode()
        while not self._stop.is_set():
            try:
                self._load_initial()
                conn, resp = open_stream("POST", f"{self.base}/v3/watch", body, WATCH_IDLE_S,
                                         {"Content-Type": "application/json"})
                self._watch_conn = conn
                try:
                    if self._stop.is_set():
                        return
                    if resp.status != 200:
                        raise ConnectionError(f"watch HTTP {resp.status}")
                    for line in iter_lines(resp):
                        msg = json.loads(line)
                        self._apply_watch_events(msg.get("result", msg))
                finally:
                    self._watch_conn = None
                    conn.close()
            except (OSError, http.client.HTTPException, ValueError) as e:
                if self._stop.is_set():
                    break
                log.warning("etcd watch interrupted: %s; reconnecting", e)
                self._stop.wait(min(self.ttl_s, 2.0))

    def _apply_watch_events(self, result: dict) -> None:
        changed = False
        for ev in result.get("events", []) or []:
            kv = ev.get("kv", {})
            key = _unb64(kv.get("key", ""))
            if ev.get("type") == "DELETE":
                changed |= self._nodes.pop(key, None) is not None
            else:  # PUT covers create + modify
                self._accept(key, _unb64(kv.get("value", "")))
                changed = True
        if changed:
            self._publish(list(self._nodes.values()))

    def unregister(self) -> None:
        self._stop.set()
        close_stream(self._watch_conn)
        for t in self._threads:
            t.join(timeout=REQUEST_TIMEOUT_S)
        self._threads.clear()
        self._watching = False
        for key in self._self_keys:
            try:
                self._post("/v3/kv/deleterange", {"key": _b64(key)})
            except (OSError, ValueError) as e:
                log.warning("etcd deregister failed: %s", e)
        self._self_keys.clear()
