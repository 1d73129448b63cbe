"""Router: the front door that sends each (model, version) to the ring
owner(s) of its ``name##version`` key (counterpart of
``tfservingcache_tpu/cluster/router.py``).

``RoutingBackend`` is a ``ServingBackend`` behind the router's REST and
gRPC servers:

  - a ``/labels/<label>`` URL or a ``version_label`` spec resolves through
    ``serving.version_labels`` before the ring lookup (412 unmapped);
  - ``_candidates`` orders the key's replica set: two replicas sampled, the
    one with fewer requests in flight leads; equal loads go to the warmer
    (the local probe for this host's group, the ``FleetView``'s
    advertisements for a peer); with a ``FleetView``, a pair of which only
    one scores below ``health_threshold`` is led by the healthy one (soft
    route-around). A ``:generate`` body's ``conversation_id`` pins the
    lead by crc32 instead, so a conversation's turns find their parked KV;
  - a key this host's group owns runs in-process (the local short-circuit);
    any other goes to the peer over REST (a keep-alive connection pool a
    peer) or gRPC (a channel a peer, pruned on membership change), with a
    ``traceparent`` and the status-want marker; the peer's trace subtree is
    grafted under the ``route`` span and its status fed to the FleetView;
  - only connection failures move on to the next replica (``retries`` + 1
    tries); when every try failed, REST answers 503 ``all replicas
    unreachable`` and gRPC the last peer error;
  - ``?stream=true`` through a forwarded hop is drained and relayed
    buffered (a live relay is the local short-circuit's);
  - ``reload_config`` answers UNIMPLEMENTED (the cache nodes serve it).

``Router`` connects the node to discovery, serves the proxy REST and gRPC
ports (``proxy.rest_port`` / ``proxy.grpc_port``, 0 = ephemeral), and runs
the fleet status exchange, the replica controller and the assignment warmer
on threads. The router does no device work.

With ``cluster.peer_fetch`` and the status exchange on, the router arms
its node's ``PeerProvider`` with the fleet view and the ring's members: a
cold miss on the node streams the model from a peer that holds it in its
host tier or on its device (``FetchPackedModel``) before it asks the store.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
import zlib
from collections.abc import Callable, Mapping
from urllib.parse import urlencode

from tfservingcache_tpu_torch.cache.manager import VersionLabelError, resolve_version_label
from tfservingcache_tpu_torch.cluster.cluster import ClusterConnection
from tfservingcache_tpu_torch.cluster.discovery import create_discovery
from tfservingcache_tpu_torch.cluster.status import (
    STATUS_HEADER,
    STATUS_TRAILER,
    STATUS_WANT_HEADER,
    STATUS_WANT_METADATA,
    FleetView,
    StatusExchange,
)
from tfservingcache_tpu_torch.config import Config
from tfservingcache_tpu_torch.protocol.backend import (
    MODEL_SERVICE,
    PREDICTION_SERVICE,
    SESSION_SERVICE,
    TRACE_SUBTREE_TRAILER,
    BackendError,
    RestResponse,
    ServingBackend,
)
from tfservingcache_tpu_torch.protocol.rest import TRACE_SUBTREE_HEADER, RestServingServer
from tfservingcache_tpu_torch.types import ModelId, NodeInfo
from tfservingcache_tpu_torch.utils.net import outbound_ip
from tfservingcache_tpu_torch.utils.tracing import TRACER, format_traceparent

log = logging.getLogger("tpusc_torch.router")

HTTP_POOL_LIMIT_PER_HOST = 32   # idle keep-alive connections kept a peer
FORWARD_TIMEOUT_S = 300.0       # a forwarded call's deadline (aiohttp's default total)


class PeerPool:
    """A gRPC channel a peer, made at first use."""

    def __init__(self, max_message_bytes: int) -> None:
        self._stubs: dict[str, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._max_message_bytes = max_message_bytes

    def stub(self, node: NodeInfo):
        from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel

        key = f"{node.host}:{node.grpc_port}"
        with self._lock:
            if key not in self._stubs:
                self._stubs[key] = ServingStub(make_channel(key, self._max_message_bytes))
            return self._stubs[key]

    def prune(self, live: list[NodeInfo]) -> None:
        """Close the channels of peers that left the cluster."""
        keep = {f"{n.host}:{n.grpc_port}" for n in live}
        with self._lock:
            gone = [self._stubs.pop(k) for k in [k for k in self._stubs if k not in keep]]
        for stub in gone:
            stub.channel.close()

    def close(self) -> None:
        with self._lock:
            stubs, self._stubs = list(self._stubs.values()), {}
        for stub in stubs:
            stub.channel.close()


class HttpPool:
    """Keep-alive HTTP connections a peer (at most
    ``HTTP_POOL_LIMIT_PER_HOST`` idle each): a forwarded hot path pays one
    TCP handshake a peer, not one a request."""

    def __init__(self, timeout_s: float = FORWARD_TIMEOUT_S) -> None:
        self.timeout_s = timeout_s
        self._idle: dict[tuple[str, int], list[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()

    def request(self, host: str, port: int, method: str, path: str, body: bytes | None,
                headers: dict[str, str]) -> tuple[int, bytes, http.client.HTTPMessage]:
        """-> (status, body, headers). A pooled connection the peer closed
        while idle is retried once on a new one; any other failure raises
        (OSError or ``http.client.HTTPException``)."""
        key = (host, port)
        with self._lock:
            idle = self._idle.get(key)
            conn = idle.pop() if idle else None
        reused = conn is not None
        while True:
            if conn is None:
                conn = http.client.HTTPConnection(host, port, timeout=self.timeout_s)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
            except (ConnectionError, http.client.RemoteDisconnected) as e:
                conn.close()
                conn = None
                if reused and not isinstance(e, ConnectionRefusedError):
                    reused = False
                    continue  # a stale keep-alive connection: one fresh try
                raise
            except BaseException:
                conn.close()
                raise
            break
        if resp.will_close:
            conn.close()
        else:
            with self._lock:
                idle = self._idle.setdefault(key, [])
                if len(idle) < HTTP_POOL_LIMIT_PER_HOST:
                    idle.append(conn)
                    conn = None
            if conn is not None:
                conn.close()
        return resp.status, payload, resp.headers

    def close(self) -> None:
        with self._lock:
            conns = [c for idle in self._idle.values() for c in idle]
            self._idle.clear()
        for c in conns:
            c.close()


def _is_conn_failure(e: Exception) -> bool:
    import grpc

    return e.code() in (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED)


class RoutingBackend(ServingBackend):
    """Forwards each request to a ring owner of its key, or serves it on
    this host's group when the group owns it. ``local_backends`` maps a
    ring ident to the in-process backend of a group this host serves."""

    def __init__(
        self,
        cluster: ClusterConnection,
        local_backends: Mapping[str, ServingBackend] | None = None,
        max_message_bytes: int = 16 << 20,
        retries: int = 2,
        version_labels: Mapping[str, Mapping[str, int]] | None = None,
        local_warmth: Mapping[str, Callable[[ModelId], int]] | None = None,
        fleet: FleetView | None = None,
    ) -> None:
        self.cluster = cluster
        self.local_backends: dict[str, ServingBackend] = dict(local_backends or {})
        # ident -> CacheManager.residency_warmth of this host's groups
        self.local_warmth: dict[str, Callable[[ModelId], int]] = dict(local_warmth or {})
        self.fleet = fleet
        self.pool = PeerPool(max_message_bytes)
        self.http = HttpPool()
        self.retries = retries
        self.version_labels = dict(version_labels or {})
        # in-flight requests a ring ident, for power-of-two choices
        self._inflight: dict[str, int] = {}  # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        # the replica controller (cluster/replication.py), when attached
        self.demand = None
        cluster.on_update.append(self.pool.prune)

    def _resolve_label(self, name: str, label: str) -> int:
        try:
            return resolve_version_label(self.version_labels, name, label)
        except VersionLabelError as e:
            raise BackendError(str(e), 412, "FAILED_PRECONDITION") from e

    def _spec_version(self, spec) -> int:
        """A ModelSpec's routing version: a label resolves (412 unmapped)."""
        if spec.WhichOneof("version_choice") == "version_label":
            return self._resolve_label(spec.name, spec.version_label)
        return spec.version.value

    # -- routing core -------------------------------------------------------
    def _inflight_inc(self, ident: str) -> None:
        with self._inflight_lock:
            self._inflight[ident] = self._inflight.get(ident, 0) + 1

    def _inflight_dec(self, ident: str) -> None:
        with self._inflight_lock:
            n = self._inflight.get(ident, 0) - 1
            if n <= 0:
                self._inflight.pop(ident, None)
            else:
                self._inflight[ident] = n

    def _candidates(self, name: str, version: int | str | None,
                    affinity: str | None = None) -> list[NodeInfo]:
        """The replica set in try order: affinity's crc32 pick, else the
        healthy one of a sampled pair whose health splits at the threshold,
        else the less loaded of the pair, ties to the warmer; the rest of
        the ring order follows as the failover rotation."""
        mid = ModelId(name, int(version or 0))
        key = mid.key
        nodes = self.cluster.find_nodes_for_key(key)
        if not nodes:
            raise BackendError("no serving nodes in cluster", 503, "UNAVAILABLE")
        if len(nodes) < 2:
            return nodes
        if affinity is not None:
            # crc32, never the salted hash(): every router picks the same
            start = zlib.crc32(f"{key}|{affinity}".encode()) % len(nodes)
            return nodes[start:] + nodes[:start]
        i, j = random.sample(range(len(nodes)), 2)
        if self.fleet is not None:
            thr = self.fleet.health_threshold
            h_i, h_j = self._health(nodes[i].ident), self._health(nodes[j].ident)
            if (h_i < thr) != (h_j < thr):
                start = i if h_i >= h_j else j
                return nodes[start:] + nodes[:start]
        with self._inflight_lock:
            load_i = self._inflight.get(nodes[i].ident, 0)
            load_j = self._inflight.get(nodes[j].ident, 0)
        if load_i == load_j and (self.local_warmth or self.fleet is not None):
            start = i if self._warmth(nodes[i].ident, mid) >= self._warmth(
                nodes[j].ident, mid) else j
        else:
            start = i if load_i <= load_j else j
        return nodes[start:] + nodes[:start]

    def _warmth(self, ident: str, model_id: ModelId) -> int:
        fn = self.local_warmth.get(ident)
        if fn is not None:
            try:
                return int(fn(model_id))
            except Exception:  # noqa: BLE001 - advisory, never fail routing
                return 0
        if self.fleet is not None:
            return self.fleet.warmth(ident, model_id.key)
        return 0

    def _health(self, ident: str) -> float:
        """A peer's routing health; this host's groups are always 1.0."""
        if self.fleet is None or ident in self.local_backends:
            return 1.0
        return self.fleet.health(ident)

    def _note_forward(self, ident: str, ok: bool, latency_s: float | None) -> None:
        if self.fleet is not None:
            self.fleet.note_forward(ident, ok, latency_s)

    def _demand(self, name: str, version, fn):
        if self.demand is None:
            return fn()
        key = ModelId(name, int(version or 0)).key
        self.demand.note_start(key)
        try:
            return fn()
        finally:
            self.demand.note_end(key)

    # -- gRPC forwarding ----------------------------------------------------
    def _forward_grpc(self, service: str, method: str, name: str, version, request):
        return self._demand(name, version, lambda: self._forward_grpc_inner(
            service, method, name, version, request))

    def _forward_grpc_inner(self, service: str, method: str, name: str, version, request):
        # a gRPC request got here, so grpcio imports (REST routing needs none)
        import grpc

        last_err: Exception | None = None
        for attempt, node in enumerate(self._candidates(name, version)[: self.retries + 1]):
            local = self.local_backends.get(node.ident)
            if local is not None:
                fn = {
                    (PREDICTION_SERVICE, "Predict"): local.predict,
                    (PREDICTION_SERVICE, "Classify"): local.classify,
                    (PREDICTION_SERVICE, "Regress"): local.regress,
                    (PREDICTION_SERVICE, "GetModelMetadata"): local.get_model_metadata,
                    (MODEL_SERVICE, "GetModelStatus"): local.get_model_status,
                    (SESSION_SERVICE, "SessionRun"): local.session_run,
                }[(service, method)]
                TRACER.annotate_root(route="local")
                self._inflight_inc(node.ident)
                try:
                    return fn(request)
                finally:
                    self._inflight_dec(node.ident)
            with TRACER.span("route", peer=node.ident, protocol="grpc",
                             method=method) as route_sp:
                TRACER.annotate_root(route="forwarded")
                self._inflight_inc(node.ident)
                t0 = time.monotonic()
                try:
                    stub = self.pool.stub(node)
                    metadata = []
                    tp = format_traceparent(route_sp)
                    if tp:
                        metadata.append(("traceparent", tp))
                    if self.fleet is not None:
                        metadata.append((STATUS_WANT_METADATA, "1"))
                    resp, call = stub.method(service, method).with_call(
                        request, metadata=tuple(metadata) or None, timeout=FORWARD_TIMEOUT_S)
                    self._note_forward(node.ident, True, time.monotonic() - t0)
                    self._consume_trailers(call, route_sp, node)
                    return resp
                except grpc.RpcError as e:
                    conn_failure = _is_conn_failure(e)
                    # an application error reached a live peer: it proves
                    # health; only a connection failure scores against it
                    self._note_forward(node.ident, not conn_failure,
                                       None if conn_failure else time.monotonic() - t0)
                    self._consume_trailers(e, route_sp, node)
                    if not conn_failure:
                        raise
                    last_err = e
                    log.warning("peer %s unavailable for %s/%s (attempt %d): %s",
                                node.ident, service, method, attempt + 1, e.details())
                finally:
                    self._inflight_dec(node.ident)
        assert last_err is not None
        raise last_err

    def _consume_trailers(self, call, route_sp, node: NodeInfo) -> None:
        """Graft the peer's trace subtree and ingest its status (both in
        the trailing metadata); neither may fail the request."""
        try:
            trailers = call.trailing_metadata()
        except Exception:  # noqa: BLE001 - a dead channel has no trailers
            return
        for key, value in trailers or ():
            if key == TRACE_SUBTREE_TRAILER:
                TRACER.attach_remote(route_sp, value, peer=node.ident)
            elif key == STATUS_TRAILER and self.fleet is not None:
                self.fleet.ingest_encoded(value)

    # -- ServingBackend (gRPC shapes) ---------------------------------------
    def predict(self, request):
        spec = request.model_spec
        return self._forward_grpc(PREDICTION_SERVICE, "Predict", spec.name,
                                  self._spec_version(spec), request)

    def classify(self, request):
        spec = request.model_spec
        return self._forward_grpc(PREDICTION_SERVICE, "Classify", spec.name,
                                  self._spec_version(spec), request)

    def regress(self, request):
        spec = request.model_spec
        return self._forward_grpc(PREDICTION_SERVICE, "Regress", spec.name,
                                  self._spec_version(spec), request)

    def get_model_metadata(self, request):
        spec = request.model_spec
        return self._forward_grpc(PREDICTION_SERVICE, "GetModelMetadata", spec.name,
                                  self._spec_version(spec), request)

    def session_run(self, request):
        spec = request.model_spec
        return self._forward_grpc(SESSION_SERVICE, "SessionRun", spec.name,
                                  self._spec_version(spec), request)

    def get_model_status(self, request):
        spec = request.model_spec
        return self._forward_grpc(MODEL_SERVICE, "GetModelStatus", spec.name,
                                  self._spec_version(spec), request)

    def reload_config(self, request):
        raise BackendError("reload_config is served by cache nodes, not the router", 501,
                           "UNIMPLEMENTED")

    # -- REST forwarding ----------------------------------------------------
    def handle_rest(self, method: str, model_name: str, version: int | None, verb: str | None,
                    body: bytes, label: str | None = None,
                    query: dict[str, str] | None = None) -> RestResponse:
        if label is not None:
            version = self._resolve_label(model_name, label)  # before the ring lookup
        return self._demand(model_name, version, lambda: self._handle_rest_inner(
            method, model_name, version, verb, body, query))

    @staticmethod
    def _conversation_affinity(verb: str | None, body: bytes) -> str | None:
        """A ``:generate`` body's conversation_id (a byte probe first, so
        other traffic parses nothing; a malformed body routes normally)."""
        if verb != "generate" or not body or b"conversation_id" not in body:
            return None
        try:
            cid = json.loads(body).get("conversation_id")
        except Exception:  # noqa: BLE001 - the serving node owns the 400
            return None
        return cid if isinstance(cid, str) and cid else None

    def _handle_rest_inner(self, method: str, model_name: str, version: int | None,
                           verb: str | None, body: bytes,
                           query: dict[str, str] | None = None) -> RestResponse:
        last_err: Exception | None = None
        affinity = self._conversation_affinity(verb, body)
        for node in self._candidates(model_name, version, affinity=affinity)[: self.retries + 1]:
            local = self.local_backends.get(node.ident)
            if local is not None:
                TRACER.annotate_root(route="local")
                self._inflight_inc(node.ident)
                try:
                    return local.handle_rest(method, model_name, version, verb, body,
                                             query=query)
                finally:
                    self._inflight_dec(node.ident)
            path = f"/v1/models/{model_name}"
            if version is not None:
                path += f"/versions/{version}"
            if verb == "metadata":
                path += "/metadata"
            elif verb is not None:
                path += f":{verb}"
            if query:
                path += "?" + urlencode(query)
            with TRACER.span("route", peer=node.ident, protocol="rest",
                             verb=verb or "status") as route_sp:
                TRACER.annotate_root(route="forwarded")
                headers = {"Content-Type": "application/json"}
                tp = format_traceparent(route_sp)
                if tp:
                    headers["traceparent"] = tp
                if self.fleet is not None:
                    headers[STATUS_WANT_HEADER] = "1"
                self._inflight_inc(node.ident)
                t0 = time.monotonic()
                try:
                    # a streamed answer is read whole here and relayed buffered
                    status, payload, resp_headers = self.http.request(
                        node.host, node.rest_port, method, path, body or None, headers)
                except (OSError, http.client.HTTPException) as e:
                    self._note_forward(node.ident, False, None)
                    last_err = e
                    log.warning("peer %s unreachable for REST %s: %s", node.ident, path, e)
                    continue
                finally:
                    self._inflight_dec(node.ident)
                # an HTTP error (404, 412 ...) reached a live peer
                self._note_forward(node.ident, True, time.monotonic() - t0)
                subtree = resp_headers.get(TRACE_SUBTREE_HEADER)
                if subtree:
                    TRACER.attach_remote(route_sp, subtree, peer=node.ident)
                if self.fleet is not None:
                    blob = resp_headers.get(STATUS_HEADER)
                    if blob:
                        self.fleet.ingest_encoded(blob)
                ctype = (resp_headers.get("Content-Type") or "application/json")
                return RestResponse(status=status, body=payload,
                                    content_type=ctype.split(";")[0].strip())
        raise BackendError(f"all replicas unreachable: {last_err}", 503, "UNAVAILABLE")

    def close(self) -> None:
        self.pool.close()
        self.http.close()


def _grpc_server_class():
    try:
        from tfservingcache_tpu_torch.protocol.grpc_server import GrpcServingServer
    except ImportError as e:
        log.warning("router gRPC port off: package %r is not installed; routing REST only",
                    e.name or str(e))
        return None
    return GrpcServingServer


class Router:
    """The proxy REST + gRPC pair on the proxy ports, connected to
    discovery. Build it after ``node.start()`` (it reads the bound ports)
    and close it before the node."""

    def __init__(self, cfg: Config, node) -> None:
        self.cfg = cfg
        self.node = node  # CacheNode (the local short-circuit, health)
        self.discovery = create_discovery(cfg.discovery)
        self.cluster = ClusterConnection(self.discovery, cfg.proxy.replicas_per_model)
        host = "127.0.0.1" if cfg.discovery.prefer_localhost else outbound_ip()
        groups = list(node.groups) if node is not None else []
        # one ring member a local group; a node without gRPC advertises 0
        self.self_nodes = [NodeInfo(host, g.rest_port or cfg.cache_node.rest_port + g.index,
                                    g.grpc_port or 0) for g in groups]
        if node is None:
            self.self_nodes = [NodeInfo(host, cfg.cache_node.rest_port,
                                        cfg.cache_node.grpc_port)]
        pairs = list(zip(self.self_nodes, groups))
        metrics = node.metrics if node is not None else None
        self.fleet: FleetView | None = None
        self.status_exchange: StatusExchange | None = None
        if cfg.cluster.status_exchange:
            self.fleet = FleetView(
                metrics=metrics,
                stale_after_s=cfg.cluster.status_stale_after_s,
                health_threshold=cfg.cluster.health_threshold,
                error_alpha=cfg.cluster.health_error_alpha,
                latency_ref_s=cfg.cluster.health_latency_ref_s,
            )
            local_collectors = {}
            for n, g in pairs:
                if g.status is not None:
                    g.status.ident = n.ident  # the ring ident peers see
                    local_collectors[n.ident] = g.status
            self.status_exchange = StatusExchange(
                self.fleet, local_collectors, poll_interval_s=cfg.cluster.status_poll_interval_s)
            self.cluster.on_update.append(self.status_exchange.on_update)
            self.cluster.on_update.append(self.fleet.prune)
        self.backend = RoutingBackend(
            self.cluster,
            {n.ident: g.backend for n, g in pairs},
            cfg.proxy.grpc_max_message_bytes,
            version_labels=cfg.serving.version_labels,
            local_warmth={n.ident: g.manager.residency_warmth for n, g in pairs},
            fleet=self.fleet,
        )
        self.replicas = None
        if cfg.cluster.max_replicas_per_model > 0:
            from tfservingcache_tpu_torch.cluster.replication import ReplicaController

            self.replicas = ReplicaController(
                self.cluster,
                base_replicas=cfg.proxy.replicas_per_model,
                max_replicas=cfg.cluster.max_replicas_per_model,
                load_target=cfg.cluster.replica_load_target,
                decay_ticks=cfg.cluster.replica_decay_ticks,
                interval_s=cfg.cluster.replica_eval_interval_s,
                metrics=metrics,
                local_managers={n.ident: g.manager for n, g in pairs},
            )
            self.cluster.replicas_for_key = self.replicas.replicas_for
            self.backend.demand = self.replicas
        # arm the node's PeerProvider (cache/providers/peer.py): the fleet's
        # warmth map and the ring's members turn cold misses into peer streams
        if node is not None and self.fleet is not None:
            provider = getattr(node.manager, "provider", None)
            if provider is not None and hasattr(provider, "bind_fleet"):
                provider.bind_fleet(self.fleet, self.cluster,
                                    {n.ident for n in self.self_nodes})
                self.cluster.on_update.append(provider.prune)
        self.rest = RestServingServer(self.backend, metrics, metrics_path=cfg.metrics.path,
                                      require_version=True)
        self.rest.fleet = self.fleet  # /monitoring/cluster on the router's REST port
        grpc_cls = _grpc_server_class()
        self.grpc = (grpc_cls(self.backend, metrics, cfg.proxy.grpc_max_message_bytes)
                     if grpc_cls is not None else None)
        self.warmer = None
        if node is not None and cfg.proxy.warm_on_assignment:
            from tfservingcache_tpu_torch.cluster.warmer import AssignmentWarmer

            self.warmer = AssignmentWarmer(self.cluster, [(n.ident, g.manager) for n, g in pairs],
                                           metrics=metrics)
            self.cluster.on_update.append(self.warmer.on_update)
        self.rest_port: int | None = None
        self.grpc_port: int | None = None
        self._stop_health = threading.Event()
        self._health_thread: threading.Thread | None = None

    def start(self, host: str = "0.0.0.0") -> tuple[int, int | None]:
        """Join the cluster and bind the proxy ports -> (REST port, gRPC
        port or None)."""
        if self.node is not None:
            entries = [(n, g.manager.is_healthy) for n, g in zip(self.self_nodes,
                                                                  self.node.groups)]
        else:
            entries = list(self.self_nodes)
        self.cluster.connect(entries, lambda: True)
        self.rest_port = self.rest.start(self.cfg.proxy.rest_port, host)
        if self.grpc is not None:
            self.grpc_port = self.grpc.start(self.cfg.proxy.grpc_port, host)
            self.grpc.set_health(self.cluster.node_count > 0)
            self._health_thread = threading.Thread(target=self._health_loop,
                                                   name="tpusc-router-health", daemon=True)
            self._health_thread.start()
        if self.status_exchange is not None:
            self.status_exchange.start()
        if self.replicas is not None:
            self.replicas.start()
        log.info("router up: REST :%d gRPC %s as %s (%d ring members)", self.rest_port,
                 f":{self.grpc_port}" if self.grpc_port is not None else "off",
                 ",".join(n.ident for n in self.self_nodes), self.cluster.node_count)
        return self.rest_port, self.grpc_port

    def _health_loop(self) -> None:
        from tfservingcache_tpu_torch.server import HEALTH_LOOP_PERIOD_S

        while not self._stop_health.wait(HEALTH_LOOP_PERIOD_S):
            self.grpc.set_health(self.cluster.node_count > 0)

    def close(self) -> None:
        """Stop every thread and server the router started (before the
        node closes)."""
        self._stop_health.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=10.0)
            self._health_thread = None
        if self.replicas is not None:
            self.replicas.close()
        if self.warmer is not None:
            self.warmer.close()
        if self.status_exchange is not None:
            self.status_exchange.close()
        self.cluster.disconnect()
        self.rest.close()
        if self.grpc is not None:
            self.grpc.close()
        self.backend.close()
