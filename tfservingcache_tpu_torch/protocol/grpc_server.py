"""gRPC server for the tensorflow.serving protocol (counterpart of
``tfservingcache_tpu/protocol/grpc_server.py``), on grpc's threaded server so
that, like the port's REST server, it needs no event loop: each RPC runs on
a worker thread of the server's pool.

Services are registered through generic method handlers from one method
table (no generated stubs; the wire is the stubs' wire):
PredictionService (Predict, Classify, Regress, MultiInference, which answers
UNIMPLEMENTED as the reference does, GetModelMetadata, and the
server-streaming GenerateStream), ModelService (GetModelStatus,
HandleReloadConfigRequest), SessionService (SessionRun) and grpc.health.v1
(Check, Watch). Any other method answers UNIMPLEMENTED through a counted
fallback, so the request counters see what REST's see (health is exempt on
both).

Every RPC is counted, timed and in-flight-gauged under ``protocol="grpc"``
and runs in a ``grpc`` span that adopts an inbound ``traceparent``; such a
call gets its finished span subtree back in the ``tpusc-trace`` trailer.
Every GenerateStream frame counts in ``tpusc_gen_stream_frames{grpc}``.
A unary call carrying the ``tpusc-status-want`` metadata gets the node's
``NodeStatus`` in the ``tpusc-status`` trailer (``status_collector``, the
fleet status plane). A router's backend that forwards a call re-raises the
peer's ``grpc.RpcError``: its code and details reach the client as they are.

With a peer source attached (``peer_source``, a ``PeerSource`` over the
runtime's host tier), ``tpusc.internal.PeerTransfer/FetchPackedModel``
streams a model's packed entry to a cold peer, pinned for the stream and
capped in flight a requesting host; with a conversation tier attached
(``conversation_tier``, the continuous engine's),
``FetchParkedConversation`` streams a parked conversation to the node that
asks for it (``protocol/peer_transfer.py``). Neither lookup touches its
tier's LRU order, and what the tier does not hold answers NOT_FOUND.

The server binds with ``grpc.so_reuseport`` off, so a port another server
holds raises at ``start`` (ROADMAP C10; the reference binds with the
default, under which Linux spreads connections over every server on the
port). Needs ``grpcio`` and ``protobuf``; ``server.build_node`` starts it
only when they import.
"""

from __future__ import annotations

import logging
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

import grpc

from tfservingcache_tpu_torch.cluster.status import STATUS_TRAILER, STATUS_WANT_METADATA
from tfservingcache_tpu_torch.protocol.backend import (
    MODEL_SERVICE,
    PREDICTION_SERVICE,
    SESSION_SERVICE,
    TRACE_SUBTREE_TRAILER,
    BackendError,
)
from tfservingcache_tpu_torch.protocol.protos import grpc_health_pb2 as health_pb
from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv
from tfservingcache_tpu_torch.utils.metrics import Metrics
from tfservingcache_tpu_torch.utils.tracing import (
    TRACER,
    parse_traceparent,
    remote_parent,
    serialize_span,
)

log = logging.getLogger("tpusc_torch.grpc")

HEALTH_SERVICE = "grpc.health.v1.Health"

# (service, method) -> (request class, response class), shared by the server
# and the client (protocol/grpc_client.py)
METHOD_TABLE: dict[tuple[str, str], tuple[type, type]] = {
    (PREDICTION_SERVICE, "Predict"): (sv.PredictRequest, sv.PredictResponse),
    (PREDICTION_SERVICE, "Classify"): (sv.ClassificationRequest, sv.ClassificationResponse),
    (PREDICTION_SERVICE, "Regress"): (sv.RegressionRequest, sv.RegressionResponse),
    (PREDICTION_SERVICE, "MultiInference"): (sv.MultiInferenceRequest, sv.MultiInferenceResponse),
    (PREDICTION_SERVICE, "GetModelMetadata"): (
        sv.GetModelMetadataRequest,
        sv.GetModelMetadataResponse,
    ),
    (MODEL_SERVICE, "GetModelStatus"): (sv.GetModelStatusRequest, sv.GetModelStatusResponse),
    (MODEL_SERVICE, "HandleReloadConfigRequest"): (sv.ReloadConfigRequest, sv.ReloadConfigResponse),
    (SESSION_SERVICE, "SessionRun"): (sv.SessionRunRequest, sv.SessionRunResponse),
}

# a Watch stream re-checks its call and the server this often while the
# status stands still
_WATCH_POLL_S = 0.5


class HealthState:
    """grpc.health.v1 state: one overall status on the empty service name,
    NOT_SERVING until the node sets it (reference grpc_server.py:58-82).
    ``wait_change`` wakes on a change or on ``close``."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._status = health_pb.HealthCheckResponse.NOT_SERVING
        self._version = 0  # guarded-by: _cv
        self.closed = False

    def set_health(self, healthy: bool) -> None:
        with self._cv:
            self._status = (health_pb.HealthCheckResponse.SERVING if healthy
                            else health_pb.HealthCheckResponse.NOT_SERVING)
            self._version += 1
            self._cv.notify_all()

    @property
    def status(self) -> int:
        return self._status

    def version(self) -> int:
        with self._cv:
            return self._version

    def wait_change(self, seen: int, timeout: float) -> int:
        """Block until the status changes after version ``seen``, the state
        closes, or ``timeout``; -> the version now."""
        with self._cv:
            self._cv.wait_for(lambda: self._version != seen or self.closed, timeout)
            return self._version

    def close(self) -> None:
        with self._cv:
            self.closed = True
            self._cv.notify_all()


class _UnknownMethodHandler(grpc.GenericRpcHandler):
    """The last generic handler: an RPC that no service claimed (an unknown
    method, or an unknown service) answers UNIMPLEMENTED through the
    server's counting path; health stays exempt."""

    def __init__(self, unknown_method) -> None:
        self._handler = grpc.unary_unary_rpc_method_handler(
            unknown_method,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b if isinstance(b, bytes) else b"",
        )

    def service(self, handler_call_details):
        if handler_call_details.method.startswith(f"/{HEALTH_SERVICE}/"):
            return None
        return self._handler


def peer_host(peer: str | None) -> str:
    """The host of a ``context.peer()`` string, without its port:
    ``ipv4:10.0.0.2:5555`` -> ``10.0.0.2``, ``ipv6:[::1]:5555`` (or grpc's
    percent-encoded ``ipv6:%5B::1%5D:5555``) -> ``::1``."""
    addr = urllib.parse.unquote((peer or "?").split(":", 1)[-1])
    if addr.startswith("["):
        return addr[1:addr.find("]")] if "]" in addr else addr
    return addr.rsplit(":", 1)[0] if addr.count(":") == 1 else addr


def _status_code(err: BackendError) -> grpc.StatusCode:
    return getattr(grpc.StatusCode, err.grpc_code, grpc.StatusCode.INTERNAL)


class GrpcServingServer:
    def __init__(
        self,
        backend,
        metrics: Metrics | None = None,
        max_message_bytes: int = 16 << 20,
        max_workers: int = 16,
    ) -> None:
        self.backend = backend
        self.metrics = metrics
        self.health = HealthState()
        self._max_message_bytes = max_message_bytes
        self._max_workers = max_workers
        self.server: grpc.Server | None = None
        self._pool: ThreadPoolExecutor | None = None
        self.port: int | None = None
        # attached by the node before start: the fleet status plane's
        # collector (the tpusc-status trailer) and the engine's
        # conversation tier (FetchParkedConversation)
        self.status_collector = None
        self.conversation_tier = None
        # the host tier's outbound side (peer_transfer.PeerSource):
        # FetchPackedModel
        self.peer_source = None

    # -- handler plumbing ---------------------------------------------------
    def _observe(self, verb: str, t0: float, err, sp) -> None:
        m = self.metrics
        if m is None:
            return
        m.requests_in_flight.labels("grpc").dec()
        if err is not None:
            m.request_failures.labels("grpc").inc()
        route = (sp.attrs.get("route") if sp is not None else None) or "local"
        m.request_duration.labels("grpc", verb, "ok" if err is None else "error",
                                  route).observe(time.monotonic() - t0)

    def _enter(self, context) -> tuple[float, object, bool]:
        """Count the call; -> (start, inbound trace context, whether the
        caller wants this node's status)."""
        if self.metrics is not None:
            self.metrics.request_count.labels("grpc").inc()
            self.metrics.requests_in_flight.labels("grpc").inc()
        remote_ctx = None
        want_status = False
        for key, value in context.invocation_metadata() or ():
            if key == "traceparent":
                remote_ctx = parse_traceparent(value)
            elif key == STATUS_WANT_METADATA:
                want_status = True
        return time.monotonic(), remote_ctx, want_status

    def _unary(self, fn, req_cls, resp_cls):
        verb = fn.__name__.lower().lstrip("_")  # predict / classify / ...

        def handler(request, context: grpc.ServicerContext):
            t0, remote_ctx, want_status = self._enter(context)
            sp = err = resp = None
            try:
                with remote_parent(remote_ctx), TRACER.span("grpc", method=fn.__name__) as sp:
                    resp = fn(request)
            except BackendError as e:
                err = (_status_code(e), str(e))
            except grpc.RpcError as e:
                # a forwarded call's failure: the peer's code, verbatim
                err = (e.code(), e.details() or "upstream error")
            except Exception as e:  # noqa: BLE001 - a server answers INTERNAL, keeps serving
                log.exception("unhandled error in %s", fn.__name__)
                err = (grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
            finally:
                self._observe(verb, t0, err, sp)
            # both attachments ride one set_trailing_metadata call
            trailers = []
            if remote_ctx is not None and sp is not None:
                trailers.append((TRACE_SUBTREE_TRAILER, serialize_span(sp)))
            if want_status and self.status_collector is not None:
                # errors included: a failing answer still proves the peer up
                blob = self.status_collector.encoded()
                if blob:
                    trailers.append((STATUS_TRAILER, blob))
            if trailers:
                context.set_trailing_metadata(tuple(trailers))
            if err is not None:
                context.abort(*err)
            return resp

        return grpc.unary_unary_rpc_method_handler(
            handler,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )

    def _unknown_method(self, request, context: grpc.ServicerContext):
        if self.metrics is not None:
            self.metrics.request_count.labels("grpc").inc()
            self.metrics.request_failures.labels("grpc").inc()
            self.metrics.request_duration.labels("grpc", "invalid", "error", "local").observe(0.0)
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "unknown method")

    def _multi_inference(self, request):
        # rejected, as the reference rejects it (tfservingproxy.go:215-217)
        raise BackendError("MultiInference not supported", 501)

    def _generate_stream(self, request, context: grpc.ServicerContext):
        """PredictionService/GenerateStream: the backend's
        ``generate_stream`` frames; the span and the duration cover the
        whole drain (reference :307-360)."""
        t0, remote_ctx, _want_status = self._enter(context)
        sp = err = None
        try:
            gen = getattr(self.backend, "generate_stream", None)
            if gen is None:
                err = (grpc.StatusCode.UNIMPLEMENTED,
                       "GenerateStream not supported by this backend")
            else:
                with remote_parent(remote_ctx), \
                        TRACER.span("grpc", method="generate_stream") as sp:
                    yield from gen(request)
        except BackendError as e:
            err = (_status_code(e), str(e))
        except Exception as e:  # noqa: BLE001
            log.exception("unhandled error in generate_stream")
            err = (grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        finally:
            self._observe("generate_stream", t0, err, sp)
        if remote_ctx is not None and sp is not None:
            context.set_trailing_metadata(((TRACE_SUBTREE_TRAILER, serialize_span(sp)),))
        if err is not None:
            context.abort(*err)

    def _fetch_packed_model(self, request: bytes, context: grpc.ServicerContext):
        """tpusc.internal.PeerTransfer/FetchPackedModel: stream this node's
        host-tier entry of a model to a cold peer (reference :216-266).
        UNIMPLEMENTED without a source; INVALID_ARGUMENT on a bad request;
        RESOURCE_EXHAUSTED over the in-flight cap of the requesting host;
        NOT_FOUND when the tier does not hold the model (the asker's fleet
        view may lag an eviction: a clean miss); INTERNAL when the stream
        breaks. The entry stays pinned until the stream's last frame, so a
        concurrent eviction cannot tear its bytes."""
        from tfservingcache_tpu_torch.protocol.peer_transfer import (
            PeerWireError,
            decode_request,
            iter_frames,
        )
        from tfservingcache_tpu_torch.types import ModelId

        src = self.peer_source
        if src is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "peer transfer not enabled")
        try:
            name, version = decode_request(request)
        except PeerWireError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        mid = ModelId(name, version)
        # the cap is per requesting host: each stream has its own port
        host = peer_host(context.peer())
        if not src.acquire(host):
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                          f"peer fetch in-flight cap ({src.max_inflight_per_peer}) reached")
        entry = None
        try:
            entry = src.pin(mid)
            if entry is None:
                context.abort(grpc.StatusCode.NOT_FOUND, f"{mid} not in host tier")
            with TRACER.span("peer_stream_out", model=str(mid), peer=host):
                yield from iter_frames(entry, src.chunk_bytes, model_id=mid)
        except PeerWireError as e:
            log.warning("peer stream of %s failed: %s", mid, e)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        finally:
            if entry is not None:
                src.unpin(mid)
            src.release(host)

    def _fetch_parked_kv(self, request: bytes, context: grpc.ServicerContext):
        """tpusc.internal.PeerTransfer/FetchParkedConversation: stream one
        parked conversation to the peer that now serves it. NOT_FOUND = not
        parked here (the asker prefills cold). The lookup does not touch LRU
        order: an outbound read must not make a conversation look hot."""
        from tfservingcache_tpu_torch.protocol.peer_transfer import (
            PeerWireError,
            decode_kv_request,
            iter_kv_frames,
        )

        tier = self.conversation_tier
        if tier is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "conversation KV tier not enabled")
        try:
            conversation, model = decode_kv_request(request)
        except PeerWireError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        parked, outcome = tier.get(conversation, model, touch=False)
        if parked is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"conversation {conversation} not parked for {model}")
        try:
            with TRACER.span("peer_kv_out", conversation=conversation, model=model,
                             residency=outcome):
                yield from iter_kv_frames(parked, conversation, 2 << 20)
        except PeerWireError as e:
            log.warning("peer KV stream of %s failed: %s", conversation, e)
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def _check(self, request, context):
        return health_pb.HealthCheckResponse(status=self.health.status)

    def _watch(self, request, context):
        seen = self.health.version()
        yield health_pb.HealthCheckResponse(status=self.health.status)
        while context.is_active() and not self.health.closed:
            now = self.health.wait_change(seen, _WATCH_POLL_S)
            if now != seen and not self.health.closed:
                seen = now
                yield health_pb.HealthCheckResponse(status=self.health.status)

    def _handlers(self) -> list[grpc.GenericRpcHandler]:
        b = self.backend
        impl = {
            (PREDICTION_SERVICE, "Predict"): b.predict,
            (PREDICTION_SERVICE, "Classify"): b.classify,
            (PREDICTION_SERVICE, "Regress"): b.regress,
            (PREDICTION_SERVICE, "MultiInference"): self._multi_inference,
            (PREDICTION_SERVICE, "GetModelMetadata"): b.get_model_metadata,
            (MODEL_SERVICE, "GetModelStatus"): b.get_model_status,
            (MODEL_SERVICE, "HandleReloadConfigRequest"): b.reload_config,
            (SESSION_SERVICE, "SessionRun"): b.session_run,
        }
        per_service: dict[str, dict[str, grpc.RpcMethodHandler]] = {}
        for (service, method), fn in impl.items():
            req_cls, resp_cls = METHOD_TABLE[(service, method)]
            per_service.setdefault(service, {})[method] = self._unary(fn, req_cls, resp_cls)
        # registered whatever the backend: one without a generate_stream
        # answers UNIMPLEMENTED through the handler
        per_service[PREDICTION_SERVICE]["GenerateStream"] = grpc.unary_stream_rpc_method_handler(
            self._generate_stream,
            request_deserializer=sv.PredictRequest.FromString,
            response_serializer=sv.PredictResponse.SerializeToString,
        )
        # the peer-transfer service: FetchPackedModel with a peer source,
        # FetchParkedConversation with a conversation tier
        from tfservingcache_tpu_torch.protocol.peer_transfer import (
            PEER_FETCH_METHOD,
            PEER_KV_METHOD,
            PEER_TRANSFER_SERVICE,
        )

        peer_methods = {}
        if self.peer_source is not None:
            peer_methods[PEER_FETCH_METHOD] = self._fetch_packed_model
        if self.conversation_tier is not None:
            peer_methods[PEER_KV_METHOD] = self._fetch_parked_kv
        if peer_methods:
            per_service[PEER_TRANSFER_SERVICE] = {
                method: grpc.unary_stream_rpc_method_handler(
                    fn, request_deserializer=lambda b: b, response_serializer=lambda b: b)
                for method, fn in peer_methods.items()
            }
        per_service[HEALTH_SERVICE] = {
            "Check": grpc.unary_unary_rpc_method_handler(
                self._check,
                request_deserializer=health_pb.HealthCheckRequest.FromString,
                response_serializer=health_pb.HealthCheckResponse.SerializeToString,
            ),
            "Watch": grpc.unary_stream_rpc_method_handler(
                self._watch,
                request_deserializer=health_pb.HealthCheckRequest.FromString,
                response_serializer=health_pb.HealthCheckResponse.SerializeToString,
            ),
        }
        handlers: list[grpc.GenericRpcHandler] = [
            grpc.method_handlers_generic_handler(service, methods)
            for service, methods in per_service.items()
        ]
        handlers.append(_UnknownMethodHandler(self._unknown_method))  # last: the catch-all
        return handlers

    # -- lifecycle ----------------------------------------------------------
    def start(self, port: int, host: str = "0.0.0.0") -> int:
        """Bind and serve; port 0 binds an ephemeral port. A port that is
        taken raises (``grpc.so_reuseport`` off). Returns the bound port."""
        pool = ThreadPoolExecutor(max_workers=self._max_workers, thread_name_prefix="tpusc-grpc")
        server = grpc.server(pool, options=[
            ("grpc.max_receive_message_length", self._max_message_bytes),
            ("grpc.max_send_message_length", self._max_message_bytes),
            ("grpc.so_reuseport", 0),
        ])
        server.add_generic_rpc_handlers(tuple(self._handlers()))
        try:
            bound = server.add_insecure_port(f"{host}:{port}")
        except RuntimeError as e:
            bound, why = 0, e
        else:
            why = None
        if not bound:
            server.stop(None)
            pool.shutdown(wait=False)
            raise OSError(f"gRPC server could not bind {host}:{port}: {why or 'port taken'}")
        server.start()
        self.server, self._pool, self.port = server, pool, bound
        log.info("gRPC server listening on %s:%d", host, bound)
        return bound

    def set_health(self, healthy: bool) -> None:
        self.health.set_health(healthy)

    def close(self, grace: float = 2.0, join_timeout: float = 10.0) -> None:
        """Stop taking RPCs, let running ones finish for ``grace`` seconds,
        end open Watch streams, and join the worker threads (each within
        ``join_timeout``)."""
        self.health.close()
        if self.server is not None:
            self.server.stop(grace).wait(grace + join_timeout)
            self.server = None
        if self._pool is not None:
            threads = list(getattr(self._pool, "_threads", ()))
            self._pool.shutdown(wait=False, cancel_futures=True)
            for t in threads:
                t.join(timeout=join_timeout)
            self._pool = None
