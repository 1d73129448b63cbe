"""REST server for the TF Serving HTTP API (counterpart of
``tfservingcache_tpu/protocol/rest.py``), on the standard library's
``http.server`` so the port needs no web framework.

The URL contract is the reference's:
  - case-insensitive ``/v1/models/<name>[/versions/<version>|/labels/<label>]``
    with an optional verb (``:predict``, ``:classify``, ``:regress``,
    ``:generate``) or ``/metadata`` suffix; a label resolves through
    ``serving.version_labels`` (412 when unmapped);
  - no match        -> 404 ``{"Status": "Error", "Message": "Not found"}``;
  - neither version nor label, on a server built with ``require_version``
    (a router's) -> 400 ``{"Status": "Error", "Message": "Model version must be provided"}``;
    a node's server passes the URL on and the node serves the latest version;
  - backend errors  -> their HTTP status with ``{"error": message}``.
``GET /healthz`` answers ``{"status": "ok"}``. A reply that carries a token
stream (``:generate?stream=true``) goes out as ``text/event-stream`` over
chunked transfer, one flushed chunk a frame (reference rest.py:343-379); a
client that disconnects stops the drain, and the generate finishes on its
own.

Observability (reference rest.py:138-300, 381-415):
  - ``metrics.path`` (``/monitoring/prometheus/metrics``) renders the
    node's ``Metrics`` after ``LEDGER.publish``;
  - ``/monitoring/traces`` (``n``, ``min_ms``, ``trace_id``),
    ``/monitoring/engine`` (``n``, ``reset``, ``model``; the flight
    recorder's snapshot plus its ``dumps``, and ``mesh``, the runtime's
    ``mesh_topology()``, on a device group) and ``/monitoring/tenants``
    (``top``, ``dim``, ``model``, ``reset``); ``/monitoring/status`` is
    the node's ``NodeStatus`` as a dict (``status_collector``) and
    ``/monitoring/cluster`` the router's ``FleetView`` snapshot (``fleet``),
    each the reference's 404 body where the server has none;
  - with ``metrics_scrape_targets`` the metrics path merges those
    exporters' text into the node's (``utils/metrics.scrape_and_merge``);
  - a model request carrying ``x-tpusc-status-want`` (a router's hop) gets
    the node's encoded status in ``x-tpusc-status``, errors included;
  - ``POST /monitoring/profiler?duration_s=&label=`` captures a
    ``torch.profiler`` trace (CPU, and CUDA when a card is present) for up
    to 60 s into ``<profiler_base_dir>/<label>/`` as a Chrome trace; one
    capture at a time (409 otherwise);
  - every model URL is counted, timed and in-flight-gauged, and runs under
    a ``rest`` root span that adopts an inbound ``traceparent``; such a
    request gets its finished span subtree back in ``x-tpusc-trace``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import threading
import time
from collections.abc import Callable, Mapping
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl

from tfservingcache_tpu_torch.cluster.status import STATUS_HEADER, STATUS_WANT_HEADER
from tfservingcache_tpu_torch.protocol.backend import BackendError, RestResponse, ServingBackend
from tfservingcache_tpu_torch.utils.accounting import LEDGER
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER
from tfservingcache_tpu_torch.utils.metrics import CONTENT_TYPE, Metrics, scrape_and_merge
from tfservingcache_tpu_torch.utils.tracing import (
    TRACER,
    parse_traceparent,
    remote_parent,
    serialize_span,
)

log = logging.getLogger("tpusc_torch.rest")

# response header carrying this node's completed span subtree back to a
# caller that sent a traceparent
TRACE_SUBTREE_HEADER = "x-tpusc-trace"

# the reference's regex (rest.py:52-56): TF Serving's /labels/<label>
# alternative beside /versions/<version>
URL_RE = re.compile(
    r"^/v1/models/(?P<name>[^/]+?)"
    r"(/versions/(?P<version>[0-9]+)|/labels/(?P<label>[^/]+?))?$",
    re.I,
)

MAX_BODY_BYTES = 256 << 20

VERBS = ("predict", "classify", "regress", "generate")

_ON = ("1", "true", "yes", "on")
_LABEL_RE = re.compile(r"[A-Za-z0-9._-]{1,64}")
_profiler_primed = False


def _prime_profiler() -> None:
    """Start and stop one empty ``torch.profiler`` capture on the main
    thread, once a process, when a card is present. The profiler's native
    backend initializes its client only on the thread that registered it
    (the main thread, at import); a first capture started from a request's
    thread instead records nothing at all on the card."""
    global _profiler_primed
    if _profiler_primed or threading.current_thread() is not threading.main_thread():
        return
    import torch

    if not torch.cuda.is_available():
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass
    _profiler_primed = True


def _error_body(message: str) -> bytes:
    return json.dumps({"Status": "Error", "Message": message}).encode()


def _json(obj, status: int = 200) -> RestResponse:
    return RestResponse(status, json.dumps(obj).encode())


def parse_model_url(path: str) -> tuple[str, int | None, str | None, str | None] | None:
    """-> (model_name, version|None, verb|None, label|None), or None when
    unroutable. ``verb`` is a protocol verb, ``metadata``, or None (bare GET
    = status); ``version`` and ``label`` exclude each other."""
    verb: str | None = None
    if ":" in path:
        path, _, v = path.rpartition(":")
        if v.lower() not in VERBS:
            return None
        verb = v.lower()
    elif path.lower().endswith("/metadata"):
        path = path[: -len("/metadata")]
        verb = "metadata"
    m = URL_RE.match(path)
    if not m:
        return None
    version = m.group("version")
    return (m.group("name"), (int(version) if version is not None else None), verb,
            m.group("label"))


class _HTTPServer(ThreadingHTTPServer):
    """The stdlib threading server listening with the reference's backlog:
    aiohttp's ``TCPSite`` listens with 128 pending connections, socketserver
    with 5, and a burst of more concurrent connects than the backlog loses
    SYNs that clients retry only after a second."""

    daemon_threads = True
    request_queue_size = 128


class RestServingServer:
    def __init__(
        self,
        backend: ServingBackend,
        metrics: Metrics | None = None,
        metrics_path: str | None = None,
        profiler_base_dir: str | None = None,
        require_version: bool = False,
        metrics_scrape_targets: list[str] | None = None,
        metrics_sum_counters: bool = False,
    ) -> None:
        self.backend = backend
        self.metrics = metrics
        self.metrics_path = metrics_path
        # a router routes by name##version, so its URLs must name a version
        # (the reference's proxy 400s without one); a node serves the latest
        self.require_version = require_version
        self.metrics_scrape_targets = list(metrics_scrape_targets or [])
        self.metrics_sum_counters = bool(metrics_sum_counters)
        # fleet status plane, attached after construction: a node's
        # collector serves /monitoring/status and the piggyback header, a
        # router's FleetView serves /monitoring/cluster
        self.status_collector = None
        self.fleet = None
        self.port: int | None = None
        self._httpd: _HTTPServer | None = None
        self._thread: threading.Thread | None = None
        # captures are confined under one base dir; a client picks only a
        # label. The default lies under the process's temporary directory
        # (the reference's is the fixed /tmp/tpusc_profile).
        self.profiler_base_dir = profiler_base_dir or os.environ.get(
            "TPUSC_PROFILER_DIR", os.path.join(tempfile.gettempdir(), "tpusc_profile"))
        self._profile_lock = threading.Lock()  # one capture at a time

    # -- dispatch -----------------------------------------------------------
    def dispatch(self, method: str, path: str, body: bytes, headers: Mapping[str, str],
                 send: Callable[[RestResponse], None]) -> None:
        """Answer one request through ``send``. A model URL is counted and
        in-flight until its reply is ready, or for a stream until the drain
        ends, then its duration is observed (reference rest.py:248-266): a
        client that has its whole answer finds it counted."""
        path, _, raw_query = path.partition("?")
        query = dict(parse_qsl(raw_query))
        resp = self._monitoring(method, path, query)
        if resp is not None:
            send(resp)
            return
        m = self.metrics
        if m is not None:
            m.request_count.labels("rest").inc()
            m.requests_in_flight.labels("rest").inc()
        t0 = time.monotonic()
        resp = sp = None
        verb_label = "invalid"
        done = False

        def account() -> None:
            nonlocal done
            done = True
            if m is not None:
                m.requests_in_flight.labels("rest").dec()
                outcome = "ok" if resp is not None and resp.status < 400 else "error"
                route = (sp.attrs.get("route") if sp is not None else None) or "local"
                m.request_duration.labels("rest", verb_label, outcome, route).observe(
                    time.monotonic() - t0)

        try:
            resp, sp, verb_label = self._serve_model_request(method, path, query, body, headers)
            if resp.token_stream is None:
                account()
            send(resp)
        finally:
            if not done:
                account()

    def _monitoring(self, method: str, path: str,
                    query: dict[str, str]) -> RestResponse | None:
        """The node's own endpoints (not counted as requests); None for a
        model URL."""
        if self.metrics_path and path == self.metrics_path and self.metrics is not None:
            # the tenant ledger mirrors into the tpusc_tenant_* families at
            # scrape time, so the engine's hot path never touches them
            LEDGER.publish(self.metrics)
            body = self.metrics.render()
            if self.metrics_scrape_targets:
                body = scrape_and_merge(body, self.metrics_scrape_targets, metrics=self.metrics,
                                        sum_counters=self.metrics_sum_counters)
            return RestResponse(200, body, content_type=CONTENT_TYPE)
        if path == "/healthz":
            return RestResponse(200, b'{"status": "ok"}')
        if path == "/monitoring/traces":
            try:
                n = int(query.get("n", "50"))
                min_ms = float(query["min_ms"]) if "min_ms" in query else None
            except ValueError:
                return _json({"error": "n must be an integer and min_ms a number"}, 400)
            traces = TRACER.query(
                n=n,
                min_duration_s=min_ms / 1000.0 if min_ms is not None else None,
                trace_id=query.get("trace_id"),
            ) if n > 0 else []
            return _json({"traces": traces})
        if path == "/monitoring/engine":
            try:
                n = int(query.get("n", "64"))
            except ValueError:
                return _json({"error": "n must be an integer"}, 400)
            # reset-on-scrape watermarks unless ?reset=0
            snap = RECORDER.snapshot(
                tail=max(0, n),
                reset_watermarks=query.get("reset", "1").lower() in _ON,
                model=query.get("model"),
            )
            snap["dumps"] = RECORDER.list_dumps()
            # the group stamp (reference rest.py:196-206): engine numbers
            # from a sharded arena are read beside the group that made them
            runtime = getattr(getattr(self.backend, "manager", None), "runtime", None)
            topology = getattr(runtime, "mesh_topology", lambda: None)()
            if topology is not None:
                snap["mesh"] = topology
            return _json(snap)
        if path == "/monitoring/tenants":
            try:
                top = int(query.get("top", "0"))
            except ValueError:
                return _json({"error": "top must be an integer"}, 400)
            return _json(LEDGER.snapshot(
                top=max(0, top), dim=query.get("dim"), model=query.get("model"),
                reset=query.get("reset", "0").lower() in _ON,
            ))
        if path == "/monitoring/status":
            if self.status_collector is None:
                return _json({"error": "status exchange not enabled on this server"}, 404)
            return _json(self.status_collector.collect().to_dict())
        if path == "/monitoring/cluster":
            if self.fleet is None:
                return _json({"error": "no fleet view on this server (router only)"}, 404)
            return _json(self.fleet.snapshot())
        if path == "/monitoring/profiler" and method == "POST":
            return self._capture_profile(query)
        return None

    def _serve_model_request(self, method: str, path: str, query: dict[str, str], body: bytes,
                             headers: Mapping[str, str]):
        """-> (response, completed root span | None, verb label)."""
        parsed = parse_model_url(path)
        if parsed is None:
            return self._fail(RestResponse(404, _error_body("Not found"))), None, "invalid"
        name, version, verb, label = parsed
        verb_label = verb or ("status" if method == "GET" else "invalid")
        if version is None and label is None and self.require_version:
            return self._fail(RestResponse(
                400, _error_body("Model version must be provided"))), None, verb_label
        # an inbound W3C context makes the root span join the caller's trace
        remote_ctx = parse_traceparent(headers.get("traceparent"))
        sp = None
        try:
            with remote_parent(remote_ctx), \
                    TRACER.span("rest", path=path, method=method) as sp:
                resp = self.backend.handle_rest(method, name, version, verb, body,
                                                label=label, query=query)
        except BackendError as e:
            resp = self._fail(_json({"error": str(e)}, e.http_status))
        except Exception as e:  # noqa: BLE001 - a server answers 500, keeps serving
            log.exception("unhandled REST error for %s", path)
            resp = self._fail(_json({"error": f"{type(e).__name__}: {e}"}, 500))
        else:
            if resp.status >= 400 and self.metrics is not None:
                self.metrics.request_failures.labels("rest").inc()
        if remote_ctx is not None and sp is not None:
            resp.headers[TRACE_SUBTREE_HEADER] = serialize_span(sp)
        if self.status_collector is not None and headers.get(STATUS_WANT_HEADER):
            # a router's hop: piggyback this node's (cached, capped) status
            blob = self.status_collector.encoded()
            if blob:
                resp.headers[STATUS_HEADER] = blob
        return resp, sp, verb_label

    def _fail(self, resp: RestResponse) -> RestResponse:
        if self.metrics is not None:
            self.metrics.request_failures.labels("rest").inc()
        return resp

    def _capture_profile(self, query: dict[str, str]) -> RestResponse:
        """Capture a ``torch.profiler`` trace of this process for
        ``duration_s`` (at most 60) into ``<profiler_base_dir>/<label>/``:
        every thread's CPU ops, and the card's kernels when CUDA is up. The
        capture stops in a ``finally`` whatever happens while it runs."""
        try:
            duration_s = min(float(query.get("duration_s", "2")), 60.0)
        except ValueError:
            return _json({"error": "duration_s must be a number"}, 400)
        label = query.get("label", "default")
        if not _LABEL_RE.fullmatch(label) or label.startswith("."):
            return _json(
                {"error": "label must be [A-Za-z0-9._-]{1,64} and not start with '.'"}, 400)
        log_dir = os.path.join(self.profiler_base_dir, label)
        if not self._profile_lock.acquire(blocking=False):
            return _json({"error": "profile capture in progress"}, 409)
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            kwargs = {}
            try:
                # the CPU ops of every thread (the engine's scheduler), not
                # only this handler's; the card's kernels are process-wide
                kwargs["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True)
            except (AttributeError, TypeError):
                pass  # a torch without the option: this thread's CPU ops only
            prof = profile(activities=activities, **kwargs)
            prof.start()
            try:
                time.sleep(max(0.0, duration_s))
            finally:
                prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            trace = os.path.join(
                log_dir, f"trace_{time.strftime('%Y%m%dT%H%M%S', time.gmtime())}"
                         f"_{os.getpid()}.json")
            prof.export_chrome_trace(trace)
        except Exception as e:  # noqa: BLE001 - the node keeps serving
            return _json({"error": f"{type(e).__name__}: {e}"}, 500)
        finally:
            self._profile_lock.release()
        return _json({"status": "ok", "dir": log_dir, "duration_s": duration_s,
                      "trace": trace})

    # -- the stdlib server --------------------------------------------------
    def _handler(self) -> type[BaseHTTPRequestHandler]:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _serve(self, method: str) -> None:
                length = int(self.headers.get("Content-Length") or 0)
                if length > MAX_BODY_BYTES:
                    self.close_connection = True
                    self._send(RestResponse(413, _error_body("request body too large")))
                    return
                payload = self.rfile.read(length) if length else b""
                server.dispatch(method, self.path, payload, self.headers, self._send)

            def _send(self, resp: RestResponse) -> None:
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                if resp.token_stream is None:
                    self.send_header("Content-Length", str(len(resp.body)))
                    self.end_headers()
                    self.wfile.write(resp.body)
                    return
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._drain(resp.token_stream)

            def _drain(self, frames) -> None:
                """Write each frame as one chunk and flush it, then the last
                chunk. A client gone mid-stream ends the drain quietly."""
                try:
                    for frame in frames:
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(frame), frame))
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    log.info("generate stream client disconnected mid-stream")
                    self.close_connection = True
                finally:
                    frames.close()

            def do_GET(self) -> None:  # noqa: N802 - http.server's naming
                self._serve("GET")

            def do_POST(self) -> None:  # noqa: N802
                self._serve("POST")

            def log_message(self, fmt: str, *args) -> None:
                log.debug("%s " + fmt, self.address_string(), *args)

        return Handler

    def start(self, port: int, host: str = "0.0.0.0") -> int:
        """Bind and serve on a background thread; port 0 binds an ephemeral
        port. Returns the bound port. Called on the main thread with a card
        present, it first readies the profiler for the endpoint."""
        _prime_profiler()
        httpd = _HTTPServer((host, port), self._handler())
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="tpusc-rest", daemon=True
        )
        self._thread.start()
        log.info("REST server listening on %s:%d", host, self.port)
        return self.port

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
