"""REST server for the TF Serving HTTP API (counterpart of
``tfservingcache_tpu/protocol/rest.py``), on the standard library's
``http.server`` so the port needs no web framework.

The URL contract is the reference's:
  - case-insensitive ``/v1/models/<name>[/versions/<version>]`` with an
    optional ``:predict`` verb or ``/metadata`` suffix;
  - no match        -> 404 ``{"Status": "Error", "Message": "Not found"}``;
  - missing version -> 400 ``{"Status": "Error", "Message": "Model version must be provided"}``;
  - backend errors  -> their HTTP status with ``{"error": message}``.
``GET /healthz`` answers ``{"status": "ok"}``.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tfservingcache_tpu_torch.protocol.backend import BackendError, ServingBackend

log = logging.getLogger("tpusc_torch.rest")

URL_RE = re.compile(
    r"^/v1/models/(?P<name>[^/]+?)(/versions/(?P<version>[0-9]+))?$", re.I
)

MAX_BODY_BYTES = 256 << 20

# the reference's verbs; :predict is served here, the rest answer 501
VERBS = ("predict", "classify", "regress", "generate")


def _error_body(message: str) -> bytes:
    return json.dumps({"Status": "Error", "Message": message}).encode()


def parse_model_url(path: str) -> tuple[str, int | None, str | None] | None:
    """-> (model_name, version|None, verb|None), or None when unroutable.
    ``verb`` is a protocol verb, ``metadata``, or None (bare GET = status)."""
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
    return m.group("name"), (int(version) if version is not None else None), verb


class RestServingServer:
    def __init__(self, backend: ServingBackend) -> None:
        self.backend = backend
        self.port: int | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def handle(self, method: str, path: str, body: bytes) -> tuple[int, bytes]:
        """One request -> (HTTP status, JSON body)."""
        path = path.split("?", 1)[0]
        if path == "/healthz":
            return 200, b'{"status": "ok"}'
        parsed = parse_model_url(path)
        if parsed is None:
            return 404, _error_body("Not found")
        name, version, verb = parsed
        if version is None:  # the cache node serves versioned URLs only
            return 400, _error_body("Model version must be provided")
        try:
            resp = self.backend.handle_rest(method, name, version, verb, body)
        except BackendError as e:
            return e.http_status, json.dumps({"error": str(e)}).encode()
        except Exception as e:  # noqa: BLE001 - a server answers 500, keeps serving
            log.exception("unhandled REST error for %s", path)
            return 500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
        return resp.status, resp.body

    def _handler(self) -> type[BaseHTTPRequestHandler]:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _serve(self, method: str) -> None:
                length = int(self.headers.get("Content-Length") or 0)
                if length > MAX_BODY_BYTES:
                    status, body = 413, _error_body("request body too large")
                    self.close_connection = True
                else:
                    payload = self.rfile.read(length) if length else b""
                    status, body = server.handle(method, self.path, payload)
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 - http.server's naming
                self._serve("GET")

            def do_POST(self) -> None:  # noqa: N802
                self._serve("POST")

            def log_message(self, fmt: str, *args) -> None:
                log.debug("%s " + fmt, self.address_string(), *args)

        return Handler

    def start(self, port: int, host: str = "0.0.0.0") -> int:
        """Bind and serve on a background thread; port 0 binds an ephemeral
        port. Returns the bound port."""
        httpd = ThreadingHTTPServer((host, port), self._handler())
        httpd.daemon_threads = True
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
