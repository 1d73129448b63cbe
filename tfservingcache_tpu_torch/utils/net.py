"""Network helpers (counterpart of ``tfservingcache_tpu/utils/net.py``)."""

from __future__ import annotations

import http.client
import json
import socket
import ssl
import urllib.error
import urllib.request
from collections.abc import Iterator
from typing import Any
from urllib.parse import urlsplit


def iter_lines(resp, chunk_bytes: int = 65536) -> Iterator[bytes]:
    """Yield the non-blank newline-delimited records of a streaming
    ``http.client`` response (a watch stream of etcd or the Kubernetes API).
    Reads whatever has arrived and splits it itself, so a record longer
    than any line limit (one Endpoints event for hundreds of pods) comes
    through whole; the last record needs no newline."""
    buf = b""
    while True:
        chunk = resp.read1(chunk_bytes)
        if not chunk:
            break
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                yield line
    if buf.strip():
        yield buf


def outbound_ip(probe_addr: tuple[str, int] = ("8.8.8.8", 80)) -> str:
    """The outbound interface's address by a UDP connect, which sends no
    packet; ``127.0.0.1`` where the host has no route."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(0.5)
            s.connect(probe_addr)
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def http_request(method: str, url: str, body: Any = None, timeout: float = 10.0,
                 headers: dict[str, str] | None = None,
                 context: ssl.SSLContext | None = None) -> tuple[int, bytes]:
    """One HTTP exchange -> (status, body); a non-2xx status is returned,
    not raised. ``body`` that is not bytes goes as JSON. Raises OSError
    (``URLError`` included) when the server cannot be reached."""
    hdrs = dict(headers or {})
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
        hdrs.setdefault("Content-Type", "application/json")
    req = urllib.request.Request(url, data=body, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=context) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def open_stream(method: str, url: str, body: bytes | None = None, timeout: float = 30.0,
                headers: dict[str, str] | None = None,
                context: ssl.SSLContext | None = None,
                ) -> tuple[http.client.HTTPConnection, http.client.HTTPResponse]:
    """Start a long-lived streaming exchange (a watch) -> (connection,
    response). ``timeout`` bounds each read: a stream idle that long raises
    ``TimeoutError``; ``close_stream`` from another thread ends a blocked
    read."""
    parts = urlsplit(url)
    if parts.scheme == "https":
        conn: http.client.HTTPConnection = http.client.HTTPSConnection(
            parts.hostname, parts.port or 443, timeout=timeout, context=context)
    else:
        conn = http.client.HTTPConnection(parts.hostname, parts.port or 80, timeout=timeout)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    try:
        conn.request(method, path, body=body, headers=dict(headers or {}))
        return conn, conn.getresponse()
    except BaseException:
        conn.close()
        raise


def close_stream(conn: http.client.HTTPConnection | None) -> None:
    """End a stream from another thread: shut its socket down, so that a
    read blocked on it returns end-of-stream (the reading thread closes
    the connection)."""
    sock = conn.sock if conn is not None else None
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
