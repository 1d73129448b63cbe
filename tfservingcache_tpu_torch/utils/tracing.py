"""Per-request, per-stage distributed tracing (counterpart of
``tfservingcache_tpu/utils/tracing.py``, the same ids, span tree and wire
form: ``serialize_span`` of the same tree is byte-identical).

A process-wide ring buffer of completed request traces, each a tree of
spans (rest -> ensure_servable -> provider_fetch/load -> infer), ambient
via contextvars so call sites never thread a handle. Work handed to another
thread joins the request's trace when it runs under
``contextvars.copy_context`` (the cache manager's load worker does).

Every span carries a 64-bit span id and inherits its root's 128-bit trace
id. An inbound W3C ``traceparent`` header makes the request's root span
adopt the caller's trace id; ``serialize_span`` packs a finished subtree
(compressed JSON) for a response header.

Slow-trace retention: roots slower than ``slow_threshold_s`` survive in a
separate bounded buffer after fast traffic wraps the ring, and surface via
``query(min_duration_s=...)``; each also reaches ``slow_hook`` (the flight
recorder's SLO-breach dump).

Overhead when idle: one contextvar lookup, two ``monotonic()`` calls and
one 64-bit random id per span; the buffers bound memory.
"""

from __future__ import annotations

import base64
import contextvars
import json
import random
import re
import threading
import time
import zlib

from tfservingcache_tpu_torch.utils.lockcheck import lockchecked
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "tpusc_current_span", default=None
)
# (trace_id, parent_span_id) extracted from an inbound traceparent: the next
# root span opened in this context adopts it instead of minting a new trace
_remote_parent: contextvars.ContextVar[tuple[str, str] | None] = contextvars.ContextVar(
    "tpusc_remote_parent", default=None
)

# W3C trace-context: version "00", 16-byte trace id, 8-byte parent span id,
# flags. Ids of all zeros are invalid per the spec.
_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-(?P<trace>[0-9a-f]{32})-(?P<span>[0-9a-f]{16})-[0-9a-f]{2}$"
)

# SystemRandom would be overkill (ids are diagnostics, not secrets) and
# os.urandom costs a syscall per span; Random is a few hundred ns.
_rand = random.Random()


def _new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


def _new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """-> (trace_id, parent_span_id) or None for absent/malformed headers
    (a garbage header must never fail the request it arrived on)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace, span = m.group("trace"), m.group("span")
    if trace == "0" * 32 or span == "0" * 16:
        return None
    return trace, span


def format_traceparent(sp: "Span | None" = None) -> str | None:
    """traceparent for the given (default: ambient) span, or None when no
    span is open — callers simply omit the header then."""
    sp = sp if sp is not None else _current_span.get()
    if sp is None or not sp.trace_id:
        return None
    return f"00-{sp.trace_id}-{sp.span_id}-01"


@contextmanager
def remote_parent(ctx: tuple[str, str] | None) -> Iterator[None]:
    """While active, the next ROOT span adopts ``ctx`` = (trace_id,
    parent_span_id) — the protocol servers wrap their request span in this
    after extracting an inbound traceparent. A None ctx is a no-op so call
    sites don't need to branch."""
    if ctx is None:
        yield
        return
    token = _remote_parent.set(ctx)
    try:
        yield
    finally:
        _remote_parent.reset(token)


def current_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the innermost open span, or None outside any
    request context. The JSON log formatter joins log lines to traces here."""
    sp = _current_span.get()
    if sp is None:
        return None
    return sp.trace_id, sp.span_id


@dataclass
class Span:
    name: str
    attrs: dict[str, Any]
    start_s: float                      # wall-clock epoch (for display)
    t0: float = 0.0                     # monotonic (for duration)
    duration_s: float = 0.0
    error: str = ""
    children: list["Span"] = field(default_factory=list)
    trace_id: str = ""                  # 128-bit hex; shared by the whole tree
    span_id: str = ""                   # 64-bit hex; unique per span
    parent_id: str = ""                 # remote parent span id (adopted roots)
    remote: bool = False                # subtree grafted back from a peer
    root: "Span | None" = field(default=None, repr=False, compare=False)

    def to_dict(self, _root: bool = True) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "duration_s": round(self.duration_s, 6),
        }
        if self.span_id:
            d["span_id"] = self.span_id
        if self.trace_id and (_root or self.remote):
            # children inherit the root's trace id; repeating it per span
            # would bloat the wire subtree for no information. Remote grafts
            # keep theirs so a stitched trace shows the ids matching up.
            d["trace_id"] = self.trace_id
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.remote:
            d["remote"] = True
        if self.attrs:
            d["attrs"] = self.attrs
        if self.error:
            d["error"] = self.error
        if self.children:
            d["children"] = [c.to_dict(_root=False) for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Span":
        sp = cls(
            name=str(d.get("name", "?")),
            attrs=dict(d.get("attrs") or {}),
            start_s=float(d.get("start_s", 0.0)),
            duration_s=float(d.get("duration_s", 0.0)),
            error=str(d.get("error", "")),
            trace_id=str(d.get("trace_id", "")),
            span_id=str(d.get("span_id", "")),
            parent_id=str(d.get("parent_id", "")),
            remote=bool(d.get("remote", False)),
        )
        sp.children = [cls.from_dict(c) for c in d.get("children") or []]
        return sp


# Wire form of a completed subtree: compact JSON -> zlib -> urlsafe base64,
# so it fits an HTTP response header or an ASCII gRPC trailer value. Beyond
# the size cap the tree is degraded (attrs dropped, then a root-only stub)
# rather than blowing the peer's header-size limit.
WIRE_TRACE_LIMIT = 6 << 10


def serialize_span(sp: Span, limit: int = WIRE_TRACE_LIMIT) -> str:
    def pack(d: dict[str, Any]) -> str:
        raw = json.dumps(d, separators=(",", ":"), default=str).encode()
        return base64.urlsafe_b64encode(zlib.compress(raw, 6)).decode()

    blob = pack(sp.to_dict())
    if len(blob) <= limit:
        return blob

    def strip_attrs(d: dict[str, Any]) -> dict[str, Any]:
        d = {k: v for k, v in d.items() if k != "attrs"}
        if "children" in d:
            d["children"] = [strip_attrs(c) for c in d["children"]]
        return d

    blob = pack(strip_attrs(sp.to_dict()))
    if len(blob) <= limit:
        return blob
    stub = sp.to_dict()
    stub.pop("children", None)
    stub.setdefault("attrs", {})["truncated"] = True
    return pack(stub)


def deserialize_span(payload: str | bytes) -> Span | None:
    """None on any malformed payload: a peer's corrupt trace trailer must
    cost the stitched subtree, never the response."""
    try:
        if isinstance(payload, str):
            payload = payload.encode()
        raw = zlib.decompress(base64.urlsafe_b64decode(payload))
        d = json.loads(raw)
        if not isinstance(d, dict):
            return None
        return Span.from_dict(d)
    except Exception:  # noqa: BLE001 — by contract: garbage in, None out
        return None


@lockchecked
class Tracer:
    # Guarded-field registry (tools/tpusc_check TPUSC001 + TPUSC_LOCKCHECK=1).
    _tpusc_guarded = {"_traces": "_lock", "_slow": "_lock"}

    def __init__(
        self,
        capacity: int = 256,
        slow_threshold_s: float = 1.0,
        slow_capacity: int = 64,
    ) -> None:
        self.capacity = capacity
        # tail sampling: roots slower than this survive in _slow even after
        # the main ring wraps; 0 disables the tier
        self.slow_threshold_s = slow_threshold_s
        self.slow_capacity = slow_capacity
        self._lock = threading.Lock()
        self._traces: list[Span] = []
        self._slow: list[Span] = []
        # called (outside the lock) with every root span that enters the
        # slow-retention tier — the SLO-breach trigger for the engine
        # flight recorder (utils/flight_recorder.py). Must never raise
        # into the request; failures are swallowed.
        self.slow_hook = None

    def configure(
        self,
        capacity: int | None = None,
        slow_threshold_s: float | None = None,
        slow_capacity: int | None = None,
    ) -> None:
        """Apply config to the process-wide tracer (server startup)."""
        with self._lock:
            if capacity is not None:
                self.capacity = capacity
            if slow_threshold_s is not None:
                self.slow_threshold_s = slow_threshold_s
            if slow_capacity is not None:
                self.slow_capacity = slow_capacity

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        """Open a span under the ambient parent; a span with no parent is a
        root trace (adopting any inbound remote context) and lands in the
        ring buffer on completion."""
        sp = Span(name=name, attrs=attrs, start_s=time.time(), t0=time.monotonic())
        sp.span_id = _new_span_id()
        parent = _current_span.get()
        if parent is not None:
            sp.trace_id = parent.trace_id
            sp.root = parent.root or parent
        else:
            rp = _remote_parent.get()
            if rp is not None:
                sp.trace_id, sp.parent_id = rp
            else:
                sp.trace_id = _new_trace_id()
            sp.root = sp
        token = _current_span.set(sp)
        try:
            yield sp
        except BaseException as e:
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            sp.duration_s = time.monotonic() - sp.t0
            _current_span.reset(token)
            if parent is not None:
                # list.append is atomic under the GIL; concurrent child spans
                # of one request (gather'd ensures) interleave safely
                parent.children.append(sp)
            else:
                is_slow = False
                with self._lock:
                    self._traces.append(sp)
                    if len(self._traces) > self.capacity:
                        del self._traces[: len(self._traces) - self.capacity]
                    if self.slow_threshold_s and sp.duration_s >= self.slow_threshold_s:
                        is_slow = True
                        self._slow.append(sp)
                        if len(self._slow) > self.slow_capacity:
                            del self._slow[: len(self._slow) - self.slow_capacity]
                hook = self.slow_hook
                if is_slow and hook is not None:
                    try:
                        hook(sp)
                    except Exception:  # noqa: BLE001 — diagnostics stay non-fatal
                        pass

    def annotate(self, **attrs: Any) -> None:
        """Attach attributes to the innermost open span, if any."""
        sp = _current_span.get()
        if sp is not None:
            sp.attrs.update(attrs)

    def annotate_root(self, **attrs: Any) -> None:
        """Attach attributes to the ROOT of the open trace — how deep layers
        label the whole request (the router marking route=forwarded, the
        local backend stamping the model id) without threading a handle."""
        sp = _current_span.get()
        if sp is not None:
            (sp.root or sp).attrs.update(attrs)

    def attach(self, parent: Span, name: str, duration_s: float,
               start_s: float | None = None, **attrs: Any) -> Span:
        """Add a finished child span timed elsewhere under ``parent``: work
        that ran inside a sibling span (the pipelined load's per-leaf
        dequant, inside its transfer) and is counted as a stage of its own.
        The children's sum may then exceed the parent's wall, which is what
        ``cold_overlap_ratio`` measures."""
        sp = Span(name=name, attrs=attrs,
                  start_s=time.time() if start_s is None else start_s,
                  duration_s=duration_s)
        sp.span_id = _new_span_id()
        sp.trace_id = parent.trace_id
        sp.root = parent.root or parent
        parent.children.append(sp)
        return sp

    def attach_remote(self, parent: Span, payload: str | bytes, **attrs: Any) -> Span | None:
        """Graft a peer's serialized finished subtree under ``parent`` (a
        router's ``route`` span), which stitches the two nodes' traces into
        one; None for a payload that does not decode."""
        sp = deserialize_span(payload)
        if sp is None:
            return None
        sp.remote = True
        if not sp.trace_id:
            sp.trace_id = parent.trace_id
        sp.attrs.update(attrs)
        parent.children.append(sp)
        return sp

    def query(
        self,
        n: int = 50,
        min_duration_s: float | None = None,
        trace_id: str | None = None,
    ) -> list[dict[str, Any]]:
        """Most-recent-first completed traces, searching BOTH the main ring
        and the slow-retention tier (so a >threshold trace stays findable
        after fast traffic wraps the ring)."""
        with self._lock:
            spans = list(self._traces)
            seen = {id(s) for s in spans}
            spans.extend(s for s in self._slow if id(s) not in seen)
        spans.sort(key=lambda s: s.start_s)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        if min_duration_s is not None:
            spans = [s for s in spans if s.duration_s >= min_duration_s]
        return [s.to_dict() for s in spans[-n:]][::-1]

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._slow.clear()


# Process-wide default. Diagnostics are write-mostly and bounded, so a global
# (unlike Metrics, which stays injected for registry isolation) keeps every
# call site plumbing-free; tests clear it.
TRACER = Tracer()
