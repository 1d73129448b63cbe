"""The port's request tracing (tfservingcache_tpu_torch/utils/tracing.py)
against the JAX package's (tfservingcache_tpu/utils/tracing.py): traceparent
parsing and formatting, the span wire form (byte-identical payloads for the
same tree), the tracer's ring, query and slow retention, and the JSON log
lines' trace ids. Both tracers run on one fake clock, and their id
generators are seeded alike, so their outputs must be equal, not just
alike."""

import io
import json
import logging

import pytest

from tfservingcache_tpu.utils import logging as jlogging
from tfservingcache_tpu.utils import tracing as jtracing
from tfservingcache_tpu_torch.utils import logging as tlogging
from tfservingcache_tpu_torch.utils import tracing

from torch_obs_globals import confined_globals

PACKAGES = {"jax": jtracing, "port": tracing}


@pytest.fixture(autouse=True)
def _clean_globals():
    with confined_globals():
        yield


class FakeClock:
    """Stands in for the ``time`` module inside a tracing module."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        return 1.7e9 + self.t

    def monotonic(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture()
def clocks(monkeypatch):
    """One fake clock per package, id generators seeded alike."""
    out = {}
    for name, mod in PACKAGES.items():
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", clock)
        mod._rand.seed(1234)
        out[name] = clock
    return out


HEADERS = [
    None, "", "garbage",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "  00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-01  ",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01",
    "zz-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
]


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_matches_the_reference(header):
    got = tracing.parse_traceparent(header)
    assert got == jtracing.parse_traceparent(header)
    if got is not None:
        # a parsed context formats back to the same (lower-case) header
        sp = tracing.Span("x", {}, 0.0, trace_id=got[0], span_id=got[1])
        assert tracing.format_traceparent(sp) == f"00-{got[0]}-{got[1]}-01"


def test_format_traceparent_and_remote_parent_adoption(clocks):
    """Outside a span there is no header; a root opened under
    ``remote_parent`` adopts the caller's trace and records its parent;
    children inherit the trace id, and ``current_ids`` follows the
    innermost span."""
    ctx = ("0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331")
    seen = {}
    for name, mod in PACKAGES.items():
        assert mod.format_traceparent() is None and mod.current_ids() is None
        with mod.remote_parent(ctx), mod.TRACER.span("rest") as root:
            with mod.TRACER.span("infer") as child:
                ids = mod.current_ids()
                header = mod.format_traceparent()
        assert root.trace_id == child.trace_id == ctx[0] and root.parent_id == ctx[1]
        assert ids == (ctx[0], child.span_id)
        assert header == f"00-{ctx[0]}-{child.span_id}-01"
        seen[name] = mod.TRACER.query()
    assert seen["port"] == seen["jax"]


def _tree(mod, n_children: int, attr_len: int):
    root = mod.Span("rest", {"path": "/v1/models/lm/versions/1:predict"}, 1.7e9 + 0.5,
                    duration_s=0.123456789, trace_id="ab" * 16, span_id="cd" * 8,
                    parent_id="ef" * 8)
    for i in range(n_children):
        c = mod.Span(f"stage{i}", {"blob": "x" * attr_len, "i": i}, 1.7e9 + 0.5 + i,
                     duration_s=0.001 * i, trace_id=root.trace_id, span_id=f"{i:016x}",
                     error="ValueError: boom" if i == 1 else "")
        c.children.append(mod.Span("leaf", {}, 1.7e9 + 1, duration_s=1e-7,
                                   trace_id=root.trace_id, span_id=f"{i + 100:016x}"))
        root.children.append(c)
    return root


@pytest.mark.parametrize("n_children,attr_len", [(0, 0), (3, 10), (40, 50), (400, 400)])
def test_serialize_span_is_byte_identical_to_the_reference(n_children, attr_len):
    """The wire payload for the same tree is the reference's byte for byte,
    in all three of its forms: whole, attrs stripped, root-only stub."""
    got = tracing.serialize_span(_tree(tracing, n_children, attr_len))
    want = jtracing.serialize_span(_tree(jtracing, n_children, attr_len))
    assert got == want
    assert len(got) <= tracing.WIRE_TRACE_LIMIT


def test_deserialize_span_of_the_reference_payload():
    payload = jtracing.serialize_span(_tree(jtracing, 3, 10))
    sp = tracing.deserialize_span(payload)
    assert sp is not None
    assert sp.to_dict() == jtracing.deserialize_span(payload).to_dict()
    assert sp.to_dict() == _tree(tracing, 3, 10).to_dict()
    for bad in ("", "!!!", b"not-zlib", "eJzLSM3JyQcABiwCFQ=="):  # the last: zlib of "hello"
        assert tracing.deserialize_span(bad) is None
        assert jtracing.deserialize_span(bad) is None


def _drive(mod, clock):
    """Six roots, three with children, one failed; the second is slow."""
    tracer = mod.Tracer(capacity=4, slow_threshold_s=0.5, slow_capacity=2)
    slow_seen = []
    tracer.slow_hook = lambda sp: slow_seen.append(sp.name)
    durations = [0.01, 0.9, 0.03, 0.04, 0.05, 0.06]
    for i, d in enumerate(durations):
        try:
            with tracer.span(f"req{i}", i=i):
                if i % 2:
                    with tracer.span("child"):
                        clock.advance(d / 2)
                        tracer.annotate(note=i)
                        tracer.annotate_root(route="local")
                clock.advance(d / 2 if i % 2 else d)
                if i == 5:
                    raise KeyError("x")
        except KeyError:
            pass
        clock.advance(1.0)
    return tracer, slow_seen


def test_query_ring_and_slow_retention_match_the_reference(clocks):
    """The ring keeps the last ``capacity`` roots; a root past the slow
    threshold survives the wrap in the slow tier, reaches ``slow_hook``
    once, and ``query`` searches both tiers by ``n``, ``min_duration_s``
    and ``trace_id``."""
    out = {name: _drive(mod, clocks[name]) for name, mod in PACKAGES.items()}
    (tp, slow_p), (tj, slow_j) = out["port"], out["jax"]
    assert slow_p == slow_j == ["req1"]
    everything = tp.query(n=50)
    assert everything == tj.query(n=50)
    assert [t["name"] for t in everything] == ["req5", "req4", "req3", "req2", "req1"]
    assert everything[0]["error"] == "KeyError: 'x'"
    assert everything[0]["attrs"] == {"i": 5, "route": "local"}
    assert everything[0]["children"][0]["attrs"] == {"note": 5}
    for kw in ({"n": 2}, {"min_duration_s": 0.5}, {"min_duration_s": 0.04},
               {"trace_id": everything[2]["trace_id"]}, {"trace_id": "nope"}):
        assert tp.query(**kw) == tj.query(**kw), kw
    assert [t["name"] for t in tp.query(min_duration_s=0.5)] == ["req1"]
    tp.clear()
    assert tp.query() == []


def test_json_log_lines_carry_trace_ids_like_the_reference(clocks):
    lines = {}
    for name, mod, logmod in (("jax", jtracing, jlogging), ("port", tracing, tlogging)):
        buf = io.StringIO()
        handler = logging.StreamHandler(buf)
        handler.setFormatter(logmod.JsonFormatter())
        lg = logging.getLogger(f"obs_parity_{name}")
        lg.addHandler(handler)
        lg.propagate = False
        lg.setLevel(logging.INFO)
        try:
            lg.info("outside", extra={"k": 1})
            with mod.TRACER.span("rest"):
                lg.info("inside %s", "x", extra={"model": "lm@1"})
        finally:
            lg.removeHandler(handler)
        lines[name] = [json.loads(s) for s in buf.getvalue().splitlines()]
    for rec in lines["port"] + lines["jax"]:
        rec.pop("time")
        rec.pop("logger")
    assert lines["port"] == lines["jax"]
    assert "trace_id" not in lines["port"][0] and lines["port"][1]["model"] == "lm@1"
    assert len(lines["port"][1]["trace_id"]) == 32 and len(lines["port"][1]["span"]) == 16
    assert tlogging.get_logger("x").name == "tpusc_torch.x"
