"""Observability on a served port node against a reference node, on the
CPU: the same artifact and the same schedule of requests go to a port
``CacheNode`` (``server.build_node``, stdlib REST) and to a reference node
built as tests/test_observability.py builds its nodes (manager + local
backend + aiohttp REST, here on an event loop of its own thread), both with
the continuous engine over a 12-page arena. The schedule: three ``:predict``
calls, a ``:generate`` with a chunked prefill, a two-turn conversation (the
second turn resumes), one ``?stream=true`` call, one preemption and one
``kill_engine`` drill. Then both nodes are scraped:

- the deterministic families are equal (requests, cache hits and misses,
  wasted steps, prefix hits by kind, preemptions, prefill chunks,
  ``kv_resume`` by outcome, stream frames, recovered rows, ...);
- the flight recorder's rows are equal column for column (apart from the
  clocks), and the port's rows with a chunk are the chunks its engine
  dispatched;
- ``/monitoring/traces`` has a ``rest`` root per request, the cold one with
  ``ensure_servable`` and ``infer`` beneath it;
- the kill drill recovers the rows in flight and writes one crash dump.

TINY f32 (2 layers, 4 heads / 2 KV heads, d_model 48, vocab 97), so greedy
tokens are identical between the packages. Every directory is the test's
own; the profiler's 400 and 409 paths run without a capture."""

import asyncio
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskProvider
from tfservingcache_tpu.cluster.status import NodeStatus as JNodeStatus
from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.lab import faults as jfaults
from tfservingcache_tpu.models.registry import export_artifact
from tfservingcache_tpu.protocol.local_backend import LocalServingBackend as JBackend
from tfservingcache_tpu.protocol.rest import RestServingServer as JRest
from tfservingcache_tpu.runtime import batcher as jbatcher
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu.utils import flight_recorder as jflight
from tfservingcache_tpu.utils import tracing as jtracing
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.lab import faults
from tfservingcache_tpu_torch.runtime import batcher as tbatcher
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import ModelId
from tfservingcache_tpu_torch.utils import flight_recorder, tracing

from torch_obs_globals import confined_globals

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
PATH = "/monitoring/prometheus/metrics"
ENGINE = dict(generate_engine="continuous", generate_slots=4, generate_chunk_tokens=1,
              kv_page_tokens=8, kv_arena_pages=12, prefill_chunk_tokens=8,
              conversation_kv_bytes=1 << 24)
KILL = {"kind": "kill_engine", "after": 3, "count": 1}


class RefNode:
    """The reference's node parts on an event loop of their own."""

    def __init__(self, store, tmp_path):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.metrics = JMetrics()
        self.runtime = TPUModelRuntime(JServingConfig(platform="cpu"), self.metrics)
        self.manager = JCacheManager(JDiskProvider(str(store)),
                                     JDiskCache(str(tmp_path / "jax_cache"), capacity_bytes=1 << 30),
                                     self.runtime, self.metrics)
        self.backend = JBackend(self.manager, conversation_kv_dir=str(tmp_path / "jax_conv"),
                                **{k: v for k, v in ENGINE.items()})
        self.rest = JRest(self.backend, self.metrics, require_version=False, metrics_path=PATH)
        port = self._run(self.rest.start(0, host="127.0.0.1"))
        self.url = f"http://127.0.0.1:{port}"
        self.engine = self.backend._generator

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def close(self):
        try:
            self.backend.close()
            self._run(self.rest.close())
            self.manager.close()
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()


def post(url, body=None, method="POST"):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def schedule(url, engine, mid, batcher_mod, lab) -> dict:
    """The shared schedule, one request at a time; -> what each step answered."""
    model = f"{url}/v1/models/lm/versions/1"
    out: dict = {}
    ids = np.random.default_rng(11).integers(1, 97, (2, 9)).tolist()
    out["predict"] = [post(f"{model}:predict", {"instances": ids}) for _ in range(3)]
    # one chunked prefill: 20 prompt tokens in chunks of 8
    out["chunked"] = post(f"{model}:generate",
                          {"input_ids": [list(range(1, 21))], "max_new_tokens": 6})
    # a conversation: turn 1 (chunked, parked at retirement), turn 2 resumes
    turn = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    conv = []
    for _ in range(2):
        status, body = post(f"{model}:generate", {"input_ids": [turn], "max_new_tokens": 6,
                                                  "conversation_id": "c"})
        conv.append((status, body))
        turn = turn + json.loads(body)["tokens"][0] + [7]
    out["conversation"] = conv
    out["stream"] = post(f"{model}:generate?stream=true",
                         {"input_ids": [[2, 7, 1, 8, 2]], "max_new_tokens": 5})
    # one preemption (tests/test_torch_slo_engine.py's schedule): three rows
    # fill the arena, a high row arrives when the newest low row has 4 tokens
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 97, 16).astype(np.int32) for _ in range(4)]
    classes = ["normal", "low", "low", "high"]
    reqs = [batcher_mod._ContinuousReq(prompt=p, max_new=16, temperature=0.0, top_k=0,
                                       priority=c, rank=tbatcher.PRIORITY_RANKS[c], seq=1000 + i)
            for i, (p, c) in enumerate(zip(prompts, classes))]

    def arrive(_t):
        if len(reqs[2].tokens) == 4:
            engine._sched(mid).submit([reqs[3]])

    reqs[2].on_token = arrive
    engine._sched(mid).submit(reqs[:3])
    for r in reqs:
        assert r.done.wait(120) and r.error is None
    out["preempted"] = [(list(r.tokens), r.preemptions) for r in reqs]
    # the kill drill: two rows, the scheduler killed at its 4th boundary
    lab.arm([lab.FaultSpec(**KILL)])
    try:
        out["killed"] = post(f"{model}:generate", {"input_ids": ids, "max_new_tokens": 12})
    finally:
        lab.disarm()
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both nodes through the schedule; -> (port results, reference results),
    each with the node's scrape, engine snapshot and traces."""
    tmp = tmp_path_factory.mktemp("obs")
    store = tmp / "store"
    export_artifact("transformer_lm", str(store), name="lm", version=1, config=TINY, seed=3)
    with confined_globals():
        jflight.RECORDER.configure(flight_dir=str(tmp / "jax_flight"))
        flight_recorder.RECORDER.configure(flight_dir=str(tmp / "port_flight"))
        results = {}
        ref = RefNode(store, tmp)
        try:
            results["jax"] = schedule(ref.url, ref.engine, JModelId("lm", 1), jbatcher, jfaults)
            # the reference releases a row before its boundary's record
            _wait_idle(ref.engine, JModelId("lm", 1))
            results["jax"].update(_read_node(ref.url), flight=tmp / "jax_flight")
        finally:
            ref.close()
        cfg = config_from_dict({
            "serving": dict(ENGINE, conversation_kv_dir=str(tmp / "port_conv")),
            "cache": {"base_dir": str(tmp / "port_cache")},
            "model_provider": {"base_dir": str(store)},
            "cache_node": {"rest_port": 0, "grpc_port": 0},
        })
        node = build_node(cfg, device="cpu")
        try:
            url = f"http://127.0.0.1:{node.start('127.0.0.1')}"
            results["port"] = schedule(url, node.engine, ModelId("lm", 1), tbatcher, faults)
            results["port"].update(_read_node(url), flight=tmp / "port_flight", node=node,
                                   url=url, recovered=node.engine.recovered,
                                   chunks=node.engine.chunks)
            yield results["port"], results["jax"]
        finally:
            node.close()


def _wait_idle(engine, mid) -> None:
    """Until the model's scheduler thread waits for work (its last boundary
    is done and recorded)."""
    deadline = time.monotonic() + 60
    sched = engine._scheds[mid]
    while not (sched.cv._waiters and not sched.pending):
        assert time.monotonic() < deadline, "the scheduler never went idle"
        time.sleep(0.01)
        sched = engine._scheds[mid]


def _read_node(url) -> dict:
    """The node's scrape, once no request is in flight (a stream is counted
    when its drain ends, after the client has its last frame), its engine
    snapshot and its traces."""
    deadline = time.monotonic() + 60
    while True:
        status, body = post(url + PATH, method="GET")
        assert status == 200
        families = {}
        for fam in text_string_to_metric_families(body.decode()):
            if not fam.name.endswith("_created"):
                families[fam.name] = {(s.name, tuple(sorted(s.labels.items()))): s.value
                                      for s in fam.samples if not s.name.endswith("_created")}
        busy = families["tpusc_requests_in_flight"].get(
            ("tpusc_requests_in_flight", (("protocol", "rest"),)), 0.0)
        if not busy:
            break
        assert time.monotonic() < deadline, "a request stayed in flight"
        time.sleep(0.01)
    status, eng = post(url + "/monitoring/engine?n=256&reset=0", method="GET")
    assert status == 200
    status, traces = post(url + "/monitoring/traces?n=100", method="GET")
    assert status == 200
    return {"families": families, "engine": json.loads(eng),
            "traces": json.loads(traces)["traces"]}


def test_the_schedule_answers_alike(served):
    port, ref = served
    for key in ("predict", "chunked", "conversation", "stream", "killed"):
        got, want = port[key], ref[key]
        if key == "predict":
            for (gs, gb), (ws, wb) in zip(got, want):
                assert gs == ws == 200
                np.testing.assert_allclose(json.loads(gb)["predictions"],
                                           json.loads(wb)["predictions"], atol=1e-4)
            continue
        if key == "conversation":
            assert [(s, json.loads(b)) for s, b in got] == [(s, json.loads(b)) for s, b in want]
            continue
        assert got[0] == want[0] == 200, (key, got, want)
        assert got[1] == want[1] if key == "stream" else json.loads(got[1]) == json.loads(want[1])
    assert port["preempted"] == ref["preempted"]
    assert [p for _, p in port["preempted"]] == [0, 0, 1, 0]


DETERMINISTIC = [
    "tfservingcache_proxy_requests", "tfservingcache_proxy_failures",
    "tfservingcache_cache", "tfservingcache_cache_hits", "tfservingcache_cache_misses",
    "tpusc_reload_source", "tpusc_requests_in_flight", "tpusc_batcher_queue_depth",
    "tpusc_gen_slots_active", "tpusc_gen_wasted_steps", "tpusc_gen_prefix_hits",
    "tpusc_gen_preemptions", "tpusc_gen_prefill_chunks", "tpusc_kv_resume",
    "tpusc_gen_stream_frames", "tpusc_requests_recovered", "tpusc_gen_kv_pages_used",
    "tpusc_gen_kv_pages_total", "tpusc_gen_kv_pages_shared", "tpusc_gen_kv_page_waste_tokens",
    "tpusc_kv_parked_conversations", "tpusc_models_resident", "tpusc_disk_cache_bytes_in_use",
]
COUNTED = ["tpusc_request_duration_seconds", "tpusc_gen_admission_wait_seconds",
           "tpusc_request_phase_seconds", "tfservingcache_cache_duration_seconds",
           "tfservingcache_cache_fetch_duration_seconds"]


@pytest.mark.parametrize("family", DETERMINISTIC)
def test_deterministic_family_equals_the_reference(served, family):
    port, ref = served
    assert port["families"][family] == ref["families"][family]


@pytest.mark.parametrize("family", COUNTED)
def test_timed_family_counts_equal_the_reference(served, family):
    """Histograms of wall time: the sample counts (not the buckets) match."""
    port, ref = served

    def counts(fam):
        return {k: v for k, v in fam.items() if k[0].endswith("_count")}

    assert counts(port["families"][family]) == counts(ref["families"][family])


def test_the_schedule_moves_the_families_it_should(served):
    fams = served[0]["families"]

    def val(family, sample, **labels):
        return fams[family][(sample, tuple(sorted(labels.items())))]

    assert val("tfservingcache_proxy_requests", "tfservingcache_proxy_requests_total",
               protocol="rest") == 8
    assert val("tfservingcache_cache_misses", "tfservingcache_cache_misses_total",
               model="all_models") == 1
    assert val("tpusc_gen_prefix_hits", "tpusc_gen_prefix_hits_total",
               engine="continuous", kind="resume") >= 1
    assert val("tpusc_kv_resume", "tpusc_kv_resume_total", outcome="hit") == 1
    assert val("tpusc_gen_preemptions", "tpusc_gen_preemptions_total", **{"class": "low"}) == 1
    assert val("tpusc_gen_prefill_chunks", "tpusc_gen_prefill_chunks_total") >= 3
    assert val("tpusc_gen_stream_frames", "tpusc_gen_stream_frames_total", protocol="sse") == 6
    assert val("tpusc_requests_recovered", "tpusc_requests_recovered_total",
               reason="mid_decode") == 2 == served[0]["recovered"]
    assert val("tpusc_gen_kv_pages_used", "tpusc_gen_kv_pages_used") == 0


STEP_COLUMNS = ("engine", "chunk", "active", "admitted", "retired", "pages_used", "pages_free",
                "wasted", "queue_depth", "pages_shared", "prefix_hits", "drafted", "accepted")


def test_engine_rows_equal_the_reference_and_the_dispatched_chunks(served):
    port, ref = served

    def rows(snap):
        (model,) = snap["models"]
        return [tuple(s[c] for c in STEP_COLUMNS) for s in snap["models"][model]["steps"]]

    got, want = rows(port["engine"]), rows(ref["engine"])
    assert got == want
    assert port["engine"]["models"]["lm@1"]["recorded_steps"] == len(got) < 256
    # a row with a chunk is one dispatched decode chunk
    assert sum(1 for r in got if r[1] > 0) == port["chunks"]
    assert port["engine"]["watermarks"]["gen_kv_pages_used"] == 12.0
    phases = port["engine"]["phases"]["lm@1"]
    assert sum("preempt_park" in p["phases"] for p in phases) == 1
    assert {ph for p in phases for ph in p["phases"]} == {"queue", "prefill", "decode",
                                                         "respond", "preempt_park"}


def _tree_names(d) -> set[str]:
    out = {d["name"]}
    for c in d.get("children", ()):
        out |= _tree_names(c)
    return out


def test_traces_hold_a_rest_root_per_request(served):
    port, ref = served
    got, want = port["traces"][::-1], ref["traces"][::-1]  # oldest first
    assert [t["name"] for t in got] == ["rest"] * 8
    assert len(want) == 8
    for g, w in zip(got, want):
        assert g["attrs"]["route"] == w["attrs"]["route"] == "local"
        assert g["attrs"]["model"] == w["attrs"]["model"] == "lm@1"
        assert g["attrs"]["path"] == w["attrs"]["path"]
        assert _tree_names(g) <= _tree_names(w) | {"generate"}
    cold = _tree_names(got[0])
    assert {"ensure_servable", "provider_fetch", "load", "artifact_read", "device_transfer",
            "infer"} <= cold
    assert all("infer" in _tree_names(t) for t in got[:3])
    # the engine's attribution lands on the generate roots
    assert all("phase_decode_ms" in t["attrs"] and "ttft_ms" in t["attrs"] for t in got[3:])


def test_the_kill_drill_writes_one_crash_dump(served):
    port, ref = served

    def reasons(flight_dir):
        return sorted(f.split("_", 3)[-1][:-5] for f in os.listdir(flight_dir))

    # the firing itself writes one fault_injected dump, as the reference's does
    assert reasons(port["flight"]) == ["engine_crash", "fault_injected:kill_engine",
                                       "page_exhaustion"]
    assert reasons(ref["flight"]).count("engine_crash") == 1
    assert reasons(ref["flight"]).count("fault_injected:kill_engine") == 1
    crash = next(f for f in os.listdir(port["flight"]) if "engine_crash" in f)
    ctx = json.loads((port["flight"] / crash).read_text())["context"]
    assert ctx["recovered_rows"] == 2 and ctx["failed_rows"] == 0
    assert port["engine"]["dumps"] == sorted(os.listdir(port["flight"]))


def test_monitoring_endpoints_answer_like_the_reference(served):
    port, _ref = served
    url = port["url"]
    # a node (no router) has no fleet view: the reference's 404 body
    for path in ("/monitoring/cluster", "/monitoring/traces?n=x",
                 "/monitoring/traces?min_ms=x", "/monitoring/engine?n=x",
                 "/monitoring/tenants?top=x"):
        status, body = post(url + path, method="GET")
        assert status in (400, 404), path
        assert "error" in json.loads(body)
    # the node's own status, as a reference node answers it (its collector
    # is named by the node's bound ports)
    status, body = post(url + "/monitoring/status", method="GET")
    st = json.loads(body)
    assert status == 200 and set(st) == set(JNodeStatus(ident="x").to_dict())
    assert st["ident"] == port["node"].groups[0].status.ident and "lm##1" in st["models"]
    status, body = post(url + "/monitoring/tenants?top=1", method="GET")
    snap = json.loads(body)
    assert status == 200 and snap["top"] == ["lm@1"]
    assert snap["tenants"]["lm@1"]["totals"]["tokens_out"] > 0
    assert snap["tenants"]["lm@1"]["loads"]["store"]["count"] == 1
    # a consuming engine read resets the watermarks; the rows stay
    first = json.loads(post(url + "/monitoring/engine?n=16", method="GET")[1])
    again = json.loads(post(url + "/monitoring/engine?n=16", method="GET")[1])
    assert first["watermarks"] and not again["watermarks"]
    assert len(again["models"]["lm@1"]["steps"]) == 16


def test_profiler_400_and_409_without_a_capture(served, tmp_path):
    port, _ref = served
    url, rest = port["url"], port["node"].rest
    rest.profiler_base_dir = str(tmp_path / "profiles")
    for query in ("duration_s=nope", "label=../escape", "label=.hidden", "label=" + "a" * 65):
        status, body = post(f"{url}/monitoring/profiler?{query}")
        assert status == 400 and "error" in json.loads(body), query
    assert rest._profile_lock.acquire(blocking=False)
    try:
        status, body = post(f"{url}/monitoring/profiler?duration_s=0.01")
        assert status == 409 and "in progress" in json.loads(body)["error"]
    finally:
        rest._profile_lock.release()
    assert not os.path.exists(tmp_path / "profiles")
    # a GET is not the profiler: it falls through to the model URLs (404)
    assert post(f"{url}/monitoring/profiler", method="GET")[0] == 404


def test_traceparent_joins_the_callers_trace_and_gets_the_subtree_back(served):
    port, _ref = served
    ctx = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    req = urllib.request.Request(f"{port['url']}/v1/models/lm/versions/1:predict",
                                 data=json.dumps({"instances": [[1, 2, 3]]}).encode(),
                                 method="POST", headers={"traceparent": ctx})
    with urllib.request.urlopen(req, timeout=60) as resp:
        blob = resp.headers["x-tpusc-trace"]
    sp = tracing.deserialize_span(blob)
    assert sp.name == "rest" and sp.trace_id == "0af7651916cd43dd8448eb211c80319c"
    assert sp.parent_id == "b7ad6b7169203331" and "infer" in {c.name for c in sp.children}
    assert jtracing.deserialize_span(blob).to_dict() == sp.to_dict()


def test_default_flight_and_profiler_dirs_lie_under_the_temp_dir(monkeypatch, tmp_path):
    """ROADMAP C7: the reference's defaults are the fixed
    ``/tmp/tpusc_flight`` and ``/tmp/tpusc_profile``, which every process on
    a machine would share (the spool deletes dumps past ``max_dumps``); the
    port's follow the process's temporary directory."""
    import tempfile

    from tfservingcache_tpu.config import ObservabilityConfig as JObservabilityConfig
    from tfservingcache_tpu_torch.config import Config
    from tfservingcache_tpu_torch.protocol.rest import RestServingServer

    assert JObservabilityConfig().flight_dir == "/tmp/tpusc_flight"
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("TPUSC_PROFILER_DIR", raising=False)
    assert Config().observability.flight_dir == str(tmp_path / "tpusc_flight")
    assert RestServingServer(None).profiler_base_dir == str(tmp_path / "tpusc_profile")
    monkeypatch.setenv("TPUSC_PROFILER_DIR", str(tmp_path / "elsewhere"))
    assert RestServingServer(None).profiler_base_dir == str(tmp_path / "elsewhere")
    assert RestServingServer(None, profiler_base_dir="/x").profiler_base_dir == "/x"
