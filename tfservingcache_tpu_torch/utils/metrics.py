"""Prometheus metrics on the standard library (counterpart of
``tfservingcache_tpu/utils/metrics.py``, which builds on ``prometheus_client``;
the card's machine need not have that package).

``Metrics`` keeps the reference's family names, types, HELP text, label
names, histogram buckets and counter ``_total`` rule, so dashboards built on
the reference read a port node unchanged; ``render()`` writes text
exposition format 0.0.4, as ``prometheus_client.generate_latest`` does, less
the ``*_created`` timestamp series. A family is registered here only once
the port fires it (the group families come with the modules that fire
them). ``scrape_and_merge`` folds sidecar
exporters into a node's exposition with a stdlib copy of
``prometheus_client``'s text parser, so its output is the reference's.
"""

from __future__ import annotations

import logging
import math
import re
import string
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, NamedTuple

log = logging.getLogger("tpusc_torch.metrics")

ALL_MODELS = "all_models"
# Cardinality-overflow bucket: once max_model_labels distinct name:version
# values exist, NEW tenants fold here so a 1000-tenant churn cannot explode
# every {model=...} family. Established labels keep resolving.
OTHER_MODELS = "__other__"
DEFAULT_MAX_MODEL_LABELS = 512

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_INF = float("inf")


def _go_float(d: float) -> str:
    """A sample value as the Go client (and ``prometheus_client``) writes it."""
    d = float(d)
    if d == _INF:
        return "+Inf"
    if d == -_INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:  # Go switches to an exponent sooner than Python
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _labelstr(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())) + "}"


class Registry:
    """The families of one ``Metrics``, in registration order."""

    def __init__(self) -> None:
        self._families: list[_Family] = []
        self._names: set[str] = set()
        self._lock = threading.Lock()

    def register(self, fam: "_Family") -> None:
        with self._lock:
            if fam.name in self._names:
                raise ValueError(f"duplicated metric family {fam.name!r}")
            self._names.add(fam.name)
            self._families.append(fam)

    def family_total(self, name: str) -> float:
        """The sum of a counter's or gauge's series over every label set
        (the value of its ``<name>_total`` or bare samples); 0 for a name
        not registered or a histogram."""
        with self._lock:
            fam = next((f for f in self._families if f.name == name), None)
        if fam is None or fam.type == "histogram":
            return 0.0
        with fam.lock:
            return sum(c.value for c in fam._children.values())

    def render(self) -> bytes:
        with self._lock:
            families = list(self._families)
        lines: list[str] = []
        for fam in families:
            fam.render_into(lines)
        return ("\n".join(lines) + "\n").encode() if lines else b""


class _Child:
    """One labelled series: a value (counter, gauge) or bucket counts + sum
    (histogram). Mutated under its family's lock."""

    __slots__ = ("_fam", "value", "counts", "sum")

    def __init__(self, fam: "_Family") -> None:
        self._fam = fam
        self.value = 0.0
        self.counts = [0.0] * len(fam.buckets) if fam.buckets else None
        self.sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if self._fam.type == "histogram":
            raise AttributeError("a histogram has no inc()")
        if self._fam.type == "counter" and amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        with self._fam.lock:
            self.value += float(amount)

    def dec(self, amount: float = 1.0) -> None:
        if self._fam.type != "gauge":
            raise AttributeError(f"a {self._fam.type} has no dec()")
        with self._fam.lock:
            self.value -= float(amount)

    def set(self, value: float) -> None:
        if self._fam.type != "gauge":
            raise AttributeError(f"a {self._fam.type} has no set()")
        with self._fam.lock:
            self.value = float(value)

    def observe(self, amount: float) -> None:
        if self._fam.type != "histogram":
            raise AttributeError(f"a {self._fam.type} has no observe()")
        amount = float(amount)
        with self._fam.lock:
            self.sum += amount
            for i, bound in enumerate(self._fam.buckets):
                if amount <= bound:
                    self.counts[i] += 1.0
                    break


class _Family:
    """A metric family: name, HELP text, label names and a child series per
    label-value tuple. An unlabelled family has its one series from the
    start (it renders as 0 before any write); a labelled one renders a
    series once ``labels(...)`` has made it."""

    def __init__(self, typ: str, name: str, documentation: str,
                 labelnames: list[str] | tuple[str, ...] = (),
                 registry: Registry | None = None,
                 buckets: tuple[float, ...] | None = None) -> None:
        if typ == "counter" and name.endswith("_total"):
            name = name[: -len("_total")]
        self.type = typ
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self.buckets: tuple[float, ...] | None = None
        if typ == "histogram":
            bounds = [float(b) for b in buckets]
            if bounds != sorted(bounds):
                raise ValueError("histogram buckets must be in sorted order")
            if not bounds or bounds[-1] != _INF:
                bounds.append(_INF)
            self.buckets = tuple(bounds)
        self.lock = threading.Lock()
        self._children: dict[tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(self)
        if registry is not None:
            registry.register(self)

    def labels(self, *values: Any, **kw: Any) -> _Child:
        if not self.labelnames:
            raise ValueError(f"no labels on metric {self.name!r}")
        if values and kw:
            raise ValueError("labels: positional or keyword values, not both")
        if kw:
            if set(kw) != set(self.labelnames):
                raise ValueError(f"incorrect label names {sorted(kw)} for {self.name!r}")
            values = tuple(kw[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(f"incorrect label count for {self.name!r}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self.lock:
                child = self._children.setdefault(key, _Child(self))
        return child

    def remove(self, *values: Any) -> None:
        """Drop one labelled series (KeyError when it does not exist)."""
        key = tuple(str(v) for v in values)
        with self.lock:
            del self._children[key]

    def clear(self) -> None:
        """Drop every labelled series."""
        with self.lock:
            if self.labelnames:
                self._children.clear()

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} needs labels({', '.join(self.labelnames)})")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def render_into(self, out: list[str]) -> None:
        name = self.name + "_total" if self.type == "counter" else self.name
        out.append(f"# HELP {name} {_escape_help(self.documentation)}")
        out.append(f"# TYPE {name} {self.type}")
        with self.lock:
            series = [(k, c.value, list(c.counts) if c.counts else None, c.sum)
                      for k, c in self._children.items()]
        for key, value, counts, total in series:
            # label pairs sorted by name, as generate_latest writes them
            labels = dict(zip(self.labelnames, key))
            if self.type != "histogram":
                out.append(f"{name}{_labelstr(labels)} {_go_float(value)}")
                continue
            acc = 0.0
            for bound, n in zip(self.buckets, counts):
                acc += n
                lbl = _labelstr({**labels, "le": _go_float(bound)})
                out.append(f"{name}_bucket{lbl} {_go_float(acc)}")
            lbl = _labelstr(labels)
            out.append(f"{name}_count{lbl} {_go_float(acc)}")
            out.append(f"{name}_sum{lbl} {_go_float(total)}")


def Counter(name: str, documentation: str, labelnames=(), registry=None) -> _Family:  # noqa: N802
    return _Family("counter", name, documentation, labelnames, registry)


def Gauge(name: str, documentation: str, labelnames=(), registry=None) -> _Family:  # noqa: N802
    return _Family("gauge", name, documentation, labelnames, registry)


def Histogram(name: str, documentation: str, labelnames=(), registry=None,  # noqa: N802
              buckets: tuple[float, ...] = (.005, .01, .025, .05, .075, .1, .25, .5,
                                            .75, 1.0, 2.5, 5.0, 7.5, 10.0)) -> _Family:
    return _Family("histogram", name, documentation, labelnames, registry, buckets)


class Metrics:
    """One instance per node; injected (no globals, so tests can build many
    nodes in-process without collisions)."""

    def __init__(
        self,
        model_labels: bool = False,
        max_model_labels: int = DEFAULT_MAX_MODEL_LABELS,
    ) -> None:
        self.registry = Registry()
        self.model_labels = model_labels
        self.max_model_labels = max(1, int(max_model_labels))
        # distinct labels handed out; set.add is GIL-atomic, so a racy
        # concurrent first-sighting can overshoot the cap by a label or two
        # — acceptable, the cap bounds growth, it is not a hard quota
        self._seen_model_labels: set[str] = set()
        r = self.registry
        # names, HELP text, labels and buckets are the reference's (the
        # exposed counter names end in "_total")
        self.request_count = Counter(
            "tfservingcache_proxy_requests", "The total number of requests", ["protocol"], registry=r
        )
        self.request_failures = Counter(
            "tfservingcache_proxy_failures", "The total number of failed requests", ["protocol"], registry=r
        )
        self.request_duration = Histogram(
            "tpusc_request_duration_seconds",
            "End-to-end request latency as the client experienced it "
            "(protocol=rest|grpc, verb=predict|classify|regress|generate|"
            "metadata|status|..., outcome=ok|error, route=local|forwarded)",
            ["protocol", "verb", "outcome", "route"],
            registry=r,
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1, 2.5, 5, 10, 30, 60),
        )
        self.requests_in_flight = Gauge(
            "tpusc_requests_in_flight",
            "Requests currently being served (admitted, response not yet sent)",
            ["protocol"], registry=r,
        )
        self.batcher_queue_depth = Gauge(
            "tpusc_batcher_queue_depth",
            "Requests parked in a forming micro-batch, waiting for the "
            "device gate (kind = predict | generate)",
            ["kind"], registry=r,
        )
        self.cache_total = Counter(
            "tfservingcache_cache", "Cache lookups", ["model"], registry=r
        )
        self.cache_hits = Counter(
            "tfservingcache_cache_hits", "Cache hits", ["model"], registry=r
        )
        self.cache_misses = Counter(
            "tfservingcache_cache_misses", "Cache misses", ["model"], registry=r
        )
        self.cache_duration = Histogram(
            "tfservingcache_cache_duration_seconds",
            "Total time spent ensuring a model is servable",
            ["model"],
            registry=r,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30, 60),
        )
        self.cache_fetch_duration = Histogram(
            "tfservingcache_cache_fetch_duration_seconds",
            "Time spent fetching model artifacts from the provider",
            ["model"],
            registry=r,
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30, 60),
        )
        # labelled by device group, as the reference labels its chip groups
        self.hbm_bytes_in_use = Gauge(
            "tpusc_hbm_bytes_in_use", "Bytes of HBM pinned by resident models",
            ["group"], registry=r,
        )
        # high-water twin, backed by the flight recorder's watermarks:
        # reading GET /monitoring/engine resets the marks
        self.hbm_bytes_peak = Gauge(
            "tpusc_hbm_bytes_peak",
            "High-water HBM bytes pinned by resident models since the last "
            "/monitoring/engine scrape",
            ["group"], registry=r,
        )
        self.models_resident = Gauge(
            "tpusc_models_resident", "Models currently AVAILABLE in the runtime",
            ["group"], registry=r,
        )
        self.disk_bytes_in_use = Gauge(
            "tpusc_disk_cache_bytes_in_use", "Bytes used by the disk artifact cache", registry=r
        )
        self.evictions = Counter(
            "tpusc_evictions_total", "Evictions", ["tier"], registry=r
        )
        self.reload_source = Counter(
            "tpusc_reload_source",
            "ensure_servable resolutions by serving tier "
            "(tier = hbm | host | disk | store | peer)",
            ["tier"], registry=r,
        )
        # the host-RAM warm tier (cache/host_tier.py)
        self.host_tier_bytes = Gauge(
            "tpusc_host_tier_bytes",
            "Host DRAM held by the warm tier's packed parameter chunks",
            registry=r,
        )
        self.host_tier_bytes_peak = Gauge(
            "tpusc_host_tier_bytes_peak",
            "High-water warm-tier DRAM bytes since the last "
            "/monitoring/engine scrape (reset-on-scrape)",
            registry=r,
        )
        # the batchers (runtime/batcher.py): how often requests coalesce and
        # how many ride each device call (kind = predict | generate)
        self.coalesced_batches = Counter(
            "tpusc_coalesced_batches", "Multi-request device calls",
            ["kind"], registry=r,
        )
        self.coalesced_requests = Counter(
            "tpusc_coalesced_requests", "Requests served via a coalesced call",
            ["kind"], registry=r,
        )
        # continuous engine (runtime/batcher.py); model label only with
        # metrics.model_labels, else one all_models series
        self.gen_slots_active = Gauge(
            "tpusc_gen_slots_active",
            "Decode slots currently occupied by in-flight generate requests "
            "(per model when model_labels is on, else one all_models series "
            "summed across models; capacity is serving.generate_slots per "
            "model)",
            ["model"], registry=r,
        )
        self.gen_wasted_steps = Counter(
            "tpusc_gen_wasted_steps",
            "Decode steps computed for a row AFTER its request already "
            "finished (EOS or its own max_new_tokens): batch-drain padding "
            "under coalesce, chunk overshoot (< chunk size) under continuous",
            ["engine"], registry=r,
        )
        self.gen_admission_wait = Histogram(
            "tpusc_gen_admission_wait_seconds",
            "Time a generate request waited before decoding began on its "
            "behalf: slot-free wait under continuous, in-flight gate stall "
            "under coalesce",
            ["engine"], registry=r,
            buckets=(.0005, .001, .0025, .005, .01, .025, .05, .1, .25,
                     .5, 1, 2.5, 5, 10),
        )
        # the live view of admission starvation, set at every boundary
        self.gen_oldest_queued_age = Gauge(
            "tpusc_gen_oldest_queued_age_seconds",
            "Age of the oldest generate request still waiting for admission "
            "(slot or KV-page starvation shows here BEFORE the request "
            "admits; 0 = queue empty)",
            ["engine"], registry=r,
        )
        self.requests_recovered = Counter(
            "tpusc_requests_recovered",
            "Generate rows transparently requeued after an engine-thread "
            "crash (reason=mid_decode|queued)",
            ["reason"], registry=r,
        )
        # scenario-lab drills (lab/faults.py, armed only through
        # observability.lab_faults or an explicit arm): one increment per
        # firing; zero unless an operator armed the injector
        self.fault_injected = Counter(
            "tpusc_fault_injected",
            "Scenario-lab fault injections fired (kind=kill_engine|"
            "freeze_scheduler|stall_store|corrupt_peer_chunk|drop_peer)",
            ["kind"], registry=r,
        )
        # per-request phase attribution; the class label rides the
        # model_labels gate, so callers go through observe_phase
        phase_labels = (
            ["phase", "engine", "class"] if model_labels
            else ["phase", "engine"]
        )
        self.request_phase = Histogram(
            "tpusc_request_phase_seconds",
            "Per-request latency attribution by phase "
            "(phase=queue|prefill|decode|respond, "
            "engine=continuous|coalesce; class=high|normal|low "
            "when model_labels is on)",
            phase_labels, registry=r,
            buckets=(.0005, .001, .0025, .005, .01, .025, .05, .1, .25,
                     .5, 1, 2.5, 5, 10, 30),
        )
        self.gen_kv_pages_used = Gauge(
            "tpusc_gen_kv_pages_used",
            "KV arena pages currently reserved by in-flight continuous "
            "generate rows (summed across models)",
            registry=r,
        )
        self.gen_kv_pages_total = Gauge(
            "tpusc_gen_kv_pages_total",
            "Usable KV arena pages (excluding the trash page), summed "
            "across models with live paged slot states",
            registry=r,
        )
        self.gen_kv_pages_used_peak = Gauge(
            "tpusc_gen_kv_pages_used_peak",
            "High-water KV arena pages reserved since the last "
            "/monitoring/engine scrape (reset-on-scrape)",
            registry=r,
        )
        self.gen_kv_pages_shared = Gauge(
            "tpusc_gen_kv_pages_shared",
            "KV arena pages currently referenced by MORE than one owner "
            "(shared-prefix pages mapped read-only into multiple lanes' "
            "block tables and/or held by the radix prefix index); each "
            "counted once — gen_kv_pages_used minus this is the private "
            "page population",
            registry=r,
        )
        self.gen_prefix_hits = Counter(
            "tpusc_gen_prefix_hits",
            "Continuous-engine admissions that reused prompt-prefix KV: "
            "kind=exact skipped prefill entirely (radix index full match, "
            "first token sampled from cached logits), kind=shared paid "
            "only a suffix prefill (radix partial match or dense "
            "prefix-cache reuse)",
            ["engine", "kind"], registry=r,
        )
        self.gen_preemptions = Counter(
            "tpusc_gen_preemptions",
            "Decoding lanes preempted by a higher-priority admission "
            "(KV parked through the conversation codec, lane requeued, "
            "resumed O(new tokens) when pages free), labeled by the "
            "priority class of the VICTIM lane",
            ["class"], registry=r,
        )
        self.gen_prefill_chunks = Counter(
            "tpusc_gen_prefill_chunks",
            "Partial-prefill dispatches issued by the continuous engine's "
            "chunked-prefill interleaver (serving.prefill_chunk_tokens > 0); "
            "one increment per chunk, so chunks/admission gauges how much "
            "long-prompt prefill was broken up",
            registry=r,
        )
        self.gen_stream_frames = Counter(
            "tpusc_gen_stream_frames",
            "Token frames written to streaming generate clients "
            "(protocol = sse | grpc)",
            ["protocol"], registry=r,
        )
        self.gen_kv_arena_bytes = Gauge(
            "tpusc_gen_kv_arena_bytes",
            "Device bytes allocated to the paged KV arena (pages plus, "
            "for dtype=int8, the f32 dequant scale buffers), labeled by "
            "arena element type (serving.kv_arena_dtype; the model dtype "
            "when unset) — capacity-vs-budget evidence for the int8 arena",
            ["dtype"], registry=r,
        )
        # conversation tier (cache/conversation_kv.py)
        self.kv_parked_bytes = Gauge(
            "tpusc_kv_parked_bytes",
            "Bytes of parked conversation KV state by residency tier "
            "(tier = host | disk)",
            ["tier"], registry=r,
        )
        self.kv_parked_conversations = Gauge(
            "tpusc_kv_parked_conversations",
            "Conversations with parked KV state across the host and disk "
            "levels of the conversation tier",
            registry=r,
        )
        self.kv_resume = Counter(
            "tpusc_kv_resume",
            "conversation_id resume lookups at continuous-engine admission "
            "(outcome = hit | spilled | miss)",
            ["outcome"], registry=r,
        )
        self.gen_kv_page_waste = Histogram(
            "tpusc_gen_kv_page_waste_tokens",
            "Per retired row: reserved page capacity minus tokens that "
            "actually occupied it (prompt + emitted) — internal "
            "fragmentation of fixed pages plus unconsumed max_new headroom",
            registry=r,
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )
        self.assignment_warms = Counter(
            "tpusc_assignment_warms_total",
            "Models pre-loaded by the ring-assignment warmer",
            registry=r,
        )
        # targets a scrape-merge dropped (unreachable, non-200, unparseable)
        self.scrape_errors = Counter(
            "tpusc_scrape_errors",
            "Sidecar metrics targets dropped from a /metrics merge "
            "(unreachable, non-200, or unparseable)",
            registry=r,
        )
        self.prefix_cache_hits = Counter(
            "tpusc_prefix_cache_hits_total",
            "generate requests that reused a cached prompt-prefix KV",
            registry=r,
        )
        self.prefix_cache_misses = Counter(
            "tpusc_prefix_cache_misses_total",
            "generate requests that paid full prefill (prefix cache on)",
            registry=r,
        )
        self.prefix_cache_bytes = Gauge(
            "tpusc_prefix_cache_bytes",
            "Device bytes held by cached prompt-prefix KV entries",
            registry=r,
        )
        # the cold load's stages (runtime load spans + the manager's fetch)
        self.cold_stage_seconds = Histogram(
            "tpusc_cold_stage_seconds",
            "Per-stage cold-load time (provider_fetch/artifact_read/"
            "device_transfer/device_dequant/host_dequant/compile_warmup/"
            "transfer_sync; dequant stages appear for quantized artifacts "
            "only, so encodings stay separable): "
            "the in-production answer to 'where do my cold seconds go' and "
            "to the int8-vs-bf16 crossover (compare device_transfer + "
            "device_dequant across artifact encodings on YOUR link)",
            ["stage"], registry=r,
            buckets=(.005, .02, .05, .1, .25, .5, 1, 2, 5, 10, 30),
        )
        self.cold_overlap_ratio = Histogram(
            "tpusc_cold_overlap_ratio",
            "Σ(per-stage seconds)/wall seconds per runtime load: ~1.0 means "
            "the stages ran strictly back-to-back (serialized path), >1 "
            "means the pipelined cold load overlapped them (AOT compile and "
            "per-leaf dequant running during the transfer) — the higher, "
            "the more of the compile the transfer hid",
            registry=r,
            buckets=(0.8, 0.95, 1.0, 1.1, 1.2, 1.35, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0),
        )
        # groups that span processes (parallel/multihost.py): teardowns and
        # re-formations, and whether the group serves
        self.group_reforms = Counter(
            "tpusc_group_reform_events_total",
            "Cross-host group failure-containment events",
            ["group", "event"], registry=r,  # event: torn_down | reformed
        )
        self.group_healthy = Gauge(
            "tpusc_group_healthy",
            "1 while the cross-host group serves; 0 while torn down/re-forming",
            ["group"], registry=r,
        )
        # fleet status plane (cluster/status.py): this node's view of its
        # peers; peer labels are pruned with ring membership
        self.peer_health_score = Gauge(
            "tpusc_peer_health_score",
            "Composite per-peer health in [0,1] as THIS node scores it: "
            "forward-error EWMA x latency factor x status-staleness decay "
            "(peers below cluster.health_threshold are deprioritized in "
            "p2c replica ordering, never hard-dropped)",
            ["peer"], registry=r,
        )
        self.peer_status_age = Gauge(
            "tpusc_peer_status_age_seconds",
            "Seconds since this peer's last NodeStatus was received "
            "(piggybacked on a routed hop or polled)",
            ["peer"], registry=r,
        )
        self.fleet_model_replicas = Gauge(
            "tpusc_fleet_model_replicas",
            "Nodes currently advertising this model at this residency tier "
            "(tier = hbm | host | disk), from the fleet status exchange",
            ["model", "tier"], registry=r,
        )
        # load-adaptive replication (cluster/replication.py)
        # peer param distribution (cache/providers/peer.py): cold misses
        # sourced from a warm peer's host tier instead of the store
        self.peer_fetch_bytes = Counter(
            "tpusc_peer_fetch_bytes",
            "Packed parameter bytes streamed FROM peers on cold misses "
            "(outcome = ok | error | not_found; error/not_found count the "
            "bytes received before the stream gave up and fell back to "
            "the store)",
            ["outcome"], registry=r,
        )
        self.model_replicas_target = Gauge(
            "tpusc_model_replicas_target",
            "Per-model ring replica count N the replica controller "
            "currently targets (grows with in-flight load toward "
            "cluster.max_replicas_per_model, decays to the "
            "proxy.replicas_per_model floor with hysteresis)",
            ["model"], registry=r,
        )
        self.spec_draft_autodisabled = Counter(
            "tpusc_spec_draft_autodisabled_total",
            "Draft models auto-disabled after sustained low acceptance",
            registry=r,
        )
        self.spec_tokens_per_round = Gauge(
            "tpusc_spec_tokens_per_round",
            "Most recent speculative acceptance (emitted tokens per verify "
            "round; spec_tokens+1 = every proposal accepted; labeled by "
            "target model when model_labels is on, else one all_models "
            "series)",
            ["model"], registry=r,
        )
        self.spec_accepted_tokens = Counter(
            "tpusc_spec_accepted_tokens",
            "Tokens emitted by speculative verify rounds (accepted draft "
            "prefix + the target's own correction token)",
            ["engine"], registry=r,
        )
        self.spec_rounds = Counter(
            "tpusc_spec_rounds",
            "Speculative draft/verify rounds executed (per active lane "
            "under the continuous engine)",
            ["engine"], registry=r,
        )
        # per-tenant cost attribution, mirrored from utils/accounting.py's
        # LEDGER at scrape time (series only with metrics.model_labels)
        self.tenant_tokens = Counter(
            "tpusc_tenant_tokens",
            "Tokens attributed to this tenant (direction = in, prompt "
            "tokens admitted | out, tokens emitted)",
            ["model", "direction"], registry=r,
        )
        self.tenant_step_seconds = Counter(
            "tpusc_tenant_step_seconds",
            "Engine wall seconds spent on this tenant's rows "
            "(phase = prefill | decode); each scheduler dispatch is "
            "single-model, so step time lands wholly on its tenant",
            ["model", "phase"], registry=r,
        )
        self.tenant_kv_page_seconds = Counter(
            "tpusc_tenant_kv_page_seconds",
            "Integral of DISTINCT KV arena pages held by this tenant over "
            "time (a shared-prefix page counts once, per page_stats())",
            ["model"], registry=r,
        )
        self.tenant_byte_seconds = Counter(
            "tpusc_tenant_byte_seconds",
            "Integral of this tenant's residency bytes over time by tier "
            "(tier = hbm | host | disk)",
            ["model", "tier"], registry=r,
        )
        self.tenant_cold_load_seconds = Counter(
            "tpusc_tenant_cold_load_seconds",
            "Wall seconds of ensure_servable resolutions for this tenant "
            "by serving tier (tier = hbm | host | disk | peer | store)",
            ["model", "tier"], registry=r,
        )
        self.tenant_peer_bytes_served = Counter(
            "tpusc_tenant_peer_bytes_served",
            "Packed parameter bytes this node streamed TO peers on the "
            "tenant's behalf (work done for others, attributed not lost)",
            ["model"], registry=r,
        )
        self.tenant_dominant_share = Gauge(
            "tpusc_tenant_dominant_share",
            "Max over dimensions of this tenant's share of the node total "
            "(DRF-style dominant share in [0,1]; the noisy-neighbor signal)",
            ["model"], registry=r,
        )

    def observe_phase(self, phase: str, engine: str, cls: str, v: float) -> None:
        """Observe one request-phase sample, routing the priority class to
        the extra label only when ``model_labels`` enabled it at
        construction — the one place that knows the histogram's arity."""
        if self.model_labels:
            self.request_phase.labels(phase, engine, cls or "normal").observe(v)
        else:
            self.request_phase.labels(phase, engine).observe(v)

    def model_label(self, name: str, version: int | str) -> str:
        if not self.model_labels:
            return ALL_MODELS
        label = f"{name}:{version}"
        seen = self._seen_model_labels
        if label in seen:
            return label
        if len(seen) >= self.max_model_labels:
            return OTHER_MODELS
        seen.add(label)
        return label

    def render(self) -> bytes:
        """Text exposition (format 0.0.4) of every family."""
        return self.registry.render()


# -- scrape-merge of sidecar exporters ----------------------------------------
# A copy of ``prometheus_client.parser.text_string_to_metric_families`` (the
# text format 0.0.4 reader the reference merges with), so that the merged
# exposition is the reference's byte for byte without the package.

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_RESERVED_LABEL_RE = re.compile(r"^__.*$")
_METRIC_TYPES = ("counter", "gauge", "summary", "histogram", "gaugehistogram", "unknown",
                 "info", "stateset")
_ESCAPES = {"\\\\": "\\", "\\n": "\n", '\\"': '"'}
_HELP_ESCAPING_RE = re.compile(r"\\[\\n]")
_ESCAPING_RE = re.compile(r'\\[\\n"]')


class Sample(NamedTuple):
    name: str
    labels: dict
    value: float
    timestamp: float | None = None


class ParsedFamily:
    """One parsed metric family (``prometheus_client``'s ``Metric``)."""

    def __init__(self, name: str, documentation: str, typ: str) -> None:
        if not name:
            raise ValueError("metric name cannot be empty")
        if typ == "untyped":
            typ = "unknown"
        if typ not in _METRIC_TYPES:
            raise ValueError("Invalid metric type: " + typ)
        self.name, self.documentation, self.type = name, documentation, typ
        self.samples: list[Sample] = []


def _legacy_name(name: str) -> bool:
    return bool(name) and _METRIC_NAME_RE.match(name) is not None


def _escaped(s: str, charpos: int) -> bool:
    n = 0
    while charpos > n and s[charpos - 1 - n] == "\\":
        n += 1
    return n % 2 == 1


def _next_unquoted_char(text: str, chs: str | None, startidx: int = 0) -> int:
    in_quotes = False
    if chs is None:
        chs = string.whitespace
    for i, c in enumerate(text[startidx:]):
        if c == '"' and not _escaped(text, startidx + i):
            in_quotes = not in_quotes
        if not in_quotes and c in chs:
            return startidx + i
    return -1


def _split_quoted(text: str, separator: str | None, maxsplit: int = 0) -> list[str]:
    tokens = [""]
    x = 0
    while x < len(text):
        split_pos = _next_unquoted_char(text, separator, x)
        if split_pos == -1:
            tokens[-1] = text[x:]
            x = len(text)
            continue
        if split_pos == x:
            x += 1
            continue
        if maxsplit > 0 and len(tokens) > maxsplit:
            tokens[-1] = text[x:]
            break
        tokens[-1] = text[x:split_pos]
        x = split_pos + 1
        tokens.append("")
    return tokens


def _unquote_unescape(text: str) -> tuple[str, bool]:
    if not text:
        return text, False
    quoted = False
    text = text.strip()
    if text[0] == '"':
        if len(text) == 1 or text[-1] != '"':
            raise ValueError("missing close quote")
        text = text[1:-1]
        quoted = True
    if "\\" in text:
        text = _ESCAPING_RE.sub(lambda m: _ESCAPES[m.group(0)], text)
    return text, quoted


def _next_term(text: str) -> tuple[str, str, str]:
    if text[0] == ",":
        text = text[1:]
        if not text:
            return "", "", ""
        if text[0] == ",":
            raise ValueError("multiple commas")
    splitpos = _next_unquoted_char(text, "=,}")
    if splitpos >= 0 and text[splitpos] == "=":
        labelname = text[:splitpos]
        text = text[splitpos + 1:]
        splitpos = _next_unquoted_char(text, ",}")
    else:
        labelname = "__name__"
    if splitpos == -1:
        splitpos = len(text)
    return labelname, text[:splitpos].strip(), text[splitpos:].strip()


def _parse_labels(labels_string: str) -> dict[str, str]:
    labels: dict[str, str] = {}
    sub = labels_string.strip()
    try:
        while sub:
            name_term, value_term, sub = _next_term(sub)
            if not value_term:
                continue
            label_name, quoted_name = _unquote_unescape(name_term)
            if not quoted_name and not _legacy_name(label_name):
                raise ValueError("unquoted UTF-8 metric name")
            if not value_term or value_term[0] != '"':
                raise ValueError
            i = 1
            while i < len(value_term):
                i = value_term.index('"', i)
                if not _escaped(value_term[:i], i):
                    break
                i += 1
            if i + 1 != len(value_term):
                raise ValueError("unexpected text after quote: " + labels_string)
            label_value, _ = _unquote_unescape(value_term)
            if label_name != "__name__" and _RESERVED_LABEL_RE.match(label_name):
                raise ValueError("Reserved label metric name: " + label_name)
            if label_name in labels:
                raise ValueError("invalid line, duplicate label name: " + labels_string)
            labels[label_name] = label_value
        return labels
    except ValueError:
        raise ValueError("Invalid labels: " + labels_string) from None


def _parse_value(value: str) -> float:
    if value != value.strip() or "_" in value:
        raise ValueError(f"Invalid value: {value!r}")
    try:
        return int(value)
    except ValueError:
        return float(value)


def _parse_value_and_timestamp(s: str) -> tuple[float, float | None]:
    s = s.lstrip()
    separator = " " if " " in s else "\t"
    values = [v.strip() for v in s.split(separator) if v.strip()]
    if not values:
        return float(s), None
    value = _parse_value(values[0])
    timestamp = (_parse_value(values[-1]) / 1000) if len(values) > 1 else None
    return value, timestamp


def _parse_sample(text: str) -> Sample:
    label_start = _next_unquoted_char(text, "{")
    if label_start == -1 or " # " in text[:label_start]:
        name_end = _next_unquoted_char(text, " \t")
        name = text[:name_end].strip()
        if not _legacy_name(name):
            raise ValueError("invalid metric name:" + text)
        return Sample(name, {}, *_parse_value_and_timestamp(text[name_end + 1:]))
    name = text[:label_start].strip()
    label_end = _next_unquoted_char(text[label_start:], "}") + label_start
    labels = _parse_labels(text[label_start + 1:label_end])
    if not name:
        if "__name__" not in labels:
            raise ValueError
        name = labels.pop("__name__")
    elif "__name__" in labels:
        raise ValueError("metric name specified more than once")
    return Sample(name, labels, *_parse_value_and_timestamp(text[label_end + 1:]))


def parse_exposition(text: str) -> Iterator[ParsedFamily]:
    """The families of a text-format exposition, as
    ``prometheus_client.parser.text_string_to_metric_families`` yields them
    (a counter family's name loses ``_total``; a sample no family declared
    becomes an ``unknown`` family of its own). Raises ValueError on
    malformed text."""
    name, documentation, typ = "", "", "untyped"
    samples: list[Sample] = []
    allowed: list[str] = []

    def build(name: str, documentation: str, typ: str, samples: list[Sample]) -> ParsedFamily:
        if typ == "counter":
            if name.endswith("_total"):
                name = name[:-6]
            else:
                samples = [Sample(s[0] + "_total", *s[1:]) for s in samples]
        fam = ParsedFamily(name, documentation, typ)
        fam.samples = samples
        return fam

    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#"):
            parts = _split_quoted(line, None, 3)
            if len(parts) < 2:
                continue
            candidate, quoted = "", False
            if len(parts) > 2:
                if parts[1] not in ("TYPE", "HELP"):
                    continue
                candidate, quoted = _unquote_unescape(parts[2])
                if not quoted and not _legacy_name(candidate):
                    raise ValueError
            if parts[1] == "HELP":
                if candidate != name:
                    if name != "":
                        yield build(name, documentation, typ, samples)
                    name, typ, samples, allowed = candidate, "untyped", [], [candidate]
                documentation = (_HELP_ESCAPING_RE.sub(lambda m: _ESCAPES[m.group(0)], parts[3])
                                 if len(parts) == 4 else "")
            elif parts[1] == "TYPE":
                if len(parts) < 4:
                    raise ValueError
                if candidate != name:
                    if name != "":
                        yield build(name, documentation, typ, samples)
                    name, documentation, samples = candidate, "", []
                typ = parts[3]
                allowed = [name + n for n in {
                    "counter": [""], "gauge": [""], "summary": ["_count", "_sum", ""],
                    "histogram": ["_count", "_sum", "_bucket"],
                }.get(typ, [""])]
        elif line:
            sample = _parse_sample(line)
            if sample.name not in allowed:
                if name != "":
                    yield build(name, documentation, typ, samples)
                name, documentation, typ, samples, allowed = "", "", "untyped", [], []
                yield build(sample[0], "", "untyped", [sample])
            else:
                samples.append(sample)
    if name != "":
        yield build(name, documentation, typ, samples)


def _sample_line(sname: str, litems, value) -> str:
    labels = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in litems)
    return f"{sname}{{{labels}}} {value}" if labels else f"{sname} {value}"


def _emit_families(families, skip: set[str]) -> tuple[list[str], set[str]]:
    """Parsed families as exposition text, less those already emitted (the
    duplicates two exporters share would make Prometheus refuse the page)."""
    out: list[str] = []
    emitted: set[str] = set()
    for fam in families:
        if fam.name in skip:
            continue
        emitted.add(fam.name)
        out.append(f"# HELP {fam.name} {_escape_help(fam.documentation)}")
        out.append(f"# TYPE {fam.name} {fam.type}")
        for s in fam.samples:
            out.append(_sample_line(s.name, sorted(s.labels.items()), s.value))
    return out, emitted


def _merge_summed(texts: list[str], on_error) -> bytes:
    """Series-level merge: one HELP/TYPE a family, counter samples with one
    label set summed across the sources, other samples from the first
    source (own first)."""
    fams: dict[str, dict] = {}
    for text in texts:
        try:
            parsed = list(parse_exposition(text))
        except ValueError as e:
            on_error(e)
            continue
        for fam in parsed:
            ent = fams.setdefault(fam.name, {"doc": fam.documentation, "type": fam.type,
                                             "samples": {}})
            for s in fam.samples:
                key = (s.name, tuple(sorted(s.labels.items())))
                cur = ent["samples"].get(key)
                if cur is None:
                    ent["samples"][key] = s.value
                elif ent["type"] == "counter" and not s.name.endswith("_created"):
                    ent["samples"][key] = cur + s.value
    out: list[str] = []
    for name, ent in fams.items():
        # the parser strips a counter's _total; written back so that a
        # reader pairs the _total samples with their family again
        ename = name
        if ent["type"] == "counter" and all(
                sname.endswith(("_total", "_created")) for sname, _ in ent["samples"]):
            ename = name + "_total"
        out.append(f"# HELP {ename} {_escape_help(ent['doc'])}")
        out.append(f"# TYPE {ename} {ent['type']}")
        for (sname, litems), value in ent["samples"].items():
            out.append(_sample_line(sname, litems, value))
    return ("\n".join(out) + "\n").encode()


def _scrape(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        if resp.status != 200:
            raise ValueError(f"HTTP {resp.status}")
        return resp.read().decode("utf-8", errors="replace")


def scrape_and_merge(own: bytes, targets: list[str], timeout_s: float = 2.0,
                     metrics: "Metrics | None" = None, sum_counters: bool = False) -> bytes:
    """``own`` exposition with each target's merged in (the reference's
    ``scrape_and_merge``, utils/metrics.py:677). Targets are fetched at
    once, one thread each, within ``timeout_s``; a family already emitted
    is dropped from later sources (own first); a target that is down,
    answers non-200 or does not parse is skipped, logged and counted in
    ``tpusc_scrape_errors_total``. ``sum_counters`` sums counter series
    with equal labels across the sources instead."""
    if not targets:
        return own

    def fail(what: str, e: Exception) -> None:
        log.warning("metrics scrape of %s failed: %s", what, e)
        if metrics is not None:
            metrics.scrape_errors.inc()

    def fetch(url: str) -> str | None:
        try:
            return _scrape(url, timeout_s)
        except Exception as e:  # noqa: BLE001 - a down sidecar degrades the merge
            fail(url, e)
            return None

    with ThreadPoolExecutor(max_workers=len(targets),
                            thread_name_prefix="tpusc-scrape") as pool:
        bodies = list(pool.map(fetch, targets))
    if sum_counters:
        return _merge_summed([own.decode()] + [b for b in bodies if b is not None],
                             lambda e: fail("a merge source", e))
    seen = {f.name for f in parse_exposition(own.decode())}
    parts = [own.rstrip(b"\n")]
    for url, body in zip(targets, bodies):
        if body is None:
            continue
        try:
            lines, emitted = _emit_families(parse_exposition(body), seen)
        except ValueError as e:
            fail(url, e)
            continue
        seen |= emitted
        if lines:
            parts.append("\n".join(lines).encode())
    return b"\n".join(parts) + b"\n"
