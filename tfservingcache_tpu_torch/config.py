"""Config for the port's serving path (a subset of
``tfservingcache_tpu/config.py``, same section and field names).

Loaded from a JSON file or a dict; a ``.yaml``/``.yml`` path imports
``yaml`` lazily, so the package needs no YAML library otherwise. Unknown
keys are logged and ignored, as in the reference. ``load_config`` also
reads ``./config.yaml`` when no path is given and applies
``TPUSC_<SECTION>_<FIELD>`` environment overrides (``TPUSC_SERVING_DEVICE=cpu``,
``TPUSC_CACHE_NODE_REST_PORT=0``), as the reference's does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Mapping

log = logging.getLogger("tpusc_torch.config")

ENV_PREFIX = "TPUSC_"


@dataclass
class ServingConfig:
    """The in-process PyTorch runtime."""

    max_concurrent_models: int = 16        # models resident on the GPU at once
    # byte budget for resident params (an H100 holds 80 GB; the rest is
    # left for activations and the allocator's cache)
    hbm_capacity_bytes: int = 64 << 30
    # cold-load (fetch + load) deadline; 0 disables
    load_timeout_s: float = 30.0
    # "cuda" (the default) or "cpu"; a missing card with "cuda" raises
    device: str = "cuda"
    # Pipelined cold load (runtime/model_runtime.py
    # packed_device_put_pipelined): an assembler thread packs the params
    # into page-locked chunks of ~256 MiB while the previous chunk's copy to
    # the device runs on a copy stream. False keeps the serialized path: the
    # whole artifact read into page-locked memory, every leaf copied out of
    # it, one sync. A runtime bound to a device group is always serialized.
    # The reference's A/B setting: the serialized path is the baseline a
    # pipelined load is measured against (chip_smoke.py's tier phase prints
    # both), not a mode to deploy.
    cold_load_pipeline: bool = True
    # staging buffers the chunk assembler may run ahead of the copies (each
    # holds one chunk: the page-locked memory of a pipelined load)
    cold_pipeline_buffer_depth: int = 2
    # micro-batching (runtime/batcher.py): 0 (default) = off; > 0 turns on
    # MicroBatcher for :predict and GenerateCoalescer for :generate.
    # Batches form while earlier ones hold the device (no timed window), so
    # the value is an on/off switch. batch_max_size caps a :predict batch's
    # rows (a :generate batch's at min(batch_max_size, 32))
    batch_window_ms: float = 0.0
    batch_max_size: int = 64
    # :generate engine: "continuous" runs unseeded requests on the slotted
    # continuous engine (runtime/batcher.py); "coalesce" (the default)
    # coalesces concurrent unseeded requests into one solo-path generate
    # when batch_window_ms > 0, and runs each request solo otherwise
    generate_engine: str = "coalesce"
    generate_slots: int = 8                # continuous-engine lanes per model
    generate_chunk_tokens: int = 8         # decode steps per scheduler boundary
    # paged KV arena for the continuous engine: 0 = dense per-lane rows;
    # > 0 = pages of this many tokens shared through per-lane block tables
    kv_page_tokens: int = 0
    # usable arena pages; 0 auto-sizes to slots x ceil(max_seq / page_tokens)
    # (int8 arenas grow to the same byte budget)
    kv_arena_pages: int = 0
    # Cross-request shared-prefix KV over the paged arena
    # (runtime/prefix_cache.py PagePrefixIndex): byte budget of arena pages
    # the radix prefix index may hold for reuse. 0 = off (default). > 0 (with
    # kv_page_tokens > 0) makes admission map the longest page-aligned
    # indexed prompt prefix read-only into a new row's block table (no
    # prefill over it, no page copy) and reserve only the private suffix +
    # max_new pages; an exact repeat of an indexed prompt skips the prefill.
    # A page a lane would write into is copied first; index-held pages are
    # reclaimed under admission pressure before a request blocks.
    kv_share_prefix_bytes: int = 0
    # Chunked prefill for generate_engine=continuous over a paged arena:
    # 0 (default) prefills each admitted prompt in one dispatch. > 0 splits
    # a cold prompt longer than this into chunks of this many tokens
    # (clamped up to a power of two), written straight into the lane's pages
    # one chunk per scheduler boundary while the other lanes keep decoding.
    # Shared-prefix hits and engines with a draft attached keep the
    # one-dispatch prefill.
    prefill_chunk_tokens: int = 0
    # Prefix KV cache for the solo :generate path (B = 1 requests):
    # byte budget of device memory for reusable prompt-prefix K/V
    # (runtime/prefix_cache.py PrefixCache). 0 = off (default). A hit
    # prefills only the suffix; each request stores its prompt + completion
    # rows for the next turn. The continuous engine's admission prefill
    # reuses entries too (it never inserts).
    prefix_cache_bytes: int = 0
    # paged decode attention through the CUDA kernel (False = the plain path)
    kv_paged_kernel: bool = True
    # "" = the model dtype; "int8" = quantized pages with per-row f32 scales
    kv_arena_dtype: str = ""
    # In-engine speculative decoding for generate_engine=continuous
    # (runtime/batcher.py): name of the DRAFT model — "name" (highest
    # resident version) or "name@version". "" = off (default). When set,
    # each continuous scheduler attaches the draft to its paged slot state
    # (runtime.slot_attach_draft) and replaces plain decode chunks with
    # draft/verify rounds: the draft proposes spec_tokens greedy tokens per
    # lane, ONE multi-position verify pass scores them, and each lane
    # accepts a variable-length prefix — greedy streams stay identical to
    # spec-off. Admission reserves spec_tokens of extra page headroom per
    # row in BOTH arenas, so requests sized to the exact arena edge may
    # need one more page than without spec. Dense (non-paged) states ignore
    # the knob; lanes with temperature > 0 fall back to single-token
    # emission inside the round.
    spec_draft_model: str = ""
    # Draft tokens proposed per verify round when spec_draft_model is set
    # (clamped to {1, 2, 4, 8} at attach). Also the per-row page headroom
    # reserved at admission. Higher values win only when acceptance is
    # high; the runtime's acceptance health gate (_spec_admit) disables a
    # pair that sustains low acceptance and re-auditions it periodically.
    spec_tokens: int = 4
    # Crash recovery for generate_engine=continuous (runtime/batcher.py): when
    # a scheduler step raises (a device failure, an eviction mid-decode, an
    # injected kill), its in-flight and queued rows move to a fresh
    # scheduler thread instead of failing; admission re-prefills each
    # interrupted row's prompt + the tokens it already emitted, so greedy
    # streams continue token for token. false fails every row, as before.
    generate_recovery: bool = True
    # Crashes a row may survive; it fails on the next one (a prompt that
    # crashes the engine every time must not respawn schedulers forever).
    generate_max_recoveries: int = 2
    # Conversation KV tier for generate_engine=continuous over a paged arena
    # (cache/conversation_kv.py): host-memory byte budget for PARKED decode
    # state. A :generate request carrying a conversation_id copies its lane's
    # live pages (raw arena dtype, int8 with its scales) to host at
    # retirement; the conversation's next turn writes them back into fresh
    # pages and prefills only the suffix. 0 = off (default).
    conversation_kv_bytes: int = 0
    # Disk level under the host budget: the coldest parked conversations
    # spill to conversation_kv_dir instead of being dropped; a resume that
    # finds its turn on disk promotes it back to host. 0 = no spill.
    conversation_kv_disk_bytes: int = 0
    # Directory of spilled conversation blobs (one file per conversation,
    # written to a temporary name and renamed), under the process's temporary
    # directory by default. The tier deletes its own files when it closes,
    # and the directory only when the tier made it and it is left empty.
    conversation_kv_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "tpusc_conv_kv"))
    # ModelSpec.version_label / REST /labels/<label> resolution:
    # {model_name: {label: version}}. A label with no mapping answers 412
    # (FAILED_PRECONDITION on gRPC); it never serves the latest version.
    version_labels: dict = field(default_factory=dict)


@dataclass
class CacheConfig:
    """Disk artifact cache."""

    base_dir: str = "/tmp/tpusc_models"
    disk_capacity_bytes: int = 10 << 30
    # Host-RAM warm tier (cache/host_tier.py): bytes of host memory that
    # keep evicted models' packed chunks, so a re-admission replays them
    # onto the device with no disk read and no decode. 0 = off (default).
    # A runtime bound to a device group ignores it.
    host_tier_bytes: int = 0


@dataclass
class ModelProviderConfig:
    """Where artifacts are fetched from: a directory tree or an object store
    (cache/providers/)."""

    type: str = "disk"                 # disk | s3 | gcs | azblob
    base_dir: str = "./models"         # disk provider root
    # s3 / gcs / azblob
    bucket: str = ""
    base_path: str = ""
    region: str = ""
    endpoint: str = ""                 # a custom endpoint (MinIO, a test fake)
    account_name: str = ""             # azblob
    account_key: str = ""
    container: str = ""


@dataclass
class ProxyConfig:
    """The router's ports and replica count (cluster/router.py); the gRPC
    message cap is the cache node's and every gRPC client's as well."""

    rest_port: int = 8093
    grpc_port: int = 8100
    replicas_per_model: int = 1
    grpc_max_message_bytes: int = 16 << 20
    # on a membership change, pre-load the owned models already in the
    # local disk cache (cluster/warmer.py)
    warm_on_assignment: bool = True


@dataclass
class CacheNodePorts:
    """The cache node's REST and gRPC ports (0 binds an ephemeral port).
    gRPC listens only where ``grpcio`` imports."""

    rest_port: int = 8094
    grpc_port: int = 8095


@dataclass
class DiscoveryConfig:
    """How nodes find each other. "" (the default) runs one cache node and
    no router; static | file | consul | etcd | kubernetes run a router on
    the proxy ports beside the node."""

    type: str = ""
    heartbeat_ttl_s: float = 5.0
    service_name: str = "tpuserve-cache"
    # static: "host:restPort:grpcPort" idents
    nodes: list[str] = field(default_factory=list)
    # file: a JSON {"nodes": [...]} members file, polled
    path: str = ""
    poll_interval_s: float = 2.0
    # consul / etcd HTTP address, or the Kubernetes API URL ("" = in-cluster)
    address: str = ""
    namespace: str = ""                # kubernetes ("" = the serviceaccount's)
    field_selector: str = ""           # kubernetes Endpoints selector
    # advertise 127.0.0.1 instead of the outbound interface's address
    prefer_localhost: bool = False


@dataclass
class ClusterConfig:
    """The fleet status plane (cluster/status.py), peer fetch and
    load-adaptive replication (cluster/replication.py)."""

    # piggybacked NodeStatus on routed hops + a poll fallback; off, the
    # router ranks replicas by load and local warmth only
    status_exchange: bool = True
    # poll period for peers no routed hop refreshes, and the age under
    # which a peer is not polled
    status_poll_interval_s: float = 5.0
    # an older status is stale: its warmth stops counting and the peer's
    # health decays
    status_stale_after_s: float = 15.0
    # bound on one encoded status (the coldest models are cut first)
    status_byte_cap: int = 4096
    status_max_models: int = 64
    status_max_tenants: int = 8
    # a node recollects its status at most this often
    status_min_interval_s: float = 0.25
    # peers scoring below this lead no replica pair (they stay in the ring)
    health_threshold: float = 0.5
    # EWMA weight of forward outcomes
    health_error_alpha: float = 0.3
    # latency factor of the health score: ref / (ref + latency EWMA)
    health_latency_ref_s: float = 1.0
    # peer fetch of packed models (cache/providers/peer.py): a cold miss
    # streams a warm peer's host-tier entry over FetchPackedModel before it
    # asks the store; the node serves its own tier to peers
    peer_fetch: bool = True
    peer_fetch_chunk_bytes: int = 2 << 20
    peer_fetch_max_inflight_per_peer: int = 2
    peer_fetch_timeout_s: float = 60.0
    # ceiling of a model's replica count; proxy.replicas_per_model is the
    # floor. 0 keeps the count static
    max_replicas_per_model: int = 4
    # in-flight requests a replica that justify one more:
    # N = clamp(ceil(ewma / target), base, max)
    replica_load_target: float = 2.0
    replica_eval_interval_s: float = 2.0
    # N shrinks only after this many evaluations in a row want less
    replica_decay_ticks: int = 3


@dataclass
class MeshConfig:
    """Device groups (the reference's ``mesh`` section). Only the in-process
    group size is ported: with ``chips_per_group > 1`` the node serves from
    one group of that many devices driven by this process (a ``"ring"``
    model splits its sequence over them). The reference's cross-process
    fields (coordinator, num_processes, process_id, worker_addrs) and its
    axis_names/data_parallel are logged as unknown keys and ignored."""

    chips_per_group: int = 1


@dataclass
class MetricsConfig:
    """Prometheus exposition (utils/metrics.py)."""

    model_labels: bool = False         # per-model:version labels
    path: str = "/monitoring/prometheus/metrics"
    # text-format exporters merged into this node's exposition
    # (utils/metrics.scrape_and_merge)
    scrape_targets: list[str] = field(default_factory=list)
    # cardinality guard for model_labels: after this many distinct
    # name:version values, NEW tenants fold into the "__other__" bucket
    max_model_labels: int = 512
    # merge mode: sum counter series with equal labels across sources
    # instead of keeping the first source's family
    scrape_sum_counters: bool = False


@dataclass
class TracingConfig:
    """Always-on request tracing (utils/tracing.py)."""

    capacity: int = 256                # completed traces kept in the ring
    # tail sampling: traces slower than this survive in a separate bounded
    # buffer even after fast traffic wraps the main ring; 0 disables
    slow_threshold_ms: float = 1000.0
    slow_capacity: int = 64


@dataclass
class ObservabilityConfig:
    """Engine flight recorder (utils/flight_recorder.py) and tenant ledger
    (utils/accounting.py). The per-step rings always record; these knobs
    govern the anomaly-dump spool and the ledger."""

    # Spool dir for anomaly dumps (SLO breach, page-exhaustion blocking,
    # engine-thread crash); "" disables dumps, the rings keep recording.
    # Under the process's temporary directory by default, where the
    # reference has the fixed /tmp/tpusc_flight: the spool deletes dumps
    # past max_dumps, so two processes must not share one by accident.
    flight_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "tpusc_flight"))
    # Per-model step-ring capacity (a boundary per entry).
    ring_entries: int = 4096
    # Spool bound: oldest dump files beyond this count are deleted.
    max_dumps: int = 16
    # Rate limit for recurring triggers (page exhaustion); SLO-breach dumps
    # dedup per trace id instead.
    dump_cooldown_s: float = 60.0
    # master switch for the cost-attribution ledger
    tenant_accounting: bool = True
    # noisy-neighbor detector: a tenant holding at least this share of the
    # engine step-time window while OTHER tenants sit queued triggers one
    # "noisy_neighbor" flight dump (deduped by the recorder cooldown)
    noisy_neighbor_share: float = 0.8
    # sliding window the share is computed over
    noisy_neighbor_window_s: float = 5.0
    # windows with less than this much total step time never fire
    noisy_neighbor_min_step_s: float = 0.25
    # scenario-lab fault injector (lab/faults.py): "" keeps it disarmed and
    # every hook site a one-bool-read passthrough; a JSON list of fault
    # specs arms a drill at node start, e.g. '[{"kind": "freeze_scheduler",
    # "after": 10, "duration_s": 0.25}]' (kinds: kill_engine,
    # freeze_scheduler, stall_store, corrupt_peer_chunk, drop_peer). Also
    # the TPUSC_OBSERVABILITY_LAB_FAULTS override; a malformed spec fails
    # the start instead of running a drill that arms nothing.
    lab_faults: str = ""


@dataclass
class LoggingConfig:
    level: str = "info"
    fmt: str = "text"                  # text | json


@dataclass
class Config:
    serving: ServingConfig = field(default_factory=ServingConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    model_provider: ModelProviderConfig = field(default_factory=ModelProviderConfig)
    proxy: ProxyConfig = field(default_factory=ProxyConfig)
    cache_node: CacheNodePorts = field(default_factory=CacheNodePorts)
    discovery: DiscoveryConfig = field(default_factory=DiscoveryConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    observability: ObservabilityConfig = field(default_factory=ObservabilityConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)


def _apply_mapping(cfg: Any, data: Mapping[str, Any], path: str = "") -> None:
    known = {f.name for f in dataclasses.fields(cfg)}
    unknown = set(data) - known
    if unknown:
        log.warning(
            "ignoring unknown config key(s) %s under %r (known: %s)",
            sorted(unknown), path or ".", sorted(known),
        )
    for f in dataclasses.fields(cfg):
        if f.name not in data:
            continue
        val = data[f.name]
        cur = getattr(cfg, f.name)
        if dataclasses.is_dataclass(cur):
            if val is None:
                continue
            if not isinstance(val, Mapping):
                raise ValueError(
                    f"config section {path}{f.name} must be a mapping, got {type(val).__name__}"
                )
            _apply_mapping(cur, val, f"{path}{f.name}.")
        else:
            setattr(cfg, f.name, type(cur)(val))


def config_from_dict(data: Mapping[str, Any] | None) -> Config:
    cfg = Config()
    _apply_mapping(cfg, data or {})
    return cfg


def _coerce(value: str, target: Any) -> Any:
    """An environment string as the type of the field's current value
    (reference ``_coerce``): a bool is true for 1/true/yes/on (any case) and
    false otherwise, ints and floats parse or raise, a list or tuple splits
    on commas. A dict (``serving.version_labels``) takes a JSON object,
    where the reference would store the string itself."""
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, (list, tuple)):
        return type(target)(p for p in value.split(",") if p)
    if isinstance(target, dict):
        parsed = json.loads(value)
        if not isinstance(parsed, dict):
            raise ValueError("must be a JSON object")
        return parsed
    return value


def _apply_env(cfg: Any, prefix: str) -> None:
    """``<prefix><FIELD>`` overrides for every field of ``cfg``; a section
    recurses with ``<prefix><SECTION>_``."""
    for f in dataclasses.fields(cfg):
        cur = getattr(cfg, f.name)
        key = f"{prefix}{f.name.upper()}"
        if dataclasses.is_dataclass(cur):
            _apply_env(cur, f"{key}_")
        elif key in os.environ:
            try:
                setattr(cfg, f.name, _coerce(os.environ[key], cur))
            except ValueError as e:
                raise ValueError(f"invalid value for env {key}: {e}") from e


def load_config(path: str | None = None, env: bool = True) -> Config:
    """A ``Config`` from a JSON (or YAML) file, then the ``TPUSC_*``
    environment overrides (``env=False`` skips them). With no path,
    ``./config.yaml`` is read when it exists, else the defaults. An explicit
    path that does not exist raises, where the reference quietly serves the
    defaults (a mistyped ``--config`` would start a node on the default
    ports)."""
    if path is None and os.path.exists("config.yaml"):
        path = "config.yaml"
    cfg = Config()
    if path:
        with open(path) as fh:
            if path.endswith((".yaml", ".yml")):
                import yaml

                data = yaml.safe_load(fh) or {}
            else:
                data = json.load(fh)
        _apply_mapping(cfg, data)
    if env:
        _apply_env(cfg, ENV_PREFIX)
    return cfg
