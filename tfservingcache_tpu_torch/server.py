"""Process wiring: build and run a cache node, and a router beside it when
``discovery.type`` is set (counterpart of ``tfservingcache_tpu/server.py``
for one group: one device, or with ``mesh.chips_per_group`` > 1 one device
group driven by this process).

provider -> disk cache -> runtime -> cache manager -> backend -> REST and
gRPC servers, plus the continuous generate engine when
``serving.generate_engine`` is ``"continuous"``; ``serving.batch_window_ms >
0`` puts the backend's batchers in front of the runtime. The node owns one
``Metrics`` and hands it down.

The gRPC server starts next to REST where ``grpcio`` and ``protobuf``
import; without them the node logs one line naming the missing package,
serves REST alone and ``node.grpc_port`` stays None. Its health service
reads the node's health, checked at start and every
``HEALTH_LOOP_PERIOD_S`` after (reference server.py:296-303).

The node's one group is a ``ServingGroup`` (``node.groups[0]``; ``manager``,
``backend``, ``rest``, ``grpc`` and the ports are its aliases), the ring
member a router advertises. With ``cluster.status_exchange`` (the default)
the group has a ``StatusCollector`` behind ``/monitoring/status`` and the
status piggyback, named by its ``host:rest:grpc`` ident once the ports are
bound; with a conversation tier, the gRPC server serves
``FetchParkedConversation`` from it. With ``cluster.peer_fetch`` (the
default) the provider is a ``PeerProvider`` around the configured one
(a router arms it) and the gRPC server serves ``FetchPackedModel`` from the
runtime's host tier.

``configure_observability`` applies the config to the process-wide
``TRACER``, ``RECORDER`` and ``LEDGER`` (the reference's ``serve`` does this,
server.py:325-348). ``serve`` (what ``cli serve`` runs) calls it, builds and
starts the node, then a ``cluster.router.Router`` when ``discovery.type`` is
set, and on stop closes the router before the node. A node built without
``configure_observability`` records all the same, and writes no dump.
"""

from __future__ import annotations

import logging
import threading

import torch

from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers import create_provider
from tfservingcache_tpu_torch.cluster.status import StatusCollector
from tfservingcache_tpu_torch.config import Config
from tfservingcache_tpu_torch.lab import faults as lab_faults
from tfservingcache_tpu_torch.parallel.mesh import chip_groups
from tfservingcache_tpu_torch.protocol.local_backend import LocalServingBackend
from tfservingcache_tpu_torch.protocol.rest import RestServingServer
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.utils.accounting import LEDGER
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER
from tfservingcache_tpu_torch.utils.metrics import Metrics
from tfservingcache_tpu_torch.utils.net import outbound_ip
from tfservingcache_tpu_torch.utils.tracing import TRACER

log = logging.getLogger("tpusc_torch.server")

HEALTH_LOOP_PERIOD_S = 30.0  # reference server.py:33


def _grpc_server_class():
    """``GrpcServingServer``, or None (logged once a node) when ``grpcio``
    or ``protobuf`` does not import."""
    try:
        from tfservingcache_tpu_torch.protocol.grpc_server import GrpcServingServer
    except ImportError as e:
        log.warning("gRPC surface off: package %r is not installed; serving REST only",
                    e.name or str(e))
        return None
    return GrpcServingServer


class ServingGroup:
    """One device group's serving stack (runtime -> manager -> backend ->
    its REST and gRPC servers): one ring member, addressed by its ports."""

    def __init__(self, index: int, manager: CacheManager, backend, rest, grpc) -> None:
        self.index = index
        self.manager = manager
        self.backend = backend
        self.rest = rest
        self.grpc = grpc
        self.rest_port = 0
        self.grpc_port: int | None = None
        self.status: StatusCollector | None = None  # fleet status plane


class CacheNode:
    """One serving host with one device or one device group: provider +
    disk cache + runtime behind a REST server and, where ``grpcio`` imports,
    a gRPC server."""

    def __init__(self, cfg: Config, runtime: TorchModelRuntime,
                 engine: ContinuousGenerateEngine | None = None,
                 metrics: Metrics | None = None) -> None:
        self.cfg = cfg
        self.metrics = metrics
        provider = create_provider(cfg.model_provider)
        if cfg.cluster.peer_fetch:
            # peer param distribution (cache/providers/peer.py): unbound it
            # passes every call through, until a Router arms it with the
            # fleet view
            from tfservingcache_tpu_torch.cache.providers.peer import PeerProvider

            provider = PeerProvider(
                provider, chunk_bytes=cfg.cluster.peer_fetch_chunk_bytes,
                timeout_s=cfg.cluster.peer_fetch_timeout_s,
                max_message_bytes=cfg.proxy.grpc_max_message_bytes,
                pin_entries=getattr(getattr(runtime, "device", None), "type", None) == "cuda")
        self.provider = provider
        self.disk_cache = ModelDiskCache(cfg.cache.base_dir, cfg.cache.disk_capacity_bytes)
        self.runtime = runtime
        manager = CacheManager(
            self.provider, self.disk_cache, runtime,
            load_timeout_s=cfg.serving.load_timeout_s, metrics=metrics,
            version_labels=cfg.serving.version_labels,
        )
        self.engine = engine
        backend = LocalServingBackend(
            manager, generator=engine, spec_draft_model=cfg.serving.spec_draft_model,
            batch_window_ms=cfg.serving.batch_window_ms,
            batch_max_size=cfg.serving.batch_max_size,
        )
        rest = RestServingServer(backend, metrics, metrics_path=cfg.metrics.path,
                                 metrics_scrape_targets=cfg.metrics.scrape_targets,
                                 metrics_sum_counters=cfg.metrics.scrape_sum_counters)
        grpc_cls = _grpc_server_class()
        grpc = (grpc_cls(backend, metrics, cfg.proxy.grpc_max_message_bytes)
                if grpc_cls is not None else None)
        if grpc is not None and cfg.cluster.peer_fetch:
            # the outbound half: this node's host-tier entries served to
            # cold peers (NOT_FOUND while the tier is off or lacks the model)
            from tfservingcache_tpu_torch.protocol.peer_transfer import PeerSource

            grpc.peer_source = PeerSource(
                runtime, chunk_bytes=cfg.cluster.peer_fetch_chunk_bytes,
                max_inflight_per_peer=cfg.cluster.peer_fetch_max_inflight_per_peer)
        if grpc is not None and engine is not None:
            # conversation KV migration: parked turns served to the peer
            # that takes the conversation over
            grpc.conversation_tier = engine.conversation_tier
        group = ServingGroup(0, manager, backend, rest, grpc)
        if cfg.cluster.status_exchange:
            # named group0 until start() binds the ports
            group.status = StatusCollector(
                "group0", manager, metrics=metrics,
                byte_cap=cfg.cluster.status_byte_cap,
                max_models=cfg.cluster.status_max_models,
                min_interval_s=cfg.cluster.status_min_interval_s,
                max_tenants=cfg.cluster.status_max_tenants,
            )
            rest.status_collector = group.status
            if grpc is not None:
                grpc.status_collector = group.status
        # multi-group nodes are a later slice: node_group raises for them
        self.groups: list[ServingGroup] = [group]
        self._stop_health = threading.Event()
        self._health_thread: threading.Thread | None = None

    # group-0 aliases
    @property
    def manager(self) -> CacheManager:
        return self.groups[0].manager

    @property
    def backend(self) -> LocalServingBackend:
        return self.groups[0].backend

    @property
    def rest(self) -> RestServingServer:
        return self.groups[0].rest

    @property
    def grpc(self):
        return self.groups[0].grpc

    @property
    def rest_port(self) -> int:
        return self.groups[0].rest_port

    @property
    def grpc_port(self) -> int | None:
        return self.groups[0].grpc_port

    def start(self, host: str = "0.0.0.0") -> int:
        """Bind the REST server (``cache_node.rest_port``) and the gRPC
        server (``cache_node.grpc_port``), 0 = ephemeral; returns the REST
        port (the gRPC one is ``grpc_port``)."""
        g = self.groups[0]
        g.rest_port = g.rest.start(self.cfg.cache_node.rest_port, host)
        if g.grpc is not None:
            g.grpc_port = g.grpc.start(self.cfg.cache_node.grpc_port, host)
            g.grpc.set_health(self.is_healthy())
            self._health_thread = threading.Thread(
                target=self._health_loop, name="tpusc-health", daemon=True)
            self._health_thread.start()
        if g.status is not None:
            # the ring ident peers see, also without a router beside it
            ident_host = ("127.0.0.1" if self.cfg.discovery.prefer_localhost
                          else outbound_ip())
            g.status.ident = f"{ident_host}:{g.rest_port}:{g.grpc_port or 0}"
        return g.rest_port

    def _health_loop(self) -> None:
        while not self._stop_health.wait(HEALTH_LOOP_PERIOD_S):
            self.grpc.set_health(self.is_healthy())

    def is_healthy(self) -> bool:
        return self.manager.is_healthy()

    def close(self) -> None:
        self._stop_health.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=10.0)
            self._health_thread = None
        self.rest.close()
        if self.grpc is not None:
            self.grpc.close()
        if self.engine is not None:  # the engine's threads use the runtime
            self.engine.close()
        self.manager.close()
        close_provider = getattr(self.provider, "close", None)
        if close_provider is not None:
            close_provider()


def node_group(device: str | torch.device, chips_per_group: int) -> list[torch.device]:
    """The device group of a node with ``mesh.chips_per_group`` > 1 (the
    reference's ``chip_groups`` over the host's devices, server.py:113-150,
    cut to one group): on ``cuda`` the first ``chips_per_group`` CUDA
    devices; on ``cpu`` that many copies of the CPU device (the tests'
    virtual group). Raises when the host has fewer CUDA devices, or so many
    that it would form more than one group."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * chips_per_group
    if dev.type != "cuda":
        raise RuntimeError_(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError_(f"device {device!r} requested but CUDA is not available")
    n = torch.cuda.device_count()
    if n < chips_per_group:
        raise RuntimeError_(
            f"mesh.chips_per_group={chips_per_group} needs {chips_per_group} CUDA devices, "
            f"this host has {n}"
        )
    groups = chip_groups([torch.device("cuda", i) for i in range(n)], chips_per_group)
    if len(groups) > 1:
        raise RuntimeError_(
            f"multi-group nodes: later slice (multi-GPU): {n} CUDA devices form {len(groups)} "
            f"groups of {chips_per_group}"
        )
    return list(groups[0])


def configure_observability(cfg: Config) -> None:
    """Apply ``tracing``, ``observability`` and ``logging`` to the
    process-wide tracer, flight recorder and tenant ledger, and hook the
    recorder's SLO-breach dump to the tracer's slow retention (reference
    server.py:325-348). Dumps arm only here, with ``flight_dir``."""
    TRACER.configure(
        capacity=cfg.tracing.capacity,
        slow_threshold_s=cfg.tracing.slow_threshold_ms / 1000.0,
        slow_capacity=cfg.tracing.slow_capacity,
    )
    RECORDER.configure(
        flight_dir=cfg.observability.flight_dir or None,
        ring_entries=cfg.observability.ring_entries,
        max_dumps=cfg.observability.max_dumps,
        dump_cooldown_s=cfg.observability.dump_cooldown_s,
    )
    RECORDER.install_slow_hook(TRACER)
    LEDGER.configure(
        enabled=cfg.observability.tenant_accounting,
        noisy_share=cfg.observability.noisy_neighbor_share,
        noisy_window_s=cfg.observability.noisy_neighbor_window_s,
        noisy_min_step_s=cfg.observability.noisy_neighbor_min_step_s,
    )


def build_node(cfg: Config, device: str | torch.device | None = None) -> CacheNode:
    """A ``CacheNode`` on ``device`` (default: ``cfg.serving.device``, which
    defaults to ``cuda``; a missing card raises rather than falling back).
    With ``mesh.chips_per_group`` > 1 its runtime is bound to one device
    group (``node_group``)."""
    device = device or cfg.serving.device
    metrics = Metrics(model_labels=cfg.metrics.model_labels,
                      max_model_labels=cfg.metrics.max_model_labels)
    if cfg.observability.lab_faults:
        # a scenario-lab drill (reference server.py:349-355), armed before
        # anything is built: a malformed spec raises here and leaves no
        # thread behind
        lab_faults.arm_json(cfg.observability.lab_faults, metrics=metrics)
    if cfg.mesh.chips_per_group > 1:
        runtime = TorchModelRuntime(
            cfg.serving, devices=node_group(device, cfg.mesh.chips_per_group),
            metrics=metrics, host_tier_bytes=cfg.cache.host_tier_bytes)
    else:
        runtime = TorchModelRuntime(cfg.serving, device=device, metrics=metrics,
                                    host_tier_bytes=cfg.cache.host_tier_bytes)
    engine = None
    if cfg.serving.generate_engine == "continuous":
        engine = ContinuousGenerateEngine(
            runtime, slots=cfg.serving.generate_slots,
            chunk_tokens=cfg.serving.generate_chunk_tokens,
            spec_draft_model=cfg.serving.spec_draft_model,
            spec_tokens=cfg.serving.spec_tokens,
            share_prefix_bytes=cfg.serving.kv_share_prefix_bytes,
            prefill_chunk_tokens=cfg.serving.prefill_chunk_tokens,
            metrics=metrics,
        )
    return CacheNode(cfg, runtime, engine, metrics)


def serve(cfg: Config, stop: threading.Event, device: str | None = None) -> None:
    """Run a cache node, and a router beside it when ``discovery.type`` is
    set, until ``stop`` is set; the router closes before the node."""
    configure_observability(cfg)
    node = build_node(cfg, device)
    router = None
    try:
        port = node.start()
        log.info("cache node serving REST on :%d, gRPC on %s (device %s)", port,
                 f":{node.grpc_port}" if node.grpc_port is not None else "none",
                 node.runtime.device)
        if cfg.discovery.type:
            from tfservingcache_tpu_torch.cluster.router import Router

            router = Router(cfg, node)
            router.start()
        stop.wait()
        log.info("shutting down")
    finally:
        if router is not None:
            router.close()
        node.close()
