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

A group that spans processes (``mesh.coordinator`` set, ``mesh.num_processes
> 1``; ``parallel/multihost.py``): ``build_node`` joins the
``torch.distributed`` process group first, then builds the group with this
process's ``chips_per_group / num_processes`` members (``node_group``, or
``devices=``) and meta placeholders for the others. Process 0 leads: its
runtime is a ``MultiHostGroupRuntime`` whose followers are the other
processes' ``mesh.worker_addrs``, and its node serves as any node does.
Every other process builds a FOLLOWER node: its own disk cache, a cache
manager and a runtime over the group behind a ``GroupWorkHandler`` and a
``GroupWorkServer`` bound to its own ``worker_addrs`` port; it leads no
group (``node.groups`` is empty) and binds no REST or gRPC port. Closing a
node that joined the process group destroys it. Multi-group nodes stay a
later slice.

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
from tfservingcache_tpu_torch.parallel import multihost
from tfservingcache_tpu_torch.parallel.mesh import chip_groups, cross_process_group
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
    a gRPC server. ``follower=True`` builds the follower of a group that
    spans processes: provider + disk cache + runtime behind the group-work
    service only (``work_handler``, ``work_server``; ``groups`` is empty).
    ``process_group``: the node joined the ``torch.distributed`` process
    group, and its close destroys it."""

    def __init__(self, cfg: Config, runtime: TorchModelRuntime,
                 engine: ContinuousGenerateEngine | None = None,
                 metrics: Metrics | None = None, follower: bool = False,
                 process_group: bool = False) -> None:
        self.cfg = cfg
        self.metrics = metrics
        self._process_group = process_group
        self._stop_health = threading.Event()
        self._health_thread: threading.Thread | None = None
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
        self._manager = manager
        self.engine = engine
        # the follower work service (a group that spans processes)
        self.work_handler: multihost.GroupWorkHandler | None = None
        self.work_server: multihost.GroupWorkServer | None = None
        if follower:
            self.work_handler = multihost.GroupWorkHandler()
            self.work_handler.register(0, manager, runtime)
            self.work_server = multihost.GroupWorkServer(self.work_handler)
            self.groups: list[ServingGroup] = []
            return
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
        self.groups = [group]

    # group-0 aliases
    @property
    def manager(self) -> CacheManager:
        """The node's cache manager (a follower's too)."""
        return self._manager

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
        port (the gRPC one is ``grpc_port``). A follower binds only its work
        service, on the port of its ``mesh.worker_addrs`` entry, and
        returns that port."""
        if self.work_server is not None:
            me, addrs = self.cfg.mesh.process_id, self.cfg.mesh.worker_addrs
            port = int(addrs[me].rsplit(":", 1)[1]) if me < len(addrs) and ":" in addrs[me] else 0
            bound = self.work_server.start(port, host)
            log.info("group work service on :%d (follower of group 0)", bound)
            return bound
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
        for g in self.groups:
            g.rest.close()
            if g.grpc is not None:
                g.grpc.close()
        if self.engine is not None:  # the engine's threads use the runtime
            self.engine.close()
        if self.work_server is not None:
            self.work_server.close()
        self.manager.close()
        close_provider = getattr(self.provider, "close", None)
        if close_provider is not None:
            close_provider()
        if self._process_group:
            multihost.leave_process_group()
            self._process_group = False


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


def _spans_processes(cfg: Config) -> bool:
    return bool(cfg.mesh.coordinator) and cfg.mesh.num_processes > 1


def _cross_process_node(cfg: Config, device: str | torch.device,
                        devices: list[str | torch.device] | None,
                        metrics: Metrics) -> CacheNode:
    """A node of a group that spans processes (the process group is joined
    already): the leader's or a follower's (reference server.py:113-167)."""
    mesh = cfg.mesh
    n, me = mesh.num_processes, mesh.process_id
    if mesh.chips_per_group < n or mesh.chips_per_group % n:
        raise RuntimeError_(
            f"mesh.chips_per_group={mesh.chips_per_group} does not divide over "
            f"mesh.num_processes={n} processes"
        )
    if len(mesh.worker_addrs) != n:
        raise RuntimeError_(
            f"mesh.worker_addrs has {len(mesh.worker_addrs)} entries, one per process "
            f"({n}) expected"
        )
    per = mesh.chips_per_group // n
    local = list(devices) if devices is not None else node_group(device, per)
    if len(local) != per:
        raise RuntimeError_(f"{len(local)} local devices for {per} members a process")
    group = list(cross_process_group(local, n, me))
    if me == 0:
        runtime = multihost.MultiHostGroupRuntime(
            cfg.serving, devices=group, metrics=metrics,
            followers=[a for p, a in enumerate(mesh.worker_addrs) if p != me], group_index=0)
        # a cross-process group is lockstep: no engine (reference
        # local_backend.py:128-133)
        return CacheNode(cfg, runtime, None, metrics, process_group=True)
    runtime = TorchModelRuntime(cfg.serving, devices=group, metrics=metrics)
    return CacheNode(cfg, runtime, None, metrics, follower=True, process_group=True)


def build_node(cfg: Config, device: str | torch.device | None = None,
               devices: list[str | torch.device] | None = None) -> CacheNode:
    """A ``CacheNode`` on ``device`` (default: ``cfg.serving.device``, which
    defaults to ``cuda``; a missing card raises rather than falling back).
    With ``mesh.chips_per_group`` > 1 its runtime is bound to one device
    group (``node_group``); ``devices`` binds it to that group instead (a
    group that repeats one card, say). With ``mesh.coordinator`` and
    ``mesh.num_processes > 1`` the group spans processes: the node first
    joins the process group (rank ``mesh.process_id``), then builds the
    leader's node (process 0) or a follower's, ``devices`` naming this
    process's own members."""
    device = device or cfg.serving.device
    if _spans_processes(cfg):
        # the rendezvous before anything else is built (reference
        # server.py:88-111)
        multihost.join_process_group(cfg.mesh.coordinator, cfg.mesh.num_processes,
                                     cfg.mesh.process_id)
    metrics = Metrics(model_labels=cfg.metrics.model_labels,
                      max_model_labels=cfg.metrics.max_model_labels)
    if cfg.observability.lab_faults:
        # a scenario-lab drill (reference server.py:349-355), armed before
        # anything is built: a malformed spec raises here and leaves no
        # thread behind
        lab_faults.arm_json(cfg.observability.lab_faults, metrics=metrics)
    if _spans_processes(cfg):
        try:
            return _cross_process_node(cfg, device, devices, metrics)
        except BaseException:
            multihost.leave_process_group()
            raise
    if devices is None and cfg.mesh.chips_per_group > 1:
        devices = node_group(device, cfg.mesh.chips_per_group)
    if devices is not None:
        # the reference's node gives a group runtime no host tier
        # (server.py:142-143, :168-172); a runtime built with devices= and
        # host_tier_bytes directly keeps one
        runtime = TorchModelRuntime(cfg.serving, devices=devices, metrics=metrics)
    else:
        runtime = TorchModelRuntime(cfg.serving, device=device, metrics=metrics,
                                    host_tier_bytes=cfg.cache.host_tier_bytes)
    engine = None
    # a lockstep group (serving.mesh_fast_path off) keeps the coalescer
    # (reference local_backend.py:128-133)
    if cfg.serving.generate_engine == "continuous" and not runtime.mesh_lockstep:
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
        if node.work_server is not None:
            # a follower of a group that spans processes: the group-work
            # service until stopped; the leader is the group's ring member
            log.info("group follower (process %d) serving group work on :%d (device %s)",
                     cfg.mesh.process_id, port, node.runtime.device)
            stop.wait()
            log.info("shutting down")
            return
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
