"""Fleet status plane: cross-node residency and health exchange
(counterpart of ``tfservingcache_tpu/cluster/status.py``).

- ``NodeStatus`` / ``StatusCollector``: one ring member's compact snapshot
  (each model's residency tier from ``CacheManager.residency_warmth``, the
  engine's goodput, queue depth and oldest wait from the flight recorder,
  KV pages free, in-flight requests, the tenant cost summary), cached for
  ``status_min_interval_s`` so that a piggyback costs a timestamp compare.
- The wire: a router that wants status sends ``x-tpusc-status-want`` (REST
  header) or ``tpusc-status-want`` (gRPC metadata) on a forwarded request;
  the peer answers with its zlib + base64 ``NodeStatus`` in the
  ``x-tpusc-status`` response header or the ``tpusc-status`` trailer. Peers
  no routed hop reaches are polled at ``GET /monitoring/status``
  (``StatusExchange``). ``encode`` bounds the payload to a byte cap by
  cutting the tenant rows, then the coldest models, and stamps how many
  were cut. The blob is the reference's byte for byte.
- ``FleetView``: each peer's latest status, its age and the EWMAs of this
  node's forwards to it, published as ``GET /monitoring/cluster``, the
  ``tpusc_peer_health_score`` / ``tpusc_peer_status_age_seconds`` /
  ``tpusc_fleet_model_replicas`` gauges, and the router's signals
  (``warmth`` for the equal-load tie-break, ``health`` for the soft
  route-around).

REST handlers, gRPC workers, the poll thread and the cluster's update
thread all reach one ``FleetView``, so its peer table is under a lock (the
reference's runs on one event loop).
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import urllib.request
import zlib
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from tfservingcache_tpu_torch.lab import faults as lab_faults
from tfservingcache_tpu_torch.types import NodeInfo
from tfservingcache_tpu_torch.utils.accounting import DIMENSIONS, LEDGER
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER

if TYPE_CHECKING:
    from tfservingcache_tpu_torch.cache.manager import CacheManager
    from tfservingcache_tpu_torch.utils.accounting import TenantLedger
    from tfservingcache_tpu_torch.utils.metrics import Metrics

log = logging.getLogger("tpusc_torch.status")

STATUS_WANT_HEADER = "x-tpusc-status-want"   # REST request header
STATUS_HEADER = "x-tpusc-status"             # REST response header
STATUS_WANT_METADATA = "tpusc-status-want"   # gRPC invocation metadata
STATUS_TRAILER = "tpusc-status"              # gRPC trailing metadata

# residency_warmth tier -> wire / display name
TIER_NAMES = {3: "hbm", 2: "host", 1: "disk"}

DEFAULT_BYTE_CAP = 4096


@dataclass
class NodeStatus:
    """One ring member's self-reported state at ``t_wall``. ``models`` maps
    routing key (``name##version``) -> warmth tier (3 device, 2 host, 1
    disk); cold models are absent. ``seq`` grows with each fresh collection,
    so a receiver drops reorderings without comparing clocks."""

    ident: str
    seq: int = 0
    t_wall: float = 0.0
    models: dict[str, int] = field(default_factory=dict)
    inflight: int = 0
    queue_depth: int = 0
    oldest_wait_s: float = 0.0
    goodput: float = 1.0
    kv_pages_free: int = 0
    kv_pages_total: int = 0
    kv_pages_shared: int = 0
    host_tier_bytes: int = 0
    models_resident: int = 0
    truncated: int = 0  # models cut from ``models`` to fit the byte cap
    # "name@version" -> accounting.DIMENSIONS vector, by dominant share
    tenants: dict[str, list[float]] = field(default_factory=dict)
    tenants_truncated: int = 0

    def to_dict(self) -> dict:
        return {
            "ident": self.ident,
            "seq": self.seq,
            "t_wall": round(self.t_wall, 3),
            "models": self.models,
            "inflight": self.inflight,
            "queue_depth": self.queue_depth,
            "oldest_wait_s": round(self.oldest_wait_s, 3),
            "goodput": round(self.goodput, 4),
            "kv_pages_free": self.kv_pages_free,
            "kv_pages_total": self.kv_pages_total,
            "kv_pages_shared": self.kv_pages_shared,
            "host_tier_bytes": self.host_tier_bytes,
            "models_resident": self.models_resident,
            "truncated": self.truncated,
            "tenants": self.tenants,
            "tenants_truncated": self.tenants_truncated,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NodeStatus | None":
        """Never raises: a malformed peer payload is dropped."""
        try:
            if not isinstance(d, dict) or not d.get("ident"):
                return None
            models = {str(k): int(v) for k, v in (d.get("models") or {}).items() if int(v) > 0}
            return cls(
                ident=str(d["ident"]),
                seq=int(d.get("seq", 0)),
                t_wall=float(d.get("t_wall", 0.0)),
                models=models,
                inflight=int(d.get("inflight", 0)),
                queue_depth=int(d.get("queue_depth", 0)),
                oldest_wait_s=float(d.get("oldest_wait_s", 0.0)),
                goodput=float(d.get("goodput", 1.0)),
                kv_pages_free=int(d.get("kv_pages_free", 0)),
                kv_pages_total=int(d.get("kv_pages_total", 0)),
                kv_pages_shared=int(d.get("kv_pages_shared", 0)),
                host_tier_bytes=int(d.get("host_tier_bytes", 0)),
                models_resident=int(d.get("models_resident", 0)),
                truncated=int(d.get("truncated", 0)),
                tenants={str(k): [float(x) for x in v]
                         for k, v in (d.get("tenants") or {}).items()
                         if isinstance(v, (list, tuple))},
                tenants_truncated=int(d.get("tenants_truncated", 0)),
            )
        except (TypeError, ValueError):
            return None

    def encode(self, byte_cap: int = DEFAULT_BYTE_CAP) -> str:
        """zlib + base64 compact JSON of at most ``byte_cap`` bytes: over
        the cap, the tenant rows are halved from the cheapest end, then the
        models from the coldest, each cut stamped; "" when even the
        model-free status does not fit."""
        d = self.to_dict()
        blob = _pack(d)
        while len(blob) > byte_cap and d["tenants"]:
            items = list(d["tenants"].items())
            keep = len(items) // 2
            d["tenants"] = dict(items[:keep])
            d["tenants_truncated"] = self.tenants_truncated + len(self.tenants) - keep
            blob = _pack(d)
        while len(blob) > byte_cap and d["models"]:
            items = sorted(d["models"].items(), key=lambda kv: (-kv[1], kv[0]))
            keep = len(items) // 2
            d["models"] = dict(items[:keep])
            d["truncated"] = len(self.models) - keep
            blob = _pack(d)
        return blob if len(blob) <= byte_cap else ""

    @staticmethod
    def decode(blob: str | bytes | None) -> "NodeStatus | None":
        """Inverse of encode; never raises."""
        if not blob:
            return None
        try:
            raw = zlib.decompress(base64.b64decode(blob))
            return NodeStatus.from_dict(json.loads(raw))
        except Exception:  # noqa: BLE001 - wire input, any shape of garbage
            return None


def _pack(d: dict) -> str:
    return base64.b64encode(zlib.compress(json.dumps(d, separators=(",", ":")).encode(),
                                          6)).decode()


def _gauge_value(gauge) -> float:
    """An unlabelled gauge's value (0.0 for a family the node lacks)."""
    try:
        return float(gauge._only().value)
    except Exception:  # noqa: BLE001 - advisory
        return 0.0


def _gauge_sum(gauge) -> float:
    """The sum over a labelled gauge's series."""
    try:
        with gauge.lock:
            return float(sum(c.value for c in gauge._children.values()))
    except Exception:  # noqa: BLE001 - advisory
        return 0.0


class StatusCollector:
    """Collects this ring member's ``NodeStatus``. ``ident`` starts as a
    placeholder; the node rebinds it to ``host:rest:grpc`` once its ports
    are bound. A collection and its encoding are cached for
    ``min_interval_s``."""

    def __init__(
        self,
        ident: str,
        manager: "CacheManager",
        metrics: "Metrics | None" = None,
        byte_cap: int = DEFAULT_BYTE_CAP,
        max_models: int = 64,
        min_interval_s: float = 0.25,
        ledger: "TenantLedger | None" = None,
        max_tenants: int = 8,
    ) -> None:
        self.ident = ident
        self.manager = manager
        self.metrics = metrics
        self.byte_cap = int(byte_cap)
        self.max_models = max(1, int(max_models))
        self.min_interval_s = float(min_interval_s)
        self.ledger = LEDGER if ledger is None else ledger
        self.max_tenants = max(0, int(max_tenants))
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        self._cached: NodeStatus | None = None  # guarded-by: _lock
        self._cached_blob = ""  # guarded-by: _lock
        self._cached_mono = 0.0  # guarded-by: _lock

    def collect(self) -> NodeStatus:
        """The cached snapshot, or a fresh one once it aged out."""
        with self._lock:
            now = time.monotonic()
            if self._cached is not None and now - self._cached_mono < self.min_interval_s:
                self._cached.ident = self.ident  # the ident may be rebound
                return self._cached
            st = self._collect_fresh()
            self._cached, self._cached_blob, self._cached_mono = (
                st, st.encode(self.byte_cap), now)
            return st

    def encoded(self) -> str:
        """The cached wire form for a piggyback ("" = nothing to send)."""
        self.collect()
        with self._lock:
            return self._cached_blob

    def _collect_fresh(self) -> NodeStatus:
        self._seq += 1
        models: dict[str, int] = {}
        truncated = 0
        try:
            # the disk cache lists every model a tier holds; warmth grades it
            for mid in self.manager.list_cached():
                w = self.manager.residency_warmth(mid)
                if w > 0:
                    models[mid.key] = w
        except Exception:  # noqa: BLE001 - status must never fail serving
            pass
        if len(models) > self.max_models:
            items = sorted(models.items(), key=lambda kv: (-kv[1], kv[0]))
            truncated = len(items) - self.max_models
            models = dict(items[: self.max_models])
        engine = RECORDER.engine_stats()
        st = NodeStatus(
            ident=self.ident,
            seq=self._seq,
            t_wall=time.time(),
            models=models,
            queue_depth=int(engine["queue_depth"]),
            oldest_wait_s=float(engine["oldest_wait_ms"]) / 1000.0,
            goodput=float(engine["goodput"]),
            models_resident=sum(1 for w in models.values() if w == 3),
            truncated=truncated,
        )
        m = self.metrics
        if m is not None:
            st.inflight = int(_gauge_sum(m.requests_in_flight))
            used = _gauge_value(m.gen_kv_pages_used)
            total = _gauge_value(m.gen_kv_pages_total)
            st.kv_pages_total = int(total)
            st.kv_pages_free = max(0, int(total - used))
            st.kv_pages_shared = int(_gauge_value(m.gen_kv_pages_shared))
            st.host_tier_bytes = int(_gauge_value(getattr(m, "host_tier_bytes", None)))
        if self.max_tenants > 0:
            try:
                st.tenants = self.ledger.summary(self.max_tenants)
            except Exception:  # noqa: BLE001 - status must never fail serving
                pass
        return st


@dataclass
class _PeerState:
    status: NodeStatus | None = None
    received_mono: float | None = None
    err_ewma: float = 0.0
    latency_ewma_s: float = 0.0
    forwards: int = 0
    failures: int = 0


class FleetView:
    """Every peer's latest ``NodeStatus`` and this node's forwarding record
    with it."""

    def __init__(
        self,
        metrics: "Metrics | None" = None,
        stale_after_s: float = 15.0,
        health_threshold: float = 0.5,
        error_alpha: float = 0.3,
        latency_ref_s: float = 1.0,
    ) -> None:
        self.metrics = metrics
        self.stale_after_s = float(stale_after_s)
        self.health_threshold = float(health_threshold)
        self.error_alpha = float(error_alpha)
        self.latency_ref_s = float(latency_ref_s)
        self._lock = threading.RLock()
        self._peers: dict[str, _PeerState] = {}  # guarded-by: _lock

    # -- ingestion -----------------------------------------------------------
    def ingest(self, status: NodeStatus | None) -> bool:
        """Take a peer's snapshot (piggybacked or polled); an older ``seq``
        than the one held only refreshes the peer's age."""
        if status is None or not status.ident:
            return False
        # scenario-lab hook: drop_peer swallows the snapshot, so the peer's
        # health decays through the staleness path
        status = lab_faults.fire("status_ingest", peer=status.ident, payload=status)
        if status is None:
            return False
        with self._lock:
            ps = self._peers.setdefault(status.ident, _PeerState())
            if ps.status is not None and status.seq <= ps.status.seq:
                ps.received_mono = time.monotonic()
                self._publish_peer(status.ident, ps)
                return False
            ps.status = status
            ps.received_mono = time.monotonic()
            self._publish_peer(status.ident, ps)
            self._publish_replicas()
            return True

    def ingest_encoded(self, blob: str | bytes | None) -> bool:
        return self.ingest(NodeStatus.decode(blob))

    def note_forward(self, ident: str, ok: bool, latency_s: float | None = None) -> None:
        """One forwarding attempt's outcome: only a connection failure is
        ``ok=False`` (an application error reached a live peer)."""
        with self._lock:
            ps = self._peers.setdefault(ident, _PeerState())
            a = self.error_alpha
            ps.err_ewma = a * (0.0 if ok else 1.0) + (1 - a) * ps.err_ewma
            if ok and latency_s is not None:
                ps.latency_ewma_s = a * latency_s + (1 - a) * ps.latency_ewma_s
            ps.forwards += 1
            if not ok:
                ps.failures += 1
            self._publish_peer(ident, ps)

    # -- signals -------------------------------------------------------------
    def health(self, ident: str) -> float:
        """Forward-error EWMA x latency factor x staleness decay, in [0, 1];
        an unknown peer scores 1.0."""
        with self._lock:
            ps = self._peers.get(ident)
            return 1.0 if ps is None else self._score(ps)

    def _score(self, ps: _PeerState) -> float:
        score = 1.0 - ps.err_ewma
        score *= self.latency_ref_s / (self.latency_ref_s + ps.latency_ewma_s)
        age = self._age(ps)
        if age is not None and age > self.stale_after_s > 0:
            score *= self.stale_after_s / age  # 2x stale scores half
        return score

    @staticmethod
    def _age(ps: _PeerState) -> float | None:
        if ps.received_mono is None:
            return None
        return time.monotonic() - ps.received_mono

    def status_age_s(self, ident: str) -> float | None:
        """Seconds since this peer's status was heard (None = never)."""
        with self._lock:
            ps = self._peers.get(ident)
            return self._age(ps) if ps is not None else None

    def warmth(self, ident: str, key: str) -> int:
        """The peer's advertised tier of routing key ``key`` (0 = cold,
        unknown or stale)."""
        with self._lock:
            ps = self._peers.get(ident)
            if ps is None or ps.status is None:
                return 0
            age = self._age(ps)
            if age is not None and age > self.stale_after_s > 0:
                return 0
            return ps.status.models.get(key, 0)

    # -- publication ---------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``GET /monitoring/cluster`` payload: a row a node, the
        per-model residency map and the fleet's tenant cost table."""
        nodes: dict[str, dict] = {}
        models: dict[str, dict[str, list[str]]] = {}
        tenant_sums: dict[str, list[float]] = {}
        tenant_nodes: dict[str, list[str]] = {}
        n_dims = len(DIMENSIONS)
        with self._lock:
            for ident, ps in sorted(self._peers.items()):
                age = self._age(ps)
                st = ps.status
                row = {
                    "health": round(self._score(ps), 4),
                    "status_age_s": round(age, 3) if age is not None else None,
                    "stale": bool(age is None or age > self.stale_after_s),
                    "err_ewma": round(ps.err_ewma, 4),
                    "latency_ewma_ms": round(ps.latency_ewma_s * 1e3, 3),
                    "forwards": ps.forwards,
                    "failures": ps.failures,
                }
                if st is not None:
                    row.update(
                        seq=st.seq,
                        inflight=st.inflight,
                        queue_depth=st.queue_depth,
                        oldest_wait_s=st.oldest_wait_s,
                        goodput=st.goodput,
                        kv_pages_free=st.kv_pages_free,
                        kv_pages_total=st.kv_pages_total,
                        kv_pages_shared=st.kv_pages_shared,
                        host_tier_bytes=st.host_tier_bytes,
                        models_resident=st.models_resident,
                        models_truncated=st.truncated,
                    )
                    for key, tier in st.models.items():
                        entry = models.setdefault(key, {name: [] for name in TIER_NAMES.values()})
                        entry[TIER_NAMES.get(tier, "disk")].append(ident)
                    for tkey, vec in st.tenants.items():
                        cur = tenant_sums.setdefault(tkey, [0.0] * n_dims)
                        for i in range(min(n_dims, len(vec))):
                            cur[i] += vec[i]
                        tenant_nodes.setdefault(tkey, []).append(ident)
                nodes[ident] = row
                self._publish_peer(ident, ps)
        return {
            "nodes": nodes,
            "models": models,
            "tenants": self._aggregate_tenants(tenant_sums, tenant_nodes),
            "stale_after_s": self.stale_after_s,
            "health_threshold": self.health_threshold,
        }

    @staticmethod
    def _aggregate_tenants(sums: dict[str, list[float]],
                           by_node: dict[str, list[str]]) -> dict[str, dict]:
        """Fleet-wide dominant shares from the summed vectors (a tenant's
        share of each dimension's fleet total, maxed over dimensions),
        most expensive first."""
        n_dims = len(DIMENSIONS)
        dim_totals = [sum(vec[i] for vec in sums.values()) for i in range(n_dims)]
        rows: dict[str, dict] = {}
        for tkey, vec in sums.items():
            best, best_dim = 0.0, DIMENSIONS[0]
            for i in range(n_dims):
                if dim_totals[i] > 0.0:
                    s = vec[i] / dim_totals[i]
                    if s > best:
                        best, best_dim = s, DIMENSIONS[i]
            rows[tkey] = {
                "totals": {DIMENSIONS[i]: round(vec[i], 3) for i in range(n_dims)},
                "dominant_share": round(best, 6),
                "dominant_dim": best_dim,
                "nodes": by_node.get(tkey, []),
            }
        return {t: rows[t] for t in sorted(rows, key=lambda t: rows[t]["dominant_share"],
                                           reverse=True)}

    def _publish_peer(self, ident: str, ps: _PeerState) -> None:
        if self.metrics is None:
            return
        self.metrics.peer_health_score.labels(ident).set(self._score(ps))
        age = self._age(ps)
        if age is not None:
            self.metrics.peer_status_age.labels(ident).set(age)

    def _publish_replicas(self) -> None:
        """Recount ``tpusc_fleet_model_replicas{model,tier}`` from scratch
        (counts shrink when peers evict)."""
        if self.metrics is None:
            return
        counts: dict[tuple[str, str], int] = {}
        for ps in self._peers.values():
            if ps.status is None:
                continue
            for key, tier in ps.status.models.items():
                label = key.replace("##", ":", 1)  # name##v -> name:v
                tname = TIER_NAMES.get(tier, "disk")
                counts[(label, tname)] = counts.get((label, tname), 0) + 1
        self.metrics.fleet_model_replicas.clear()
        for (model, tier), n in counts.items():
            self.metrics.fleet_model_replicas.labels(model, tier).set(n)

    def prune(self, nodes: list[NodeInfo]) -> None:
        """Membership callback: forget departed peers and their series."""
        live = {n.ident for n in nodes}
        with self._lock:
            for ident in [i for i in self._peers if i not in live]:
                del self._peers[ident]
                if self.metrics is not None:
                    for gauge in (self.metrics.peer_health_score, self.metrics.peer_status_age):
                        try:
                            gauge.remove(ident)
                        except KeyError:
                            pass
            self._publish_replicas()


class StatusExchange:
    """The poll fallback: every ``poll_interval_s`` a thread folds this
    host's own collectors into the ``FleetView`` and fetches
    ``/monitoring/status`` from each peer whose status is older than the
    interval (piggybacked hops keep the others fresh). ``poll_once`` is one
    round, which tests call directly."""

    def __init__(self, fleet: FleetView, local: dict[str, StatusCollector],
                 poll_interval_s: float = 5.0, poll_timeout_s: float = 2.0) -> None:
        self.fleet = fleet
        self.local = dict(local)
        self.poll_interval_s = float(poll_interval_s)
        self.poll_timeout_s = float(poll_timeout_s)
        self._nodes: list[NodeInfo] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def on_update(self, nodes: list[NodeInfo]) -> None:
        """Membership callback: track the live members."""
        self._nodes = list(nodes)

    def poll_once(self) -> int:
        """One round; -> how many statuses were new."""
        refreshed = 0
        for collector in self.local.values():
            if self.fleet.ingest(collector.collect()):
                refreshed += 1
        for node in list(self._nodes):
            if node.ident in self.local:
                continue
            age = self.fleet.status_age_s(node.ident)
            if age is not None and age < self.poll_interval_s:
                continue
            st = self._fetch(node)
            if st is not None and self.fleet.ingest(st):
                refreshed += 1
        return refreshed

    def _fetch(self, node: NodeInfo) -> NodeStatus | None:
        url = f"http://{node.host}:{node.rest_port}/monitoring/status"
        try:
            with urllib.request.urlopen(url, timeout=self.poll_timeout_s) as resp:
                if resp.status != 200:
                    return None
                return NodeStatus.from_dict(json.loads(resp.read()))
        except Exception as e:  # noqa: BLE001 - a dead peer is just stale
            log.debug("status poll of %s failed: %s", node.ident, e)
            return None

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, name="tpusc-status-exchange",
                                            daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the loop outlives one bad round
                log.exception("status exchange round failed")
            self._stop.wait(self.poll_interval_s)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_timeout_s * max(1, len(self._nodes)) + 5.0)
            self._thread = None
