"""PeerProvider: a cold miss sourced from a warm peer before the store
(counterpart of ``tfservingcache_tpu/cache/providers/peer.py``).

It fronts the configured provider (disk / s3 / gcs / azblob). When the
fleet status plane (cluster/status.py) shows another node holding the model
in its host tier or on its device (warmth >= 2), the provider streams that
peer's ``PackedModelEntry`` over ``FetchPackedModel``
(protocol/peer_transfer.py) into the disk cache, and hands the entry
rebuilt from the stream to the runtime through the model's metadata
(``packed_entry``), so the first load promotes it with no read-back of the
artifact. Any trouble on the peer path (a refused stream, a peer gone
mid-stream, a failed integrity check, a timeout) is logged and the wrapped
provider serves the miss: the worst case is the store's cold miss, never a
failed request.

The manager fetches on worker threads, so the provider uses synchronous
gRPC channels, one cached a peer target and closed when the peer leaves
the ring (``prune``). Constructed unbound it passes every call through; the
router arms it with its fleet view (``bind_fleet``).
"""

from __future__ import annotations

import logging
import os
import threading
import time

from tfservingcache_tpu_torch.cache.providers.base import ModelProvider
from tfservingcache_tpu_torch.types import Model, ModelId, NodeInfo
from tfservingcache_tpu_torch.utils.lockcheck import lockchecked
from tfservingcache_tpu_torch.utils.tracing import TRACER

log = logging.getLogger("tpusc_torch.peer_provider")

# the fleet warmth that makes a peer a source: 2 = packed chunks in its host
# RAM, 3 = on its device (which implies the host tier where it is on)
_MIN_WARMTH = 2


@lockchecked
class PeerProvider(ModelProvider):
    """A decorator provider. ``pin_entries`` page-locks the chunks of the
    entries it rebuilds (a runtime on a card copies them straight to the
    device)."""

    _tpusc_guarded = {"_channels": "_lock"}

    def __init__(self, inner: ModelProvider, chunk_bytes: int = 2 << 20,
                 timeout_s: float = 60.0, max_message_bytes: int = 16 << 20,
                 pin_entries: bool = False) -> None:
        self.inner = inner
        self.chunk_bytes = int(chunk_bytes)
        self.timeout_s = float(timeout_s)
        self.max_message_bytes = int(max_message_bytes)
        self.pin_entries = bool(pin_entries)
        self._fleet = None
        self._cluster = None
        self._self_idents: set[str] = set()
        self._lock = threading.Lock()
        self._channels: dict[str, object] = {}  # grpc target -> sync channel

    # -- binding ------------------------------------------------------------
    def bind_fleet(self, fleet, cluster, self_idents) -> None:
        """Arm the peer path: ``fleet`` is the router's ``FleetView``,
        ``cluster`` its ``ClusterConnection`` (the members' ``NodeInfo``),
        ``self_idents`` this node's own ring idents (never a source)."""
        self._fleet = fleet
        self._cluster = cluster
        self._self_idents = set(self_idents)

    def prune(self, nodes) -> None:
        """Membership callback: close the channels of departed peers."""
        live = {f"{n.host}:{n.grpc_port}" for n in nodes}
        with self._lock:
            gone = [self._channels.pop(t) for t in list(self._channels) if t not in live]
        for ch in gone:
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass

    # -- peer path ----------------------------------------------------------
    def _candidates(self, key: str) -> list[tuple[str, NodeInfo]]:
        """The other members whose status shows ``key`` at warmth >= 2,
        warmest first, then healthiest."""
        fleet, cluster = self._fleet, self._cluster
        if fleet is None or cluster is None:
            return []
        scored: list[tuple[int, float, str, NodeInfo]] = []
        for ident, node in dict(cluster._nodes_by_ident).items():
            if ident in self._self_idents:
                continue
            w = fleet.warmth(ident, key)
            if w < _MIN_WARMTH:
                continue
            scored.append((w, fleet.health(ident), ident, node))
        scored.sort(key=lambda t: (-t[0], -t[1]))
        return [(ident, node) for _, _, ident, node in scored]

    def _channel(self, node: NodeInfo):
        from tfservingcache_tpu_torch.protocol.grpc_client import make_channel

        target = f"{node.host}:{node.grpc_port}"
        with self._lock:
            ch = self._channels.get(target)
            if ch is None:
                ch = make_channel(target, self.max_message_bytes)
                self._channels[target] = ch
            return ch

    def _try_peers(self, name: str, version: int, dest_dir: str, on_file) -> Model | None:
        """The peer path; None sends the miss to the wrapped provider."""
        mid = ModelId(name, version)
        candidates = self._candidates(mid.key)
        if not candidates:  # unbound, or no warm peer: grpc is never imported
            return None
        import grpc

        from tfservingcache_tpu_torch.cache.providers.base import atomic_dest
        from tfservingcache_tpu_torch.protocol.peer_transfer import PeerWireError, fetch_from_peer

        fleet = self._fleet
        metrics = getattr(fleet, "metrics", None)
        for ident, node in candidates:
            t0 = time.monotonic()
            got = 0
            entry_box: list = []
            try:
                with TRACER.span("peer_fetch", model=str(mid), peer=ident) as sp:
                    with atomic_dest(dest_dir) as tmp:
                        got = fetch_from_peer(
                            self._channel(node), name, version, tmp, on_file=on_file,
                            timeout_s=self.timeout_s, on_entry=entry_box.append,
                            pin_entry=self.pin_entries)
                    sp.attrs["bytes"] = got
                fleet.note_forward(ident, ok=True, latency_s=time.monotonic() - t0)
                if metrics is not None:
                    metrics.peer_fetch_bytes.labels("ok").inc(got)
                log.info("peer-sourced %s from %s: %d bytes in %.2fs",
                         mid, ident, got, time.monotonic() - t0)
                size = sum(os.path.getsize(os.path.join(r, f))
                           for r, _d, fs in os.walk(dest_dir) for f in fs)
                model = Model(identifier=mid, path=dest_dir, size_on_disk=size)
                model.metadata["fetch_source"] = "peer"
                model.metadata["fetch_peer"] = ident
                if entry_box:
                    # the manager hands it to the runtime, whose first load
                    # promotes it instead of reading the artifact just written
                    model.metadata["packed_entry"] = entry_box[0]
                return model
            except grpc.RpcError as e:
                got = getattr(e, "partial_bytes", got)
                code = e.code() if hasattr(e, "code") else None
                if code == grpc.StatusCode.NOT_FOUND:
                    # a stale advertisement (the peer evicted since): the
                    # connection worked, which proves the peer alive
                    fleet.note_forward(ident, ok=True, latency_s=time.monotonic() - t0)
                    if metrics is not None:
                        metrics.peer_fetch_bytes.labels("not_found").inc(got)
                    log.info("peer %s no longer holds %s; trying the next source", ident, mid)
                    continue
                if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                    # alive but at its outbound cap: healthy, try the next
                    fleet.note_forward(ident, ok=True, latency_s=time.monotonic() - t0)
                    if metrics is not None:
                        metrics.peer_fetch_bytes.labels("error").inc(got)
                    log.info("peer %s at its stream cap for %s; trying the next", ident, mid)
                    continue
                fleet.note_forward(ident, ok=False)
                if metrics is not None:
                    metrics.peer_fetch_bytes.labels("error").inc(got)
                log.warning("peer fetch of %s from %s FAILED mid-stream (%s: %s); "
                            "falling back", mid, ident, code, e)
                continue
            except PeerWireError as e:
                # bytes arrived but failed the checks: the stream is suspect
                got = getattr(e, "partial_bytes", got)
                fleet.note_forward(ident, ok=False)
                if metrics is not None:
                    metrics.peer_fetch_bytes.labels("error").inc(got)
                log.warning("peer fetch of %s from %s failed integrity (%s); falling back",
                            mid, ident, e)
                continue
            except Exception as e:  # noqa: BLE001 - the peer path is never fatal
                got = getattr(e, "partial_bytes", got)
                fleet.note_forward(ident, ok=False)
                if metrics is not None:
                    metrics.peer_fetch_bytes.labels("error").inc(got)
                log.warning("peer fetch of %s from %s hit %s: %s; falling back",
                            mid, ident, type(e).__name__, e)
                continue
        return None

    # -- ModelProvider ------------------------------------------------------
    def load_model(self, name: str, version: int, dest_dir: str) -> Model:
        model = self._try_peers(name, version, dest_dir, on_file=None)
        if model is not None:
            return model
        return self.inner.load_model(name, version, dest_dir)

    def load_model_streaming(self, name: str, version: int, dest_dir: str,
                             on_file=None) -> Model:
        model = self._try_peers(name, version, dest_dir, on_file=on_file)
        if model is not None:
            return model
        return self.inner.load_model_streaming(name, version, dest_dir, on_file=on_file)

    def model_size(self, name: str, version: int) -> int:
        return self.inner.model_size(name, version)

    def check(self) -> None:
        self.inner.check()

    def list_versions(self, name: str) -> list[int]:
        return self.inner.list_versions(name)

    def latest_version(self, name: str) -> int:
        return self.inner.latest_version(name)

    def close(self) -> None:
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass
