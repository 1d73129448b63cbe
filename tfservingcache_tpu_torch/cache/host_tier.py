"""Host-RAM warm tier: a byte-budgeted LRU of packed parameter chunks
(counterpart of ``tfservingcache_tpu/cache/host_tier.py``).

The middle tier of the three-tier residency model (device -> host RAM ->
disk/store). The disk tier keeps the encoded artifact, which a load still
has to read and pack; this tier keeps, per model, exactly what the
host-to-device copy consumes: the chunk buffers of ``_pack_plan``
(runtime/model_runtime.py), each an owned tensor in page-locked memory on a
card. Promotion back onto the device replays those chunks through the copy
path of a cold load, with no disk read and no decode.

Tiers are inclusive downward: a host entry implies the artifact is still on
disk (the cache manager discards the entry when the disk tier evicts the
artifact). The tier sits over the same LRU engine as the other two
(``native.make_lru_cache``): byte budget, MRU touch on ``get``, evict
callbacks outside the internal lock. It feeds ``tpusc_host_tier_bytes``,
its ``_peak`` twin through the flight recorder's watermark,
``tpusc_evictions_total{tier="host"}`` and the tenant ledger's
``host_bytes`` levels.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from tfservingcache_tpu_torch.cache.lru import LRUEntry
from tfservingcache_tpu_torch.native import make_lru_cache
from tfservingcache_tpu_torch.types import ModelId
from tfservingcache_tpu_torch.utils.accounting import LEDGER
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER

log = logging.getLogger("tpusc_torch.host_tier")


@dataclass
class PackedModelEntry:
    """One evicted (or eagerly retained) model's transfer-ready state.

    ``chunks`` are OWNED 1-D host tensors, one per ``_pack_plan`` chunk in
    plan order, each with its flat indices: never a staging buffer the
    chunk assembler reuses and never a view into the artifact's bytes.
    ``owner``/``shapes``/``quant_dtypes``/``treedef`` describe how the flat
    buffers re-slice into the params tree, the bookkeeping of
    ``packed_device_put_pipelined``, so promotion replays the same copies.
    A weight of an int8 artifact is kept as it crossed the link: two flat
    tensors, its int8 ``q`` (role ``q``, in an int8 chunk) and its f32
    ``scale`` (role ``scale``, in an f32 chunk), with its original dtype in
    ``quant_dtypes``; the promotion dequantizes it on the device again, and
    ``nbytes`` counts those int8 and scale bytes.

    The reference's entry carries the family's ``jax.jit`` handle and its
    AOT executables, which have no meaning in torch: a promoted model's
    module is built again from the landed params. What the promotion needs
    for that is carried instead: the ``ModelDef`` and its module factory
    (``make_module``)."""

    model_def: Any
    chunks: list[tuple[list[int], torch.Tensor]]
    owner: list[tuple[int, str]]          # flat idx -> (outer idx, plain | q | scale)
    shapes: list[tuple[int, ...]]         # flat idx -> leaf shape
    quant_dtypes: dict[int, str]          # outer idx of a quantized leaf -> its orig dtype
    treedef: list[str]                    # outer idx -> leaf path
    make_module: Callable[[Any], torch.nn.Module]
    hbm_bytes: int = 0
    nbytes: int = 0
    # outer idx -> artifact leaf path ("/"-joined, registry.flatten_params)
    paths: list[str] = field(default_factory=list)


class HostRamTier:
    """Thread-safe byte-budgeted LRU of ``PackedModelEntry``: ``get``
    touches to MRU, ``put`` evicts LRU-first to fit, callbacks run after
    the internal lock is released. An entry pinned by an outbound stream
    that the LRU evicts stays readable (and counted) until its last
    ``unpin``."""

    def __init__(self, capacity_bytes: int, metrics: Any = None) -> None:
        self.metrics = metrics
        self.lru = make_lru_cache(int(capacity_bytes), self._on_evict)
        self._closed = threading.Event()
        self._pin_lock = threading.Lock()
        self._pins: dict[ModelId, int] = {}  # guarded-by: _pin_lock
        self._pinned_evicted: dict[ModelId, PackedModelEntry] = {}  # guarded-by: _pin_lock

    # -- LRU facade ---------------------------------------------------------
    def get(self, model_id: ModelId, touch: bool = True) -> PackedModelEntry | None:
        return self.lru.get(model_id, touch=touch)

    # -- outbound-stream pinning -------------------------------------------
    def pin(self, model_id: ModelId) -> PackedModelEntry | None:
        """The entry for an outbound stream, without touching LRU order; it
        stays valid until the matching ``unpin`` even if the tier evicts it
        meanwhile. None if absent."""
        with self._pin_lock:
            entry = self.lru.get(model_id, touch=False)
            if entry is None:
                entry = self._pinned_evicted.get(model_id)
            if entry is None:
                return None
            self._pins[model_id] = self._pins.get(model_id, 0) + 1
            return entry

    def unpin(self, model_id: ModelId) -> None:
        with self._pin_lock:
            n = self._pins.get(model_id, 0) - 1
            if n > 0:
                self._pins[model_id] = n
                return
            self._pins.pop(model_id, None)
            self._pinned_evicted.pop(model_id, None)
        self._update_gauge()

    def put(self, model_id: ModelId, entry: PackedModelEntry) -> list[ModelId]:
        if self._closed.is_set():
            return []
        evicted = self.lru.put(model_id, entry.nbytes, entry)
        self._update_gauge()
        return evicted

    def touch(self, model_id: ModelId) -> bool:
        """MRU-promote; True if present."""
        return self.lru.get(model_id) is not None

    def remove(self, model_id: ModelId) -> None:
        self.lru.remove(model_id, run_callback=False)
        self._update_gauge()

    def __contains__(self, model_id: ModelId) -> bool:
        return model_id in self.lru

    def __len__(self) -> int:
        return len(self.lru)

    def keys_mru_first(self) -> list[ModelId]:
        return self.lru.keys_mru_first()

    def size_of(self, model_id: ModelId) -> int | None:
        entry = self.lru.get(model_id, touch=False)
        return None if entry is None else entry.nbytes

    @property
    def total_bytes(self) -> int:
        return self.lru.total_bytes

    @property
    def capacity_bytes(self) -> int:
        return self.lru.capacity_bytes

    # -- internals ----------------------------------------------------------
    def _on_evict(self, model_id: ModelId, entry: LRUEntry[PackedModelEntry]) -> None:
        # dropping the references frees the chunks, unless an outbound
        # stream holds a pin: then the entry parks until the last unpin
        with self._pin_lock:
            if self._pins.get(model_id, 0) > 0 and entry.payload is not None:
                self._pinned_evicted[model_id] = entry.payload
        if self.metrics is not None:
            self.metrics.evictions.labels("host").inc()
        self._update_gauge()
        log.info("host tier evicted %s (%d packed bytes)", model_id, entry.size_bytes)

    def _update_gauge(self) -> None:
        with self._pin_lock:
            parked = {str(mid): float(e.nbytes) for mid, e in self._pinned_evicted.items()}
        levels = {str(mid): float(e.size_bytes) for mid, e in self.lru.items_lru_first()}
        for mid, nbytes in parked.items():
            levels[mid] = levels.get(mid, 0.0) + nbytes
        LEDGER.gauge_sync("host_bytes", levels, owner=f"host:{id(self)}")
        total = self.lru.total_bytes + sum(parked.values())
        peak = RECORDER.observe_watermark("host_tier_bytes", float(total))
        if self.metrics is not None:
            self.metrics.host_tier_bytes.set(total)
            self.metrics.host_tier_bytes_peak.set(peak)

    def clear(self) -> None:
        self.lru.clear()
        self._update_gauge()

    def close(self) -> None:
        self._closed.set()
        self.lru.clear()
        self._update_gauge()
