"""Conversation KV tier: park, spill and resume decode state (counterpart of
``tfservingcache_tpu/cache/conversation_kv.py``).

When a ``:generate`` row carrying a ``conversation_id`` retires, the lane's
live arena pages (raw: int8 values plus their f32 scales on an int8 arena,
so half the bytes of bf16 pages) and its token history are copied into this
byte-budgeted tier instead of being dropped. The conversation's next turn
re-imports the pages into fresh arena pages and prefills only the suffix.

Two levels, each a byte-budgeted LRU (``native.make_lru_cache``): host
memory holds ``ParkedConversation`` payloads, and its evict callback IS the
spill: the coldest conversation is packed into a flat blob (``pack_parked``)
and written to a file under ``disk_dir``, held by a second LRU whose evict
callback deletes the file. A disk hit is read back and promoted to host.
The tier deletes only what it wrote: its files carry a tag of their own,
and ``close`` removes ``disk_dir`` itself only when the tier made it and
nothing else is left in it.
``get`` peeks: an entry stays until the next park of the same conversation
replaces it, so a scheduler that crashes mid-turn can resume the turn again
from the same ancestor.

The blob format is the reference's, byte for byte: the magic ``TPKV1\\n``, a
little-endian u32 header length, a JSON header (model id, page_tokens, each
array's name, dtype and shape), then the raw array bytes in header order.
A blob packed by either package unpacks in the other. numpy has no bfloat16
without ``ml_dtypes``, which the port does not use, so bf16 pages are held
here as their ``uint16`` bit pattern with ``page_dtype == "bfloat16"``; the
header still names them ``"bfloat16"``.

The tier feeds ``tpusc_kv_parked_bytes{host,disk}``,
``tpusc_kv_parked_conversations``, ``tpusc_kv_resume{hit,spilled,miss}`` and
``tpusc_evictions_total{conversation_kv_host,conversation_kv_disk}``, and
hands its stats row to the flight recorder on every change. ``adopt`` lands
a conversation fetched from another node (``protocol/peer_transfer.py``
``fetch_parked_from_peer``) and counts it in ``migrations_in``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tfservingcache_tpu_torch.cache.lru import CapacityError, LRUEntry
from tfservingcache_tpu_torch.native import make_lru_cache
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER

log = logging.getLogger("tpusc_torch.conversation_kv")

# blob format tag (disk spill files; the reference's peer wire shares it)
KV_BLOB_MAGIC = b"TPKV1\n"
_HDR_LEN = struct.Struct("<I")

_PAGE_ARRAYS = ("pages_k", "pages_v")


@dataclass
class ParkedConversation:
    """One parked conversation's resumable decode state.

    ``pages_k``/``pages_v`` are owned host copies of the lane's live arena
    pages in block-table order, shape ``(layers, n_pages, n_kv, page_tokens,
    hd)``, in the arena dtype ``page_dtype`` (bf16 as its ``uint16`` bit
    pattern); on an int8 arena ``k_scale``/``v_scale`` carry the per-row f32
    scales ``(layers, n_pages, n_kv, page_tokens)``. ``history`` is the exact
    token prefix those pages hold. The bytes round-trip bit-exact: a park
    copies raw arena rows and a resume writes them back verbatim.
    """

    model_id: str
    history: np.ndarray                 # (tokens,) int32
    pages_k: np.ndarray
    pages_v: np.ndarray
    k_scale: np.ndarray | None
    v_scale: np.ndarray | None
    page_tokens: int
    page_dtype: str = ""                # "" = pages_k.dtype.name
    nbytes: int = 0

    def __post_init__(self) -> None:
        if not self.page_dtype:
            self.page_dtype = self.pages_k.dtype.name
        if not self.nbytes:
            self.nbytes = sum(
                a.nbytes
                for a in (self.history, self.pages_k, self.pages_v, self.k_scale, self.v_scale)
                if a is not None
            )


def host_pages(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A device tensor of arena rows -> (an owned host numpy copy, the
    arena dtype's name). bf16 comes back as its ``uint16`` bit pattern."""
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), name
    return t.cpu().numpy(), name


def device_pages(a: np.ndarray, dtype_name: str, device: torch.device) -> torch.Tensor:
    """The inverse of ``host_pages``: host rows in arena dtype ``dtype_name``
    -> a tensor on ``device``, bit for bit."""
    a = np.ascontiguousarray(a)
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _raw_bytes(a: np.ndarray) -> memoryview:
    # a uint8 view, not tobytes(): no copy of the page payload
    return memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def pack_parked(parked: ParkedConversation) -> bytes:
    """Serialize to the flat self-describing blob (the disk spill format).

    Layout: magic, u32 header length, JSON header (model id, page_tokens,
    per-array dtype and shape), then the raw array bytes in header order.
    The pages are named by ``page_dtype``, so bf16 pages held as ``uint16``
    are written as ``"bfloat16"``, as the reference writes them."""
    arrays: list[tuple[str, np.ndarray]] = [
        ("history", parked.history),
        ("pages_k", parked.pages_k),
        ("pages_v", parked.pages_v),
    ]
    if parked.k_scale is not None:
        arrays.append(("k_scale", parked.k_scale))
    if parked.v_scale is not None:
        arrays.append(("v_scale", parked.v_scale))
    header = {
        "model": str(parked.model_id),
        "page_tokens": int(parked.page_tokens),
        "arrays": [
            {"name": n, "dtype": parked.page_dtype if n in _PAGE_ARRAYS else a.dtype.name,
             "shape": list(a.shape)}
            for n, a in arrays
        ],
    }
    hb = json.dumps(header).encode()
    parts: list[Any] = [KV_BLOB_MAGIC, _HDR_LEN.pack(len(hb)), hb]
    parts.extend(_raw_bytes(a) for _, a in arrays)
    return b"".join(parts)


def unpack_parked(blob: bytes | memoryview) -> ParkedConversation:
    """The inverse of ``pack_parked`` (either package's blob). Raises
    ValueError on a wrong magic, a short payload or trailing bytes."""
    mv = memoryview(blob)
    n_magic = len(KV_BLOB_MAGIC)
    if bytes(mv[:n_magic]) != KV_BLOB_MAGIC:
        raise ValueError("bad parked-KV blob: wrong magic")
    try:
        (hlen,) = _HDR_LEN.unpack_from(mv, n_magic)
        off = n_magic + _HDR_LEN.size
        header = json.loads(bytes(mv[off:off + hlen]).decode())
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"bad parked-KV blob: header: {e}") from e
    off += hlen
    out: dict[str, np.ndarray] = {}
    page_dtype = ""
    for ent in header["arrays"]:
        name = ent["dtype"]
        if ent["name"] in _PAGE_ARRAYS:
            page_dtype = name
        dt = np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)
        shape = tuple(int(s) for s in ent["shape"])
        nb = int(np.prod(shape)) * dt.itemsize if shape else dt.itemsize
        if off + nb > len(mv):
            raise ValueError(f"bad parked-KV blob: {ent['name']} truncated")
        a = np.frombuffer(mv, np.uint8, nb, off).view(dt).reshape(shape)
        out[ent["name"]] = a.copy()  # own the buffer, don't pin the blob
        off += nb
    if off != len(mv):
        raise ValueError(f"bad parked-KV blob: {len(mv) - off} trailing bytes")
    return ParkedConversation(
        model_id=header["model"],
        history=out["history"],
        pages_k=out["pages_k"],
        pages_v=out["pages_v"],
        k_scale=out.get("k_scale"),
        v_scale=out.get("v_scale"),
        page_tokens=int(header["page_tokens"]),
        page_dtype=page_dtype,
    )


ConvKey = tuple[str, str]  # (model_id, conversation_id)


class ConversationKVTier:
    """Two-level byte-budgeted LRU of ``ParkedConversation`` (reference
    :165). Level 1 (host memory) holds payloads; its evict callback spills
    the blob to level 2 (files under ``disk_dir``) when a disk budget is
    set, else the conversation is dropped. A zero host budget disables the
    tier: every ``put`` is a no-op and every ``get`` a miss."""

    def __init__(
        self,
        capacity_bytes: int,
        disk_capacity_bytes: int = 0,
        disk_dir: str | None = None,
        metrics: Any = None,
    ) -> None:
        self.metrics = metrics
        self.capacity_bytes = max(0, int(capacity_bytes))
        self.disk_capacity_bytes = max(0, int(disk_capacity_bytes))
        self.disk_dir = disk_dir
        self.enabled = self.capacity_bytes > 0
        # host level: payload = ParkedConversation
        self.host = make_lru_cache(max(1, self.capacity_bytes), self._on_evict_host)
        # disk level: payload = blob path; the evict callback deletes the file
        self._spill = self.enabled and self.disk_capacity_bytes > 0 and disk_dir is not None
        self.disk = make_lru_cache(max(1, self.disk_capacity_bytes), self._on_evict_disk)
        self._closed = threading.Event()
        self._stats_lock = threading.Lock()
        self._hits = 0           # guarded-by: _stats_lock
        self._spilled_hits = 0   # guarded-by: _stats_lock
        self._misses = 0         # guarded-by: _stats_lock
        self._parked_total = 0   # guarded-by: _stats_lock
        self._spills = 0         # guarded-by: _stats_lock
        self._spilled_bytes = 0  # guarded-by: _stats_lock
        self._migrations_in = 0  # guarded-by: _stats_lock
        # the prefix of this tier's spill files, so that two tiers can share
        # a directory and close() deletes nothing it did not write
        self._tag = f"{os.getpid()}-{os.urandom(4).hex()}"
        self._made_dir = False
        if self._spill:
            self._made_dir = not os.path.isdir(disk_dir)
            os.makedirs(disk_dir, exist_ok=True)
        self._update_gauges()

    # -- core ---------------------------------------------------------------
    def put(self, conversation_id: str, parked: ParkedConversation) -> None:
        """Park (or re-park, replacing the previous turn's entry)."""
        if not self.enabled or self._closed.is_set():
            return
        key = (str(parked.model_id), str(conversation_id))
        if parked.nbytes > self.capacity_bytes:
            log.warning("conversation %s (%d KV bytes) exceeds parked-KV budget %d; dropped",
                        conversation_id, parked.nbytes, self.capacity_bytes)
            return
        # the previous turn's entry goes without a spill (the LRU's replace
        # would run the evict callback and write a blob only to delete it)
        self.host.remove(key, run_callback=False)
        self.host.put(key, parked.nbytes, parked)
        # a re-park supersedes any spilled copy of the same conversation
        self.disk.remove(key, run_callback=True)
        with self._stats_lock:
            self._parked_total += 1
        self._update_gauges()

    def get(self, conversation_id: str, model_id: str,
            touch: bool = True) -> tuple[ParkedConversation | None, str]:
        """Look up parked state -> ``(parked, outcome)``, outcome ``hit``
        (host), ``spilled`` (read back from disk and promoted) or ``miss``.
        Peeks: the entry stays parked."""
        if not self.enabled:
            return None, "miss"
        key = (str(model_id), str(conversation_id))
        parked = self.host.get(key, touch=touch)
        if parked is not None:
            self._count("hit")
            return parked, "hit"
        path = self.disk.get(key, touch=touch)
        if path is not None:
            try:
                with open(path, "rb") as f:
                    parked = unpack_parked(f.read())
            except (OSError, ValueError) as e:
                log.warning("parked-KV read-back failed for %s: %s", key, e)
                self.disk.remove(key, run_callback=True)
                self._count("miss")
                self._update_gauges()
                return None, "miss"
            # promote host-ward (may itself spill a colder conversation);
            # drop the disk copy so bytes are never counted twice
            self.disk.remove(key, run_callback=True)
            try:
                self.host.put(key, parked.nbytes, parked)
            except CapacityError:
                pass  # serve it anyway; too big to re-park
            self._count("spilled")
            self._update_gauges()
            return parked, "spilled"
        self._count("miss")
        return None, "miss"

    def adopt(self, conversation_id: str, parked: ParkedConversation) -> None:
        """Land a conversation migrated from a peer."""
        self.put(conversation_id, parked)
        with self._stats_lock:
            self._migrations_in += 1

    def drop(self, conversation_id: str, model_id: str) -> None:
        key = (str(model_id), str(conversation_id))
        self.host.remove(key, run_callback=False)
        self.disk.remove(key, run_callback=True)
        self._update_gauges()

    def drop_model(self, model_id: str) -> None:
        """Forget every conversation parked for a model (unload path)."""
        mid = str(model_id)
        for key in [k for k in self.host.keys_mru_first() if k[0] == mid]:
            self.host.remove(key, run_callback=False)
        for key in [k for k in self.disk.keys_mru_first() if k[0] == mid]:
            self.disk.remove(key, run_callback=True)
        self._update_gauges()

    # -- eviction / spill ---------------------------------------------------
    def _on_evict_host(self, key: ConvKey, entry: LRUEntry[ParkedConversation]) -> None:
        """A host entry pushed out by a newer park: spilled to disk when the
        tier has a disk level, else dropped. Counted as a host eviction
        either way (reference :298-325)."""
        if self.metrics is not None:
            self.metrics.evictions.labels("conversation_kv_host").inc()
        if not self._spill or self._closed.is_set():
            self._update_gauges()
            return
        blob = pack_parked(entry.payload)
        name = hashlib.sha256(f"{key[0]}\x00{key[1]}".encode()).hexdigest()[:24]
        path = os.path.join(self.disk_dir, f"{self._tag}-{name}.kv")
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
            self.disk.put(key, len(blob), path)
        except (OSError, CapacityError) as e:
            log.warning("parked-KV spill failed for %s: %s", key, e)
            for leftover in (tmp, path):
                try:
                    os.unlink(leftover)
                except OSError:
                    pass
            self._update_gauges()
            return
        with self._stats_lock:
            self._spills += 1
            self._spilled_bytes += len(blob)
        self._update_gauges()
        log.info("parked conversation %s spilled host->disk (%d bytes)", key[1], len(blob))

    def _on_evict_disk(self, key: ConvKey, entry: LRUEntry[str]) -> None:
        try:
            os.unlink(entry.payload)
        except OSError:
            pass
        if self.metrics is not None:
            self.metrics.evictions.labels("conversation_kv_disk").inc()
        self._update_gauges()

    def _count(self, outcome: str) -> None:
        with self._stats_lock:
            if outcome == "hit":
                self._hits += 1
            elif outcome == "spilled":
                self._spilled_hits += 1
            else:
                self._misses += 1
        if self.metrics is not None:
            self.metrics.kv_resume.labels(outcome).inc()

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """The reference's stats, plus ``spilled_bytes`` (blob bytes
        written to disk over the tier's life)."""
        with self._stats_lock:
            hits, spilled, misses = self._hits, self._spilled_hits, self._misses
            parked, spills = self._parked_total, self._spills
            spilled_bytes, migrations = self._spilled_bytes, self._migrations_in
        lookups = hits + spilled + misses
        return {
            "enabled": self.enabled,
            "host_conversations": len(self.host),
            "disk_conversations": len(self.disk),
            "host_bytes": self.host.total_bytes,
            "disk_bytes": self.disk.total_bytes,
            "hits": hits,
            "spilled_hits": spilled,
            "misses": misses,
            "hit_rate": round((hits + spilled) / lookups, 4) if lookups else 0.0,
            "parked_total": parked,
            "spills": spills,
            "migrations_in": migrations,
            "spilled_bytes": spilled_bytes,
        }

    def parked_page_count(self, model_id: str | None = None) -> int:
        """Pages parked in the host level (disk entries are opaque blobs):
        the census's parked-page extension."""
        total = 0
        for key, entry in self.host.items_lru_first():
            if model_id is not None and key[0] != str(model_id):
                continue
            total += int(entry.payload.pages_k.shape[1])
        return total

    @property
    def total_bytes(self) -> int:
        return self.host.total_bytes + self.disk.total_bytes

    def __len__(self) -> int:
        return len(self.host) + len(self.disk)

    def _update_gauges(self) -> None:
        """``tpusc_kv_parked_bytes{host,disk}`` and
        ``tpusc_kv_parked_conversations``, and the stats row the flight
        recorder's snapshot carries."""
        if self.metrics is not None:
            self.metrics.kv_parked_bytes.labels("host").set(self.host.total_bytes)
            self.metrics.kv_parked_bytes.labels("disk").set(self.disk.total_bytes)
            self.metrics.kv_parked_conversations.set(len(self.host) + len(self.disk))
        RECORDER.note_conversation_kv(self.stats())

    def clear(self) -> None:
        self.host.clear()
        self.disk.clear()
        self._update_gauges()

    def close(self) -> None:
        """Drop every parked conversation and delete the tier's own spill
        files. ``disk_dir`` goes too only when the tier made it and it is
        left empty: a directory that held anything else stays as it was."""
        self._closed.set()
        # plain clear, not spill: the process is going away
        spilled, self._spill = self._spill, False
        self.host.clear()
        self.disk.clear()  # the disk level's evict callback deletes each file
        if spilled and self._made_dir:
            try:
                os.rmdir(self.disk_dir)
            except OSError:
                pass  # something else lives there now
        self._update_gauges()
