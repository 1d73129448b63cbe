"""Peer-transfer wire (counterpart of
``tfservingcache_tpu/protocol/peer_transfer.py``): two server-streaming
methods of ``tpusc.internal.PeerTransfer`` with raw-bytes serializers (no
generated stubs), one tag byte a frame. The bytes are the reference's, so a
reference node and a port node feed each other.

``FetchPackedModel`` streams a warm node's host-tier ``PackedModelEntry``
(cache/host_tier.py) to a cold peer, which lands a complete ``tpusc.v2``
artifact on its disk and, from a RAM image of the same bytes, the entry its
runtime promotes with no read-back of the artifact:

    request  = JSON {"name": ..., "version": ...}
    frame M  = b"M" + JSON wire meta: the whole synthesized model.json
               (fresh 16-byte-aligned params.bin offsets in pack order),
               each pack chunk's byte count and hash, and each chunk's
               segment map (chunk offset, file offset, bytes)
    frame C  = b"C" + <u32 chunk index> <u64 offset in the chunk> + payload
               (at most ``cluster.peer_fetch_chunk_bytes``, in order per
               chunk)
    frame E  = b"E" + JSON {"chunks": n, "wire_bytes": total}

A chunk's hash is sha256 over its raw bytes cut to 32 hex digits; the
sender keeps the digests on the entry (``wire_hashes``), so a model served
to N peers is hashed once. Dtypes on the wire carry numpy's names
(``registry.dtype_name``). An int8 entry's quantized leaves travel as their
int8 and f32 scale chunks, and the manifest carries each one's ``quant``
sub-entry (``save_artifact``'s); the receiver rebuilds them raw, so the
adopted entry promotes with the dequant on the device.

``FetchParkedConversation`` streams one parked conversation (the KV half):

    request  = JSON {"conversation": ..., "model": "name@version"}
    frame M  = b"M" + JSON {"conversation", "model", "nbytes", "hash"}
    frame C  = b"C" + <u32 chunk index = 0> <u64 offset> + payload
    frame E  = b"E" + JSON {"wire_bytes": n}

Its payload is one ``pack_parked`` blob (cache/conversation_kv.py) carved
into C frames in order; ``hash`` is the blob's sha256 cut to 128 bits.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import queue
import struct
import threading
from typing import Any, Iterator

import numpy as np
import torch

from tfservingcache_tpu_torch.lab import faults as lab_faults
from tfservingcache_tpu_torch.models.registry import (
    _ALIGN,
    ARTIFACT_FORMAT,
    MODEL_JSON,
    PARAMS_BIN,
    dtype_name,
)
from tfservingcache_tpu_torch.utils.accounting import LEDGER
from tfservingcache_tpu_torch.utils.lockcheck import lockchecked
from tfservingcache_tpu_torch.utils.tracing import TRACER

log = logging.getLogger("tpusc_torch.peer_transfer")

PEER_TRANSFER_SERVICE = "tpusc.internal.PeerTransfer"
PEER_FETCH_METHOD = "FetchPackedModel"
PEER_FETCH_PATH = f"/{PEER_TRANSFER_SERVICE}/{PEER_FETCH_METHOD}"
PEER_KV_METHOD = "FetchParkedConversation"
PEER_KV_PATH = f"/{PEER_TRANSFER_SERVICE}/{PEER_KV_METHOD}"

FRAME_META = 0x4D    # "M"
FRAME_CHUNK = 0x43   # "C"
FRAME_END = 0x45     # "E"
_CHUNK_HDR = struct.Struct("<IQ")


class PeerWireError(Exception):
    """A malformed or integrity-failing peer stream (the receiver always
    falls back to the store; never fatal to a request)."""


# -- packed models: FetchPackedModel ------------------------------------------

def encode_request(name: str, version: int) -> bytes:
    return json.dumps({"name": name, "version": int(version)}).encode()


def decode_request(data: bytes) -> tuple[str, int]:
    try:
        req = json.loads(data.decode())
        return str(req["name"]), int(req["version"])
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise PeerWireError(f"bad FetchPackedModel request: {e}") from e


def _raw_bytes(buf: torch.Tensor) -> np.ndarray:
    """A chunk buffer's bytes as a flat uint8 numpy view, with no copy
    (bf16 has no numpy dtype, so never through ``numpy()`` of the tensor
    itself or ``tobytes``)."""
    return buf.reshape(-1).view(torch.uint8).numpy()


def _chunk_hash(buf: torch.Tensor) -> str:
    """sha256 over the chunk's raw bytes, cut to 128 bits."""
    return hashlib.sha256(memoryview(_raw_bytes(buf))).hexdigest()[:32]


def build_wire_meta(entry: Any, model_id: Any = None) -> dict[str, Any]:
    """The M frame's payload from a ``PackedModelEntry``: fresh
    16-byte-aligned ``params.bin`` offsets in pack order (they need only be
    consistent with themselves) and the ``save_artifact`` manifest rebuilt
    from the entry's owner, shapes and paths."""
    md = entry.model_def
    n_outer = len(entry.paths)
    if n_outer == 0 or any(oi >= n_outer for oi, _ in entry.owner):
        raise PeerWireError("entry has no leaf-path map; cannot serve")
    # the chunks are immutable while the entry is pinned: their digests are
    # the entry's constant, computed by the first stream
    cached = getattr(entry, "wire_hashes", None)
    use_cache = isinstance(cached, list) and len(cached) == len(entry.chunks)
    fresh_hashes: list[str] = []
    flat_file: dict[int, tuple[int, int, str]] = {}  # flat idx -> (offset, bytes, dtype)
    segments: list[list[tuple[int, int, int]]] = []  # per chunk: (chunk off, file off, bytes)
    chunk_meta: list[dict[str, Any]] = []
    offset = 0
    for ci, (plan, buf) in enumerate(entry.chunks):
        name, itemsize = dtype_name(buf.dtype), buf.element_size()
        nbytes = _raw_bytes(buf).size
        segs: list[tuple[int, int, int]] = []
        chunk_off = 0
        for i in plan:
            shape = entry.shapes[i]
            nb = (math.prod(shape) if shape else 1) * itemsize
            offset += (-offset) % _ALIGN
            flat_file[i] = (offset, nb, name)
            segs.append((chunk_off, offset, nb))
            offset += nb
            chunk_off += nb
        if chunk_off != nbytes:
            raise PeerWireError(f"entry chunk byte mismatch: plan says {chunk_off}, "
                                f"buffer holds {nbytes}")
        segments.append(segs)
        h = cached[ci] if use_cache else _chunk_hash(buf)
        fresh_hashes.append(h)
        chunk_meta.append({"nbytes": nbytes, "hash": h})
    if not use_cache:
        # one whole-list store: concurrent first streams each build a
        # complete list, and the last store wins intact
        try:
            entry.wire_hashes = fresh_hashes
        except Exception:  # noqa: BLE001 - an entry without settable attrs recomputes
            pass
    roles: dict[int, dict[str, int]] = {}  # outer idx -> role -> flat idx
    for i, (oi, role) in enumerate(entry.owner):
        roles.setdefault(oi, {})[role] = i
    manifest: list[dict[str, Any]] = []
    for oi in sorted(roles, key=lambda o: min(roles[o].values())):
        got = roles[oi]
        path = entry.paths[oi]
        if "plain" in got:
            i = got["plain"]
            off, nb, dtname = flat_file[i]
            manifest.append({"path": path, "dtype": dtname, "shape": list(entry.shapes[i]),
                             "offset": off, "nbytes": nb})
        else:
            qi, si = got["q"], got["scale"]
            qoff, qnb, _ = flat_file[qi]
            soff, snb, sdt = flat_file[si]
            manifest.append({
                "path": path, "dtype": "int8", "shape": list(entry.shapes[qi]),
                "offset": qoff, "nbytes": qnb,
                "quant": {"orig_dtype": entry.quant_dtypes[oi], "scale_dtype": sdt,
                          "scale_shape": list(entry.shapes[si]), "scale_offset": soff,
                          "scale_nbytes": snb},
            })
    model_json = {
        "format": ARTIFACT_FORMAT,
        "family": md.family,
        "config": md.config,
        "param_dtype": md.store_param_dtype,
        "quantize": "int8" if entry.quant_dtypes else None,
        "params": {"file": PARAMS_BIN, "manifest": manifest},
        "signature": {
            "inputs": {k: [v.dtype, list(v.shape)] for k, v in md.input_spec.items()},
            "outputs": {k: [v.dtype, list(v.shape)] for k, v in md.output_spec.items()},
            "method_name": md.method_name,
        },
    }
    return {
        "model": str(model_id) if model_id is not None else "",
        "model_json": model_json,
        "segments": segments,
        "chunks": chunk_meta,
        "file_bytes": offset,
        "wire_bytes": sum(c["nbytes"] for c in chunk_meta),
    }


def iter_frames(entry: Any, chunk_msg_bytes: int, model_id: Any = None) -> Iterator[bytes]:
    """Sender: the M frame, the pack chunks carved into C frames of at most
    ``chunk_msg_bytes`` (at least 64 KiB), the E frame. Consistent while
    the caller holds a host-tier pin on the entry."""
    meta = build_wire_meta(entry, model_id)
    yield bytes([FRAME_META]) + json.dumps(meta).encode()
    step = max(int(chunk_msg_bytes), 64 << 10)
    for ci, (_plan, buf) in enumerate(entry.chunks):
        mv = memoryview(_raw_bytes(buf))
        for off in range(0, len(mv), step):
            # one copy into the outgoing frame
            head = bytes([FRAME_CHUNK]) + _CHUNK_HDR.pack(ci, off)
            yield b"".join((head, mv[off:off + step]))
    # the stream completed: the bytes were served on the tenant's behalf
    if model_id is not None:
        LEDGER.note_peer_served(str(model_id), meta["wire_bytes"])
    yield bytes([FRAME_END]) + json.dumps(
        {"chunks": len(entry.chunks), "wire_bytes": meta["wire_bytes"]}).encode()


def _check_ranges(manifest: Any, file_bytes: int) -> None:
    """Every leaf's bytes, and a quantized leaf's scales, lie inside the
    ``file_bytes`` the meta frame announces: a manifest that points outside
    the file is refused before any byte lands."""
    try:
        for ent in manifest:
            spans = [("bytes", int(ent["offset"]), int(ent["nbytes"]))]
            quant = ent.get("quant")
            if quant is not None:
                spans.append(("quant scales", int(quant["scale_offset"]),
                               int(quant["scale_nbytes"])))
            for what, off, nb in spans:
                if off < 0 or nb < 0 or off + nb > file_bytes:
                    raise PeerWireError(f"{what} of {ent.get('path')!r} lie outside the "
                                        f"{file_bytes}-byte params file")
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise PeerWireError(f"bad meta frame: {e}") from e


class PeerStreamReceiver:
    """Receiver: assembles frames into a complete v2 artifact at
    ``dest_dir`` (the caller stages it with ``atomic_dest``), checking each
    chunk's length, order and hash as its bytes land. ``feed`` returns
    "meta" once model.json is written, "chunk" for a data frame, "end"
    after a clean end. ``params.bin`` is written behind the stream by a
    thread of its own; the end frame joins it. With ``assemble`` the
    payload is also scattered into a RAM image of ``params.bin``
    (``self.image``), from which ``build_entry`` rebuilds the packed entry
    with no read of the landed file."""

    def __init__(self, dest_dir: str, assemble: bool = False) -> None:
        self.dest_dir = dest_dir
        self.meta: dict[str, Any] | None = None
        self.meta_path = os.path.join(dest_dir, MODEL_JSON)
        self.bytes_received = 0
        self.assemble = assemble
        self.image: np.ndarray | None = None
        self._fh = None
        self._segments: list[list[tuple[int, int, int]]] = []
        self._expect: list[int] = []        # per chunk: the next expected offset
        self._seg_ptr: list[int] = []       # per chunk: the current segment
        self._hashers: list[Any] = []
        self._done: list[bool] = []
        # write-behind: the bounded queue caps the buffered bytes at ~32 frames
        self._wq: queue.Queue | None = None
        self._writer: threading.Thread | None = None
        self._werr: list[Exception] = []

    def feed(self, frame: bytes) -> str:
        if not frame:
            raise PeerWireError("empty frame")
        kind = frame[0]
        if kind == FRAME_META:
            return self._on_meta(frame[1:])
        if kind == FRAME_CHUNK:
            # the scenario lab's corrupt_peer_chunk flips a payload byte
            # (lab/faults.py): the headers stay intact, so this receiver's
            # own hash catches it as it would wire bitrot
            frame = lab_faults.fire("peer_chunk", payload=frame)
            return self._on_chunk(frame[1:])
        if kind == FRAME_END:
            return self._on_end(frame[1:])
        raise PeerWireError(f"unknown frame tag 0x{kind:02x}")

    def _on_meta(self, body: bytes) -> str:
        if self.meta is not None:
            raise PeerWireError("duplicate meta frame")
        try:
            self.meta = json.loads(body.decode())
            model_json = self.meta["model_json"]
            chunks = self.meta["chunks"]
            manifest = model_json["params"]["manifest"]
            self._segments = [[(int(a), int(b), int(c)) for a, b, c in segs]
                              for segs in self.meta["segments"]]
            file_bytes = int(self.meta["file_bytes"])
        except (ValueError, KeyError, TypeError) as e:
            raise PeerWireError(f"bad meta frame: {e}") from e
        if len(self._segments) != len(chunks):
            raise PeerWireError("meta segment/chunk count mismatch")
        _check_ranges(manifest, file_bytes)
        os.makedirs(self.dest_dir, exist_ok=True)
        # model.json first: inside the staging dir the atomic rename makes
        # the artifact whole
        with open(self.meta_path, "w") as f:
            json.dump(model_json, f, indent=1)
        self._fh = open(os.path.join(self.dest_dir, PARAMS_BIN), "wb")
        self._fh.truncate(file_bytes)
        if self.assemble:
            # zeros: the alignment gaps stay deterministic
            self.image = np.zeros(file_bytes, np.uint8)
        self._wq = queue.Queue(maxsize=32)
        self._writer = threading.Thread(target=self._write_loop, name="tpusc-peer-rx-write",
                                        daemon=True)
        self._writer.start()
        n = len(chunks)
        self._expect = [0] * n
        self._seg_ptr = [0] * n
        self._hashers = [hashlib.sha256() for _ in range(n)]
        self._done = [False] * n
        return "meta"

    def _on_chunk(self, body: bytes) -> str:
        if self.meta is None or self._fh is None:
            raise PeerWireError("chunk frame before meta")
        if len(body) < _CHUNK_HDR.size:
            raise PeerWireError("truncated chunk frame")
        ci, off = _CHUNK_HDR.unpack_from(body)
        payload = memoryview(body)[_CHUNK_HDR.size:]
        if ci >= len(self._expect):
            raise PeerWireError(f"chunk index {ci} out of range")
        if off != self._expect[ci]:
            raise PeerWireError(f"out-of-order chunk {ci}: offset {off}, "
                                f"expected {self._expect[ci]}")
        declared = int(self.meta["chunks"][ci]["nbytes"])
        if off + len(payload) > declared:
            raise PeerWireError(f"chunk {ci} overruns declared length {declared}")
        self._hashers[ci].update(payload)
        # scatter the payload over the chunk's file segments
        segs = self._segments[ci]
        p = self._seg_ptr[ci]
        cur, end = off, off + len(payload)
        while cur < end:
            while p < len(segs) and segs[p][0] + segs[p][2] <= cur:
                p += 1
            if p >= len(segs):
                raise PeerWireError(f"chunk {ci} bytes beyond segment map")
            seg_off, file_off, nb = segs[p]
            take = min(end, seg_off + nb) - cur
            dst = file_off + (cur - seg_off)
            self._wq.put((dst, payload[cur - off:cur - off + take]))
            if self.image is not None:
                self.image[dst:dst + take] = np.frombuffer(payload, np.uint8, take, cur - off)
            cur += take
        if self._werr:
            raise PeerWireError(f"artifact write failed: {self._werr[0]}")
        self._seg_ptr[ci] = p
        self._expect[ci] = end
        self.bytes_received += len(payload)
        if end == declared:
            if self._hashers[ci].hexdigest()[:32] != self.meta["chunks"][ci]["hash"]:
                raise PeerWireError(f"chunk {ci} hash mismatch")
            self._done[ci] = True
        return "chunk"

    def _write_loop(self) -> None:
        while True:
            item = self._wq.get()
            if item is None:
                return
            if self._werr:
                continue  # poisoned: drain, so that feed's put never blocks for good
            dst, data = item
            try:
                self._fh.seek(dst)
                self._fh.write(data)
            except Exception as e:  # noqa: BLE001 - raised by the next feed or the end
                self._werr.append(e)

    def _join_writer(self) -> None:
        if self._writer is not None:
            self._wq.put(None)
            self._writer.join()
            self._writer = None
            self._wq = None

    def _on_end(self, body: bytes) -> str:
        if self.meta is None:
            raise PeerWireError("end frame before meta")
        if not all(self._done):
            missing = [i for i, d in enumerate(self._done) if not d]
            raise PeerWireError(f"stream ended with incomplete chunks {missing}")
        self._join_writer()
        if self._werr:
            raise PeerWireError(f"artifact write failed: {self._werr[0]}")
        # no fsync, as no provider fsyncs: the atomic rename makes the
        # artifact whole, and a lost write after a crash is a cold miss
        self._fh.flush()
        self._fh.close()
        self._fh = None
        return "end"

    def build_entry(self, pin: bool = False) -> Any:
        """The ``PackedModelEntry`` a disk load of the landed artifact would
        retain, from the RAM image (valid after a clean end with
        ``assemble``): the chunks are owned copies (page-locked with
        ``pin``), never views into the image, and the entry's
        ``make_module`` is the family's, which the runtime's promotion
        builds the module with."""
        if self.image is None or self._fh is not None or self.meta is None:
            raise PeerWireError("build_entry before a clean assembled stream")
        from tfservingcache_tpu_torch.models.registry import build, params_from_manifest
        from tfservingcache_tpu_torch.runtime.model_runtime import build_packed_entry

        model_json = self.meta["model_json"]
        md = build(model_json["family"], model_json.get("config"))
        # raw: quantized leaves stay int8 + scales (reference :429)
        params = params_from_manifest(model_json, self.image, src="peer stream",
                                      raw_quant=True)
        return build_packed_entry(md, params, hbm_bytes=0, pin=pin)

    def close(self) -> None:
        self._join_writer()
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None


def fetch_from_peer(channel, name: str, version: int, dest_dir: str, on_file=None,
                    timeout_s: float | None = None, on_entry=None,
                    pin_entry: bool = False) -> int:
    """Stream ``name@version`` from the peer behind the grpc ``channel``
    into ``dest_dir`` -> the bytes received. Raises ``grpc.RpcError`` on a
    transport or peer error (the caller tells NOT_FOUND from a failure) and
    ``PeerWireError`` on a broken stream; either carries the bytes received
    so far as ``partial_bytes``.

    ``on_entry``, when given, receives the ``PackedModelEntry`` rebuilt from
    the stream's RAM image after a clean end (chunks page-locked with
    ``pin_entry``), in a ``peer_build_entry`` span of its own. A failed
    rebuild is logged and dropped: the artifact on disk is complete, and
    the caller loads it the slow way."""
    from tfservingcache_tpu_torch.cache.providers.base import _notify_file

    call = channel.unary_stream(PEER_FETCH_PATH, request_serializer=lambda b: b,
                                response_deserializer=lambda b: b)
    rx = PeerStreamReceiver(dest_dir, assemble=on_entry is not None)
    ended = False
    try:
        try:
            with TRACER.span("peer_wire", model=f"{name}@{version}") as sp:
                for frame in call(encode_request(name, version), timeout=timeout_s):
                    kind = rx.feed(frame)
                    if kind == "meta":
                        _notify_file(on_file, MODEL_JSON, rx.meta_path)
                    elif kind == "end":
                        ended = True
                sp.attrs["bytes"] = rx.bytes_received
            if not ended:
                raise PeerWireError("peer stream closed without end frame")
        except BaseException as e:
            # the failure carries what arrived, for the outcome="error" bytes
            e.partial_bytes = rx.bytes_received
            raise
        if on_entry is not None:
            try:
                with TRACER.span("peer_build_entry", pinned=pin_entry):
                    entry = rx.build_entry(pin=pin_entry)
                on_entry(entry)
            except Exception as e:  # noqa: BLE001 - the artifact on disk is complete
                log.warning("packed-entry rebuild from the peer stream failed (%s: %s); "
                            "the artifact will be loaded from disk", type(e).__name__, e)
        return rx.bytes_received
    finally:
        rx.close()


@lockchecked
class PeerSource:
    """The outbound side: serves this node's host-tier entries to peers.
    ``GrpcServingServer.peer_source`` holds it (the server registers
    ``FetchPackedModel`` when set). Holds the in-flight cap a requesting
    host and the pin around each stream: an outbound read neither touches
    the tier's LRU order nor races an eviction."""

    _tpusc_guarded = {"_inflight": "_lock"}

    def __init__(self, runtime: Any, chunk_bytes: int = 2 << 20,
                 max_inflight_per_peer: int = 2) -> None:
        self.runtime = runtime
        self.chunk_bytes = int(chunk_bytes)
        self.max_inflight_per_peer = int(max_inflight_per_peer)
        self._lock = threading.Lock()
        self._inflight: dict[str, int] = {}

    def acquire(self, peer_key: str) -> bool:
        with self._lock:
            n = self._inflight.get(peer_key, 0)
            if n >= self.max_inflight_per_peer:
                return False
            self._inflight[peer_key] = n + 1
            return True

    def release(self, peer_key: str) -> None:
        with self._lock:
            n = self._inflight.get(peer_key, 0) - 1
            if n <= 0:
                self._inflight.pop(peer_key, None)
            else:
                self._inflight[peer_key] = n

    def pin(self, model_id) -> Any | None:
        tier = getattr(self.runtime, "_host_tier", None)
        if tier is None:
            return None
        return tier.pin(model_id)

    def unpin(self, model_id) -> None:
        tier = getattr(self.runtime, "_host_tier", None)
        if tier is not None:
            tier.unpin(model_id)


# -- conversation KV: FetchParkedConversation ---------------------------------

def encode_kv_request(conversation_id: str, model_id: Any) -> bytes:
    return json.dumps({"conversation": str(conversation_id), "model": str(model_id)}).encode()


def decode_kv_request(data: bytes) -> tuple[str, str]:
    try:
        req = json.loads(data.decode())
        return str(req["conversation"]), str(req["model"])
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise PeerWireError(f"bad FetchParkedConversation request: {e}") from e


def iter_kv_frames(parked: Any, conversation_id: str, chunk_msg_bytes: int) -> Iterator[bytes]:
    """Sender: the M frame, the packed blob in C frames of at most
    ``chunk_msg_bytes`` (at least 64 KiB), the E frame. The blob is a copy
    taken under the tier's lock, so nothing needs pinning."""
    from tfservingcache_tpu_torch.cache.conversation_kv import pack_parked

    blob = pack_parked(parked)
    meta = {
        "conversation": str(conversation_id),
        "model": str(parked.model_id),
        "nbytes": len(blob),
        "hash": hashlib.sha256(blob).hexdigest()[:32],
    }
    yield bytes([FRAME_META]) + json.dumps(meta).encode()
    step = max(int(chunk_msg_bytes), 64 << 10)
    mv = memoryview(blob)
    for off in range(0, len(mv), step):
        head = bytes([FRAME_CHUNK]) + _CHUNK_HDR.pack(0, off)
        yield b"".join((head, mv[off:off + step]))
    yield bytes([FRAME_END]) + json.dumps({"wire_bytes": len(blob)}).encode()


class KVStreamReceiver:
    """Receiver: reassembles a stream into a ``ParkedConversation``
    (``self.parked`` after a clean E frame), checking the declared length,
    the order of the chunks and the digest; raises ``PeerWireError``
    otherwise."""

    def __init__(self) -> None:
        self.meta: dict[str, Any] | None = None
        self.parked: Any = None
        self.bytes_received = 0
        self._buf: bytearray | None = None
        self._expect = 0
        self._hasher = hashlib.sha256()

    def feed(self, frame: bytes) -> str:
        """Take one frame -> "meta", "chunk" or "end"."""
        if not frame:
            raise PeerWireError("empty frame")
        kind = frame[0]
        if kind == FRAME_META:
            if self.meta is not None:
                raise PeerWireError("duplicate meta frame")
            try:
                self.meta = json.loads(frame[1:].decode())
                nbytes = int(self.meta["nbytes"])
                self.meta["hash"]
            except (ValueError, KeyError, UnicodeDecodeError) as e:
                raise PeerWireError(f"bad KV meta frame: {e}") from e
            if nbytes < 0:
                raise PeerWireError("negative KV blob length")
            self._buf = bytearray(nbytes)
            return "meta"
        if kind == FRAME_CHUNK:
            if self.meta is None or self._buf is None:
                raise PeerWireError("chunk frame before meta")
            body = memoryview(frame)[1:]
            if len(body) < _CHUNK_HDR.size:
                raise PeerWireError("truncated chunk frame")
            ci, off = _CHUNK_HDR.unpack_from(body)
            payload = body[_CHUNK_HDR.size:]
            if ci != 0:
                raise PeerWireError(f"KV stream chunk index {ci} != 0")
            if off != self._expect:
                raise PeerWireError(f"out-of-order KV chunk: offset {off}, "
                                    f"expected {self._expect}")
            end = off + len(payload)
            if end > len(self._buf):
                raise PeerWireError(f"KV blob overruns declared length {len(self._buf)}")
            self._hasher.update(payload)
            self._buf[off:end] = payload
            self._expect = end
            self.bytes_received += len(payload)
            return "chunk"
        if kind == FRAME_END:
            if self.meta is None or self._buf is None:
                raise PeerWireError("end frame before meta")
            if self._expect != len(self._buf):
                raise PeerWireError(f"KV stream ended short: {self._expect} of "
                                    f"{len(self._buf)} bytes")
            if self._hasher.hexdigest()[:32] != self.meta["hash"]:
                raise PeerWireError("KV blob hash mismatch")
            from tfservingcache_tpu_torch.cache.conversation_kv import unpack_parked

            self.parked = unpack_parked(bytes(self._buf))
            return "end"
        raise PeerWireError(f"unknown frame tag 0x{kind:02x}")


def fetch_parked_from_peer(channel, conversation_id: str, model_id: Any,
                           timeout_s: float | None = None) -> Any:
    """Pull ``conversation_id``'s parked KV for ``model_id`` from the peer
    behind the grpc ``channel`` -> the ``ParkedConversation`` (land it with
    ``ConversationKVTier.adopt``). Raises ``grpc.RpcError`` on a transport
    or peer error (NOT_FOUND: the peer holds no such conversation) and
    ``PeerWireError`` on a broken stream."""
    call = channel.unary_stream(PEER_KV_PATH, request_serializer=lambda b: b,
                                response_deserializer=lambda b: b)
    rx = KVStreamReceiver()
    ended = False
    for frame in call(encode_kv_request(conversation_id, model_id), timeout=timeout_s):
        if rx.feed(frame) == "end":
            ended = True
    if not ended:
        raise PeerWireError("peer KV stream closed without end frame")
    return rx.parked
