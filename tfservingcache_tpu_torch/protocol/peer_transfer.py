"""Peer-transfer wire (counterpart of
``tfservingcache_tpu/protocol/peer_transfer.py``): the shared frame tags and
the conversation KV half, ``tpusc.internal.PeerTransfer/
FetchParkedConversation``. The packed-model half (``FetchPackedModel``)
is not ported yet.

The method is server streaming with raw-bytes serializers (no generated
stubs), a one-byte tag a frame:

    request  = JSON {"conversation": ..., "model": "name@version"}
    frame M  = b"M" + JSON {"conversation", "model", "nbytes", "hash"}
    frame C  = b"C" + <u32 chunk index = 0> <u64 offset> + payload
    frame E  = b"E" + JSON {"wire_bytes": n}

The payload is one ``pack_parked`` blob (cache/conversation_kv.py) carved
into C frames in order; ``hash`` is the blob's sha256 cut to 128 bits. The
bytes are the reference's, so a reference node and a port node migrate
conversations to each other.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Any, Iterator

PEER_TRANSFER_SERVICE = "tpusc.internal.PeerTransfer"
PEER_KV_METHOD = "FetchParkedConversation"
PEER_KV_PATH = f"/{PEER_TRANSFER_SERVICE}/{PEER_KV_METHOD}"

FRAME_META = 0x4D    # "M"
FRAME_CHUNK = 0x43   # "C"
FRAME_END = 0x45     # "E"
_CHUNK_HDR = struct.Struct("<IQ")


class PeerWireError(Exception):
    """A malformed or integrity-failing peer stream."""


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
