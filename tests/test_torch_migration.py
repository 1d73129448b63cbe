"""Conversation KV migration in the port (tfservingcache_tpu_torch/protocol/
peer_transfer.py, the gRPC server's ``FetchParkedConversation`` and
``ConversationKVTier.adopt``) against the JAX package's:

  - ``iter_kv_frames`` gives the reference's frames byte for byte for the
    same parked state (f32, bf16 and int8 pages);
  - each package's ``KVStreamReceiver`` takes the other's stream; a flipped
    byte, a dropped or reordered chunk, a short stream and a malformed
    frame raise ``PeerWireError``;
  - on two tiny port nodes on the CPU, turn 1 on node A, B fetches the
    parked turn over gRPC and adopts it, turn 2 posted to B prefills only
    the suffix + 1 token, and its greedy tokens equal A's own turn 2 and
    the JAX engine's on the same artifact (f32, exact); the page census is
    green on both nodes;
  - an unknown conversation answers NOT_FOUND, a node with no tier
    UNIMPLEMENTED, a malformed request INVALID_ARGUMENT;
  - the reference's ``fetch_parked_from_peer`` pulls from a port node.
"""

import json

import grpc
import numpy as np
import pytest

from tfservingcache_tpu.cache import conversation_kv as jkv
from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.protocol import peer_transfer as jpt
from tfservingcache_tpu.runtime.batcher import ContinuousGenerateEngine as JEngine
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.cache.conversation_kv import (
    ParkedConversation,
    pack_parked,
    unpack_parked,
)
from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.protocol import peer_transfer as pt
from tfservingcache_tpu_torch.protocol.grpc_client import make_channel
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import ModelId
from torch_cluster_util import TIMEOUT, fake_node, http, make_store, node_config

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
PT = 8
KNOBS = dict(slots=2, chunk_tokens=2, page_tokens=PT, arena_pages=48)
LM, JLM = ModelId("lm", 1), JModelId("lm", 1)
NEW = 6


def _parked(kind, seed=0, n_pages=3):
    """A port ParkedConversation (bf16 pages as uint16 bit patterns)."""
    rng = np.random.default_rng(seed)
    shape = (2, n_pages, 2, PT, 12)
    hist = rng.integers(1, 97, 17).astype(np.int32)
    ks = vs = None
    if kind == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random(shape[:4]).astype(np.float32) for _ in range(2))
    elif kind == "bfloat16":
        k, v = ((rng.standard_normal(shape).astype(np.float32).view(np.uint32) >> 16)
                .astype(np.uint16) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return ParkedConversation(model_id="lm@1", history=hist, pages_k=k, pages_v=v, k_scale=ks,
                              v_scale=vs, page_tokens=PT, page_dtype=kind)


@pytest.mark.parametrize("chunk", [1, 64 << 10, 2 << 20])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_frames_are_the_reference_byte_for_byte(kind, chunk):
    parked = _parked(kind, n_pages=40)
    blob = pack_parked(parked)
    got = list(pt.iter_kv_frames(parked, "conv-1", chunk))
    want = list(jpt.iter_kv_frames(jkv.unpack_parked(blob), "conv-1", chunk))
    assert got == want and len(got) >= 3
    assert got[0][0] == pt.FRAME_META and got[-1][0] == pt.FRAME_END
    meta = json.loads(got[0][1:])
    assert meta["nbytes"] == len(blob) and meta["model"] == "lm@1"


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_each_receiver_takes_the_other_packages_stream(kind):
    parked = _parked(kind, n_pages=30)
    blob = pack_parked(parked)
    rx = pt.KVStreamReceiver()
    outcomes = [rx.feed(f) for f in jpt.iter_kv_frames(jkv.unpack_parked(blob), "c", 64 << 10)]
    assert outcomes[0] == "meta" and outcomes[-1] == "end" and set(outcomes[1:-1]) == {"chunk"}
    assert pack_parked(rx.parked) == blob and rx.bytes_received == len(blob)
    jrx = jpt.KVStreamReceiver()
    for f in pt.iter_kv_frames(parked, "c", 64 << 10):
        jrx.feed(f)
    assert jkv.pack_parked(jrx.parked) == blob


def _broken(frames, how):
    frames = list(frames)
    if how == "flip":
        frames[1] = frames[1][:-1] + bytes([frames[1][-1] ^ 0xFF])
    elif how == "drop":
        del frames[1]
    elif how == "swap":
        frames[1], frames[2] = frames[2], frames[1]
    elif how == "short":
        frames = frames[:-2] + frames[-1:]
    elif how == "tail":
        frames = frames[:-1]
    elif how == "tag":
        frames.insert(1, b"Z")
    elif how == "empty":
        frames.insert(1, b"")
    elif how == "meta":
        frames.insert(1, frames[0])
    elif how == "early":
        frames = frames[1:]
    return frames


@pytest.mark.parametrize("how", ["flip", "drop", "swap", "short", "tag", "empty", "meta",
                                 "early", "tail"])
def test_a_broken_stream_raises_like_the_reference(how):
    parked = _parked("float32", n_pages=20)
    frames = _broken(pt.iter_kv_frames(parked, "c", 64 << 10), how)
    for mod in (pt, jpt):
        rx = mod.KVStreamReceiver()
        if how == "tail":  # no end frame: the receiver never finishes
            for f in frames:
                assert rx.feed(f) != "end"
            assert rx.parked is None
            continue
        with pytest.raises(mod.PeerWireError):
            for f in frames:
                rx.feed(f)
    for bad in (b"{", b'{"model": "x"}', b"\xff"):
        with pytest.raises(pt.PeerWireError):
            pt.decode_kv_request(bad)
    assert pt.decode_kv_request(pt.encode_kv_request("c", LM)) == ("c", "lm@1")
    assert pt.encode_kv_request("c", LM) == jpt.encode_kv_request("c", JLM)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    return base


def _engine_node(tmp_path, name, store):
    serving = {"generate_engine": "continuous", "generate_slots": KNOBS["slots"],
               "generate_chunk_tokens": KNOBS["chunk_tokens"], "kv_page_tokens": PT,
               "kv_arena_pages": KNOBS["arena_pages"], "conversation_kv_bytes": 32 << 20,
               "conversation_kv_dir": str(tmp_path / f"{name}_kv")}
    node = build_node(config_from_dict(node_config(tmp_path, name, store, serving=serving)),
                      device="cpu")
    try:
        node.start("127.0.0.1")
    except BaseException:
        node.close()
        raise
    return node


def _generate(node, ids, conv):
    status, raw, _ = http(f"http://127.0.0.1:{node.rest_port}/v1/models/lm/versions/1:generate",
                          {"input_ids": [ids], "max_new_tokens": NEW, "conversation_id": conv})
    assert status == 200, raw
    return json.loads(raw)["tokens"][0]


def test_a_turn_migrated_between_two_port_nodes(store, tmp_path):
    rng = np.random.default_rng(7)
    p1 = rng.integers(1, 97, 13).astype(np.int32).tolist()
    suffix = rng.integers(1, 97, 5).astype(np.int32).tolist()
    a = _engine_node(tmp_path, "a", store)
    b = _engine_node(tmp_path, "b", store)
    channel = make_channel(f"127.0.0.1:{a.grpc_port}")
    jrt = TPUModelRuntime(JConfig(platform="cpu"))
    jeng = None
    try:
        out1 = _generate(a, p1, "c")
        p2 = p1 + out1 + suffix
        parked = pt.fetch_parked_from_peer(channel, "c", LM, timeout_s=TIMEOUT)
        held, _ = a.engine.conversation_tier.get("c", str(LM), touch=False)
        assert pack_parked(parked) == pack_parked(held)
        b.engine.conversation_tier.adopt("c", parked)
        assert b.engine.conversation_tier.stats()["migrations_in"] == 1
        before = b.engine.prefill_tokens
        got = _generate(b, p2, "c")
        assert b.engine.resumes == 1
        assert b.engine.prefill_tokens - before == len(suffix) + 1
        # A-only: A resumes its own parked turn 1 (the fetch only peeked)
        want = _generate(a, p2, "c")
        assert a.engine.resumes == 1 and got == want
        # the JAX engine's turn 2 on the same artifact
        jrt.ensure_loaded(JModel(identifier=JLM, path=str(store / "lm" / "1")))
        jeng = JEngine(jrt, **KNOBS, conversation_kv_bytes=32 << 20,
                       conversation_kv_dir=str(tmp_path / "jax_kv"))
        jout1 = jeng.generate(JLM, np.asarray([p1], np.int32), max_new_tokens=NEW,
                              conversation_id="c")
        assert jout1[0].tolist() == out1
        jout2, stats = jeng.generate(JLM, np.asarray([p2], np.int32), max_new_tokens=NEW,
                                     conversation_id="c", return_stats=True)
        assert jout2[0].tolist() == got and stats[0]["prefill_tokens"] == len(suffix) + 1
        for node in (a, b):
            node.runtime._slot_states[LM].check_page_conservation()
        # the reference's client pulls the same state from the port node
        jparked = jpt.fetch_parked_from_peer(channel, "c", "lm@1", timeout_s=TIMEOUT)
        assert jkv.pack_parked(jparked) == pack_parked(
            a.engine.conversation_tier.get("c", str(LM), touch=False)[0])
        # an unknown conversation, and a malformed request
        with pytest.raises(grpc.RpcError) as err:
            pt.fetch_parked_from_peer(channel, "nope", LM, timeout_s=TIMEOUT)
        assert err.value.code() == grpc.StatusCode.NOT_FOUND and "nope" in err.value.details()
        call = channel.unary_stream(pt.PEER_KV_PATH, request_serializer=lambda x: x,
                                    response_deserializer=lambda x: x)
        with pytest.raises(grpc.RpcError) as err:
            list(call(b"{not json", timeout=TIMEOUT))
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        channel.close()
        if jeng is not None:
            jeng.close()
        jrt.close()
        b.close()
        a.close()


def test_a_node_without_a_tier_answers_unimplemented(tmp_path):
    node = fake_node(tmp_path, "a", make_store(tmp_path / "store", [("m", 1)]))
    channel = make_channel(f"127.0.0.1:{node.grpc_port}")
    try:
        assert node.grpc.conversation_tier is None
        with pytest.raises(grpc.RpcError) as err:
            pt.fetch_parked_from_peer(channel, "c", "m@1", timeout_s=TIMEOUT)
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        channel.close()
        node.close()


def test_adopt_counts_and_parks():
    from tfservingcache_tpu_torch.cache.conversation_kv import ConversationKVTier

    tier = ConversationKVTier(1 << 20)
    parked = unpack_parked(pack_parked(_parked("int8")))
    tier.adopt("c", parked)
    got, outcome = tier.get("c", "lm@1")
    assert outcome == "hit" and pack_parked(got) == pack_parked(parked)
    s = tier.stats()
    assert s["migrations_in"] == 1 and s["parked_total"] == 1
    assert set(jkv.ConversationKVTier(1 << 20).stats()) <= set(s)
    tier.close()
