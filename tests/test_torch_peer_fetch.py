"""Peer model adoption over ``tpusc.internal.PeerTransfer/FetchPackedModel``
(tfservingcache_tpu_torch/protocol/peer_transfer.py, cache/providers/peer.py,
the runtime's ``adopt_packed_entry``) against the JAX package's.

- The wire: the port's frames land an artifact whose leaves are the
  sender's byte for byte, and rebuild the sender's packed entry; the port's
  frames land in the reference's receiver and the reference's in the port's,
  each artifact loading in the other package with byte-equal leaves, an
  int8 entry among them (its ``q`` and ``scale`` chunks byte-exact, its
  ``quant_dtypes`` the reference's); broken streams, and a quantized
  manifest that points outside the file, are refused with ``PeerWireError``.
- Adoption: an entry rebuilt off the wire promotes with no read of the
  artifact, predicts ``torch.equal`` to a disk load, and within bf16's 2**-4
  of the reference's forward (tests/test_torch_serving.py's tolerance).
- The reference's node tests (tests/test_peer_fetch.py): pins, the in-flight
  cap, a two-node cold load, a clean NOT_FOUND miss, a peer at its cap, an
  eviction during a stream, a peer that dies mid-stream, and both fault
  kinds of the path; two ``build_node`` nodes behind routers; a port node
  adopting from a reference node (grpc.aio on an event loop of its own
  thread) and a reference node fetching from a port node.

Every port and directory comes from port 0 or ``tmp_path``; every node,
server, channel and thread is closed in a ``finally``; every gRPC call has
a deadline; no result waits on the clock. Models are 2-layer f32/bf16
transformer_lm, half_plus_two and mnist_cnn artifacts the JAX package's
seeded ``export_artifact`` writes.
"""

import asyncio
import dataclasses
import json
import os
import threading
import urllib.request
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
from tfservingcache_tpu.cache.host_tier import HostRamTier as JHostRamTier
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskProvider
from tfservingcache_tpu.cache.providers.peer import PeerProvider as JPeerProvider
from tfservingcache_tpu.cluster.status import FleetView as JFleetView
from tfservingcache_tpu.cluster.status import NodeStatus as JNodeStatus
from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.protocol import peer_transfer as jpt
from tfservingcache_tpu.protocol.grpc_server import GrpcServingServer as JGrpcServer
from tfservingcache_tpu.protocol.local_backend import LocalServingBackend as JBackend
from tfservingcache_tpu.runtime import model_runtime as jmr
from tfservingcache_tpu.runtime.fake import FakeRuntime as JFakeRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu.types import NodeInfo as JNodeInfo
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.host_tier import HostRamTier, PackedModelEntry
from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider
from tfservingcache_tpu_torch.cache.providers.peer import PeerProvider
from tfservingcache_tpu_torch.cluster.status import FleetView, NodeStatus
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.lab import faults
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.protocol import peer_transfer as pt
from tfservingcache_tpu_torch.protocol.grpc_server import GrpcServingServer, peer_host
from tfservingcache_tpu_torch.protocol.local_backend import LocalServingBackend
from tfservingcache_tpu_torch.runtime import model_runtime as mr
from tfservingcache_tpu_torch.runtime.fake import FakeRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId, NodeInfo
from tfservingcache_tpu_torch.utils.metrics import Metrics
from tfservingcache_tpu_torch.utils.tracing import TRACER

from torch_cluster_util import wait_until
from torch_obs_globals import confined_globals

TIMEOUT = 60.0  # every gRPC stream's and HTTP call's deadline (s)
TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
TINY_BF16 = dict(TINY, dtype="bfloat16")
# an int8 artifact of the reference (its embed crosses the int8 floor)
QUANT_CFG = {"vocab_size": 512, "d_model": 128, "n_layers": 1, "n_heads": 2,
             "n_kv_heads": 1, "d_ff": 256, "max_seq": 32, "dtype": "bfloat16"}
SMALL_CHUNK = 20000   # pack chunks of ~20 KB: several chunks a model
FRAME = 64 << 10      # the wire's smallest frame payload
BF16_TOL = 2.0**-4
X = {"input_ids": np.arange(1, 9, dtype=np.int32)[None]}
MID = ModelId("m", 1)
# name -> (family, config); each a model the store holds at version 1
MODELS = {"lm": ("transformer_lm", TINY), "lmb": ("transformer_lm", TINY_BF16),
          "mnist": ("mnist_cnn", None), "hpt": ("half_plus_two", None)}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    for seed, (name, (family, cfg)) in enumerate(MODELS.items()):
        jreg.export_artifact(family, str(base), name=name, version=1, config=cfg, seed=seed)
    jreg.export_artifact("transformer_lm", str(base), name="m", version=1, config=TINY, seed=3)
    jreg.export_artifact("transformer_lm", str(base), name="q", version=1, config=QUANT_CFG,
                         seed=0, quantize="int8")
    return base


@pytest.fixture(autouse=True)
def _globals(tmp_path):
    with confined_globals(tmp_path / "flight"):
        faults.disarm()
        try:
            yield
        finally:
            faults.disarm()


def _path(store, name: str) -> str:
    return os.path.join(str(store), name, "1")


def _port_entry(path: str) -> PackedModelEntry:
    """The entry the port's load of ``path`` retains (an int8 artifact read
    raw, as the runtime reads it)."""
    md, params = treg.load_artifact(path, raw_quant=True)
    return mr.build_packed_entry(md, params, hbm_bytes=0)


def _ref_entry(path: str):
    md, params = jreg.load_artifact(path, raw_quant=True)
    return jmr.build_packed_entry(md, params, None, 0)


def _u8(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).reshape(-1).view(np.uint8).tobytes()


def _dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return treg.dtype_name(leaf.dtype)
    return np.asarray(leaf).dtype.name


def _leaf(v) -> tuple:
    if isinstance(v, (treg.QuantLeaf, jreg.QuantLeaf)):  # a raw_quant load's
        return ("quant", v.orig_dtype, _leaf(v.q), _leaf(v.scale))
    return (_dtype(v), tuple(v.shape), _u8(v))


def leaves(tree) -> dict:
    """path -> (dtype name, shape, raw bytes) of a params tree of either
    package; a quantized leaf's entry holds its ``q``'s and ``scale``'s."""
    return {p: _leaf(v) for p, v in treg.flatten_params(tree)}


def _hold_entry(got, want, quant=None) -> None:
    """The rebuilt entry is the sender's: paths, owner, shapes, plans and
    chunk bytes and dtypes, and ``quant`` as its ``quant_dtypes`` ({} unless
    given)."""
    assert list(got.paths) == list(want.paths)
    assert [tuple(o) for o in got.owner] == [tuple(o) for o in want.owner]
    assert [tuple(s) for s in got.shapes] == [tuple(s) for s in want.shapes]
    assert dict(got.quant_dtypes) == dict(want.quant_dtypes) == (quant or {})
    assert [list(p) for p, _ in got.chunks] == [list(p) for p, _ in want.chunks]
    for (_p, g), (_q, w) in zip(got.chunks, want.chunks):
        assert _dtype(g) == _dtype(w)
        assert _u8(g) == _u8(w)


def _receive(frames, dest, assemble=True) -> tuple[pt.PeerStreamReceiver, list[str]]:
    rx = pt.PeerStreamReceiver(str(dest), assemble=assemble)
    try:
        kinds = [rx.feed(f) for f in frames]
    finally:
        rx.close()
    return rx, kinds


# -- the wire ------------------------------------------------------------------

# the int8 artifact: (family, its quant_dtypes by outer leaf: embed, the only
# leaf of QUANT_CFG with 65536 elements)
QUANT = ("transformer_lm", {0: "bfloat16"})


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("name", [*MODELS, "q"])
def test_wire_roundtrip_lands_the_senders_artifact(store, tmp_path, monkeypatch, name, chunked):
    """iter_frames -> PeerStreamReceiver: the landed artifact's leaves are
    the sender's byte for byte, and the entry rebuilt from the RAM image is
    the sender's (one pack chunk a dtype, or several with small chunks)."""
    if chunked:
        monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    entry = _port_entry(_path(store, name))
    frames = list(pt.iter_frames(entry, FRAME, model_id=ModelId(name, 1)))
    rx, kinds = _receive(frames, tmp_path / "rx")
    assert kinds[0] == "meta" and kinds[-1] == "end" and kinds.count("chunk") >= 1
    assert rx.bytes_received == entry.nbytes
    md, got = treg.load_artifact(str(tmp_path / "rx"), raw_quant=True)
    assert md.family == MODELS.get(name, QUANT)[0]
    assert leaves(got) == leaves(treg.load_artifact(_path(store, name), raw_quant=True)[1])
    _hold_entry(rx.build_entry(), entry, quant=QUANT[1] if name == "q" else None)
    # the digests are computed once and kept on the entry
    assert entry.wire_hashes == [c["hash"] for c in json.loads(frames[0][1:])["chunks"]]


@pytest.mark.parametrize("name", ["lm", "lmb", "mnist", "q"])
def test_port_frames_land_in_the_reference_receiver(store, tmp_path, monkeypatch, name):
    """The port's stream is the reference's wire: the reference's receiver
    lands an artifact the reference loads with the source's leaves, and
    rebuilds the reference's own entry of that artifact."""
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    monkeypatch.setattr(jmr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    entry = _port_entry(_path(store, name))
    rx = jpt.PeerStreamReceiver(str(tmp_path / "rx"), assemble=True)
    try:
        kinds = [rx.feed(f) for f in pt.iter_frames(entry, FRAME, model_id=ModelId(name, 1))]
    finally:
        rx.close()
    assert kinds[-1] == "end" and rx.bytes_received == entry.nbytes
    _md, got = jreg.load_artifact(str(tmp_path / "rx"))
    assert leaves(got) == leaves(jreg.load_artifact(_path(store, name))[1])
    rebuilt, want = rx.build_entry(), _ref_entry(_path(store, name))
    assert [list(p) for p, _ in rebuilt.chunks] == [list(p) for p, _ in want.chunks]
    assert [_u8(b) for _p, b in rebuilt.chunks] == [_u8(b) for _p, b in want.chunks]
    assert dict(rebuilt.quant_dtypes) == dict(want.quant_dtypes) == dict(entry.quant_dtypes)


@pytest.mark.parametrize("name", ["lm", "lmb", "mnist", "q"])
def test_reference_frames_land_in_the_port_receiver(store, tmp_path, monkeypatch, name):
    """The reference's stream of its own entry (built as
    tests/test_peer_fetch.py's ``_entry_for`` builds it) lands in the port's
    receiver as an artifact the port loads with the source's leaves, and
    the port rebuilds the entry its own load of that artifact retains."""
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    monkeypatch.setattr(jmr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    jentry = _ref_entry(_path(store, name))
    frames = list(jpt.iter_frames(jentry, FRAME, model_id=JModelId(name, 1)))
    rx, kinds = _receive(frames, tmp_path / "rx")
    assert kinds[-1] == "end" and rx.bytes_received == jentry.nbytes
    _md, got = treg.load_artifact(str(tmp_path / "rx"))
    assert leaves(got) == leaves(treg.load_artifact(_path(store, name))[1])
    _hold_entry(rx.build_entry(), _port_entry(_path(store, name)),
                quant=dict(jentry.quant_dtypes))
    # and the port's stream of the same entry is the reference's, frame for frame
    assert list(pt.iter_frames(_port_entry(_path(store, name)), FRAME,
                               model_id=ModelId(name, 1))) == frames


def _broken(frames, how):
    chunks = [i for i, f in enumerate(frames) if f[0] == pt.FRAME_CHUNK]
    if how == "corrupted":
        i = chunks[-1]
        return frames[:i] + [frames[i][:-1] + bytes([frames[i][-1] ^ 0xFF])] + frames[i + 1:]
    if how == "reordered":
        return [frames[0], frames[chunks[1]], frames[chunks[0]]] + frames[chunks[1] + 1:]
    if how == "truncated":
        return [frames[0], frames[-1]]  # the end frame with every chunk missing
    if how == "short_frame":
        return [frames[0], frames[chunks[0]][:5]]
    if how == "chunk_first":
        return frames[1:]
    if how == "duplicate_meta":
        return [frames[0]] + frames
    if how == "unknown_tag":
        return [frames[0], b"Z" + frames[chunks[0]][1:]]
    if how == "empty":
        return [frames[0], b""]
    if how == "overrun":
        return [frames[0], frames[chunks[0]] + b"\0" * (1 << 20)]  # past the chunk's bytes
    raise AssertionError(how)


BREAKS = {"corrupted": "hash mismatch", "reordered": "out-of-order",
          "truncated": "incomplete", "short_frame": "truncated chunk frame",
          "chunk_first": "chunk frame before meta", "duplicate_meta": "duplicate meta",
          "unknown_tag": "unknown frame tag", "empty": "empty frame", "overrun": "overruns"}


@pytest.mark.parametrize("how", list(BREAKS))
def test_a_broken_stream_is_refused_like_the_reference(store, tmp_path, how):
    frames = list(pt.iter_frames(_port_entry(_path(store, "lm")), FRAME))
    assert sum(f[0] == pt.FRAME_CHUNK for f in frames) >= 2  # a multi-frame chunk
    for i, receiver in enumerate((pt.PeerStreamReceiver, jpt.PeerStreamReceiver)):
        rx = receiver(str(tmp_path / f"rx{i}"))
        errors = (pt.PeerWireError, jpt.PeerWireError)
        with pytest.raises(errors, match=BREAKS[how]):
            try:
                for f in _broken(frames, how):
                    rx.feed(f)
            finally:
                rx.close()


def test_a_quantized_manifest_is_refused(store, tmp_path):
    """A quantized manifest whose scales lie outside the announced file is
    refused at the meta frame, before any byte lands (the int8 stream
    itself is taken: ``test_a_quantized_stream_from_the_reference_lands_byte_exact``)."""
    frames = list(jpt.iter_frames(_ref_entry(_path(store, "q")), FRAME))
    meta = json.loads(frames[0][1:])
    ent = next(e for e in meta["model_json"]["params"]["manifest"] if "quant" in e)
    ent["quant"]["scale_offset"] = meta["file_bytes"]
    rx = pt.PeerStreamReceiver(str(tmp_path / "rx"), assemble=True)
    with pytest.raises(pt.PeerWireError, match="quant scales of 'embed' lie outside"):
        rx.feed(bytes([pt.FRAME_META]) + json.dumps(meta).encode())
    rx.close()
    assert not os.path.exists(tmp_path / "rx")


def test_a_quantized_stream_from_the_reference_lands_byte_exact(store, tmp_path):
    """The reference's stream of its int8 entry of model ``q`` is taken by
    the port's receiver with no ``PeerWireError``: the landed artifact's raw
    ``q`` and ``scale`` are the store's byte for byte, and the rebuilt entry
    holds the reference's chunks and ``quant_dtypes``."""
    jentry = _ref_entry(_path(store, "q"))
    assert dict(jentry.quant_dtypes) == QUANT[1]
    frames = list(jpt.iter_frames(jentry, FRAME, model_id=JModelId("q", 1)))
    rx, kinds = _receive(frames, tmp_path / "rx")
    assert kinds[0] == "meta" and kinds[-1] == "end"
    assert rx.bytes_received == jentry.nbytes
    _md, got = treg.load_artifact(str(tmp_path / "rx"), raw_quant=True)
    assert isinstance(got["embed"], treg.QuantLeaf)
    assert leaves(got) == leaves(treg.load_artifact(_path(store, "q"), raw_quant=True)[1])
    rebuilt = rx.build_entry()
    assert dict(rebuilt.quant_dtypes) == dict(jentry.quant_dtypes)
    assert [tuple(o) for o in rebuilt.owner] == [tuple(o) for o in jentry.owner]
    assert [list(p) for p, _ in rebuilt.chunks] == [list(p) for p, _ in jentry.chunks]
    assert [_u8(b) for _p, b in rebuilt.chunks] == [_u8(b) for _p, b in jentry.chunks]


def test_an_entry_without_paths_cannot_be_served(store):
    entry = dataclasses.replace(_port_entry(_path(store, "lm")), paths=[])
    with pytest.raises(pt.PeerWireError, match="leaf-path map"):
        pt.build_wire_meta(entry)


def test_request_codec_is_the_references():
    assert pt.encode_request("m", 3) == jpt.encode_request("m", 3)
    assert pt.decode_request(jpt.encode_request("m", 3)) == ("m", 3)
    with pytest.raises(pt.PeerWireError, match="bad FetchPackedModel request"):
        pt.decode_request(b"{}")


# -- adoption --------------------------------------------------------------------

def _wire_entry(store, name, tmp_path) -> PackedModelEntry:
    frames = pt.iter_frames(_port_entry(_path(store, name)), FRAME)
    rx, _kinds = _receive(frames, tmp_path / f"wire_{name}")
    return rx.build_entry()


def _predict(rt, mid):
    out = rt.predict(mid, X)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("name", ["lm", "lmb", "q"])
def test_adopted_entry_promotes_without_reading_the_artifact(store, tmp_path, name):
    """An entry rebuilt off the wire serves the first load through the
    promotion (the Model handed over points at a directory that does not
    exist), is consumed once, predicts ``torch.equal`` to a disk load, and
    within bf16's tolerance of the reference's forward on the artifact."""
    mid = ModelId(name, 1)
    rt = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        rt.adopt_packed_entry(mid, _wire_entry(store, name, tmp_path))
        ghost = Model(mid, str(tmp_path / "ghost"), 0)
        assert rt.ensure_loaded(ghost) == "host"
        got = _predict(rt, mid)
        rt.unload(mid)
        assert rt.ensure_loaded(Model(mid, _path(store, name), 0)) == "disk"  # one-shot
        want = _predict(rt, mid)
    finally:
        rt.close()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    jrt = jmr.TPUModelRuntime(JServingConfig(hbm_capacity_bytes=1 << 30))
    try:
        jrt.ensure_loaded(JModel(JModelId(name, 1), _path(store, name), 0))
        ref = jrt.predict(JModelId(name, 1), X)
    finally:
        jrt.close()
    tol = BF16_TOL if name in ("lmb", "q") else 1e-4
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(ref[k], np.float32),
                                   rtol=0, atol=tol)


def test_a_failed_promotion_falls_through_to_the_disk_load(store, tmp_path):
    def boom(_params):
        raise RuntimeError("no module")

    entry = dataclasses.replace(_wire_entry(store, "lm", tmp_path), make_module=boom)
    rt = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        rt.adopt_packed_entry(ModelId("lm", 1), entry)
        assert rt.ensure_loaded(Model(ModelId("lm", 1), _path(store, "lm"), 0)) == "disk"
        assert rt.is_loaded(ModelId("lm", 1)) and not rt._adopted
    finally:
        rt.close()


def test_a_group_runtime_drops_an_adopted_entry(store, tmp_path):
    # a lockstep group of one (serving.mesh_fast_path off, reference
    # model_runtime.py:1073); a fast-path group adopts it
    # (tests/test_torch_group_cold_path.py)
    rt = mr.TorchModelRuntime(ServingConfig(mesh_fast_path=False), devices=["cpu"])
    try:
        rt.adopt_packed_entry(ModelId("lm", 1), _wire_entry(store, "lm", tmp_path))
        assert not rt._adopted
        assert rt.ensure_loaded(Model(ModelId("lm", 1), _path(store, "lm"), 0)) == "disk"
    finally:
        rt.close()


# -- pins and the in-flight cap -------------------------------------------------

def _dummy_entry(nbytes: int, seed: int = 0) -> PackedModelEntry:
    buf = torch.from_numpy((np.arange(nbytes, dtype=np.int64) + seed).astype(np.uint8))
    return PackedModelEntry(model_def=None, chunks=[([0], buf)], owner=[(0, "plain")],
                            shapes=[(nbytes,)], quant_dtypes={}, treedef=["w"],
                            make_module=None, nbytes=nbytes, paths=["w"])


def test_pin_survives_eviction_without_touching_lru():
    metrics = Metrics()
    tier = HostRamTier(capacity_bytes=256, metrics=metrics)
    m1, m2, m3 = ModelId("a", 1), ModelId("b", 1), ModelId("c", 1)
    try:
        tier.put(m1, _dummy_entry(100, 1))
        tier.put(m2, _dummy_entry(100, 2))
        assert tier.pin(ModelId("absent", 1)) is None  # a clean miss
        pinned = tier.pin(m1)
        assert pinned is not None
        # the pin left m1 least recently used: the next put evicts it first
        assert tier.put(m3, _dummy_entry(100, 3)) == [m1]
        assert tier.get(m1, touch=False) is None and m2 in tier and m3 in tier
        # the evicted but pinned entry stays readable and counted
        assert int(pinned.chunks[0][1][0]) == 1
        assert metrics.host_tier_bytes._only().value == 300
        assert metrics.evictions.labels("host").value == 1
        # refcounted: a second pin holds it through the first unpin
        assert tier.pin(m1) is pinned
        tier.unpin(m1)
        assert tier._pinned_evicted
        tier.unpin(m1)
        assert tier._pins == {} and tier._pinned_evicted == {}
        assert metrics.host_tier_bytes._only().value == 200
    finally:
        tier.close()


def test_peer_source_inflight_cap():
    src = pt.PeerSource(SimpleNamespace(), max_inflight_per_peer=2)
    assert src.acquire("10.0.0.2") and src.acquire("10.0.0.2")
    assert not src.acquire("10.0.0.2")   # at the cap
    assert src.acquire("10.0.0.3")       # the cap is a requesting host's
    src.release("10.0.0.2")
    assert src.acquire("10.0.0.2")
    assert src.pin(MID) is None          # a runtime without a tier serves nothing


@pytest.mark.parametrize("peer,host", [
    ("ipv4:10.0.0.2:5555", "10.0.0.2"), ("ipv4:127.0.0.1:40001", "127.0.0.1"),
    ("ipv6:[::1]:5555", "::1"), ("ipv6:%5B::1%5D:5555", "::1"),
    ("ipv6:[fe80::2]:1", "fe80::2"), (None, "?")])
def test_the_cap_keys_on_the_requesting_host(peer, host):
    assert peer_host(peer) == host


# -- two nodes over real gRPC ------------------------------------------------------

@contextmanager
def sender(tmp_path, store, name="sender", metrics=None, capacity=1 << 30,
           max_inflight=2):
    """A port gRPC server whose PeerSource serves a real HostRamTier (the
    CacheNode's wiring, built by hand so the test controls the tier)."""
    tier = HostRamTier(capacity, metrics)
    manager = CacheManager(DiskModelProvider(str(store)),
                           ModelDiskCache(str(tmp_path / f"cache_{name}"), 1 << 30),
                           FakeRuntime())
    srv = GrpcServingServer(LocalServingBackend(manager))
    srv.peer_source = pt.PeerSource(SimpleNamespace(_host_tier=tier), chunk_bytes=FRAME,
                                    max_inflight_per_peer=max_inflight)
    try:
        port = srv.start(0, host="127.0.0.1")
        yield tier, NodeInfo("127.0.0.1", 1, port)
    finally:
        srv.close()
        manager.close()
        tier.close()


@contextmanager
def cold(tmp_path, store, peers, runtime=None, mid=MID):
    """A cold port manager whose PeerProvider is bound to a fleet view that
    advertises ``peers`` ([(NodeInfo, warmth of ``mid``)])."""
    metrics = Metrics()
    fleet = FleetView(metrics=metrics)
    for info, warmth in peers:
        fleet.ingest(NodeStatus(ident=info.ident, seq=1, models={mid.key: warmth}))
    provider = PeerProvider(DiskModelProvider(str(store)), chunk_bytes=FRAME,
                            timeout_s=TIMEOUT)
    provider.bind_fleet(fleet, SimpleNamespace(
        _nodes_by_ident={n.ident: n for n, _w in peers}), set())
    cache = ModelDiskCache(str(tmp_path / "cache_cold"), 1 << 30)
    manager = CacheManager(provider, cache, runtime or FakeRuntime(), metrics=metrics)
    try:
        yield SimpleNamespace(manager=manager, cache=cache, fleet=fleet, metrics=metrics,
                              provider=provider)
    finally:
        provider.close()
        manager.close()


def _sources(metrics) -> dict:
    return {t: metrics.reload_source.labels(t).value for t in ("hbm", "host", "disk", "store",
                                                             "peer")}


def _span_names(d):
    yield d["name"]
    for c in d.get("children", ()):
        yield from _span_names(c)


def test_two_port_nodes_the_cold_one_adopts(store, tmp_path):
    """The warm node's tier holds the model; the cold node's miss streams it
    (``reload_source{peer}``, the bytes counted ok), lands the store's
    artifact byte for byte, promotes the adopted entry on a real runtime
    (no disk load) and predicts what a disk load predicts; the sender's
    pins are all released and its ledger counts the bytes served."""
    from tfservingcache_tpu_torch.utils.accounting import LEDGER

    LEDGER.configure(enabled=True)
    entry = _port_entry(_path(store, "m"))
    rt = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    with sender(tmp_path, store) as (tier, info), cold(tmp_path, store, [(info, 2)], rt) as b:
        tier.put(MID, entry)
        model = b.manager.ensure_servable(MID)
        assert model.metadata["fetch_source"] == "peer"
        assert model.metadata["fetch_peer"] == info.ident
        assert "packed_entry" not in model.metadata  # popped by the manager
        assert _sources(b.metrics) == {"hbm": 0, "host": 0, "disk": 0, "store": 0, "peer": 1}
        assert b.metrics.peer_fetch_bytes.labels("ok").value == entry.nbytes
        assert not rt._adopted  # consumed by the load
        _md, got = treg.load_artifact(b.cache.model_path(MID))
        assert leaves(got) == leaves(treg.load_artifact(_path(store, "m"))[1])
        seen = {n for t in TRACER.query(n=16) for n in _span_names(t)}
        assert {"peer_fetch", "peer_wire", "peer_build_entry"} <= seen
        loads = [t for t in TRACER.query(n=16) if "load" in set(_span_names(t))]
        assert loads and all("artifact_read" not in set(_span_names(t)) for t in loads)
        adopted = _predict(rt, MID)
        rt.unload(MID)
        assert rt.ensure_loaded(model) == "disk"
        for k, v in _predict(rt, MID).items():
            assert torch.equal(adopted[k], v), k
        assert b.fleet._peers[info.ident].forwards == 1
        assert b.fleet.health(info.ident) > b.fleet.health_threshold
        assert tier._pins == {} and tier._pinned_evicted == {}
        assert LEDGER.snapshot()["tenants"][str(MID)]["totals"]["peer_bytes_served"] == \
            entry.nbytes


def test_peer_not_found_is_a_clean_miss_then_the_store(store, tmp_path):
    """A stale advertisement (the sender's tier is empty): NOT_FOUND counts
    as a forward that worked, and the store serves the miss."""
    with sender(tmp_path, store) as (_tier, info), cold(tmp_path, store, [(info, 2)]) as b:
        model = b.manager.ensure_servable(MID)
        assert "fetch_source" not in model.metadata
        assert _sources(b.metrics)["store"] == 1 and _sources(b.metrics)["peer"] == 0
        assert b.metrics.peer_fetch_bytes.labels("not_found").value == 0
        assert b.fleet._peers[info.ident].forwards == 1
        assert b.fleet.health(info.ident) > b.fleet.health_threshold


def test_a_peer_at_its_stream_cap_sends_the_fetch_to_the_next(store, tmp_path):
    """The warmest candidate is at its cap (RESOURCE_EXHAUSTED): it stays
    healthy, and the next candidate streams the model."""
    entry = _port_entry(_path(store, "m"))
    with sender(tmp_path, store, "busy", max_inflight=0) as (busy_tier, busy), \
            sender(tmp_path, store, "free") as (free_tier, free), \
            cold(tmp_path, store, [(busy, 3), (free, 2)]) as b:
        busy_tier.put(MID, entry)
        free_tier.put(MID, entry)
        model = b.manager.ensure_servable(MID)
        assert model.metadata["fetch_peer"] == free.ident
        assert _sources(b.metrics)["peer"] == 1
        assert b.fleet._peers[busy.ident].forwards == 1
        assert b.fleet.health(busy.ident) > b.fleet.health_threshold
        assert b.metrics.peer_fetch_bytes.labels("ok").value == entry.nbytes


def test_an_outbound_stream_survives_a_concurrent_eviction(store, tmp_path, monkeypatch):
    """The sender's tier evicts the model after the stream's first frame:
    the pinned entry keeps the stream whole, and it frees at the unpin."""
    entry = _port_entry(_path(store, "m"))
    metrics_a = Metrics()
    with sender(tmp_path, store, metrics=metrics_a, capacity=entry.nbytes) as (tier, info), \
            cold(tmp_path, store, [(info, 2)]) as b:
        tier.put(MID, entry)
        real = pt.iter_frames

        def evicting(entry_, chunk_bytes, model_id=None):
            for i, frame in enumerate(real(entry_, chunk_bytes, model_id=model_id)):
                yield frame
                if i == 0:
                    tier.put(ModelId("filler", 1), _dummy_entry(64, 9))
                    assert tier.get(MID, touch=False) is None

        monkeypatch.setattr(pt, "iter_frames", evicting)
        model = b.manager.ensure_servable(MID)
        assert model.metadata["fetch_source"] == "peer"
        _md, got = treg.load_artifact(b.cache.model_path(MID))
        assert leaves(got) == leaves(treg.load_artifact(_path(store, "m"))[1])
        assert metrics_a.evictions.labels("host").value == 1
        assert tier._pins == {} and tier._pinned_evicted == {}


def test_a_peer_that_dies_mid_stream_degrades_to_the_store(store, tmp_path, monkeypatch):
    with sender(tmp_path, store) as (tier, info), cold(tmp_path, store, [(info, 2)]) as b:
        tier.put(MID, _port_entry(_path(store, "m")))
        real = pt.iter_frames

        def dying(entry_, chunk_bytes, model_id=None):
            it = real(entry_, chunk_bytes, model_id=model_id)
            yield next(it)   # the meta frame lands
            yield next(it)   # and some payload
            raise RuntimeError("simulated peer crash mid-stream")

        monkeypatch.setattr(pt, "iter_frames", dying)
        model = b.manager.ensure_servable(MID)
        assert "fetch_source" not in model.metadata
        assert _sources(b.metrics)["store"] == 1
        assert b.metrics.peer_fetch_bytes.labels("error").value == FRAME
        assert b.fleet.health(info.ident) < 1.0  # penalized
        treg.load_artifact(b.cache.model_path(MID))  # the store's artifact is whole
        assert tier._pins == {}


def test_a_server_without_a_source_answers_unimplemented(store, tmp_path):
    import grpc

    from tfservingcache_tpu_torch.protocol.grpc_client import make_channel

    manager = CacheManager(DiskModelProvider(str(store)),
                           ModelDiskCache(str(tmp_path / "cache"), 1 << 30), FakeRuntime())
    srv = GrpcServingServer(LocalServingBackend(manager))
    ch = None
    try:
        port = srv.start(0, host="127.0.0.1")
        ch = make_channel(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError) as err:
            pt.fetch_from_peer(ch, "m", 1, str(tmp_path / "rx"), timeout_s=TIMEOUT)
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        if ch is not None:
            ch.close()
        srv.close()
        manager.close()


def test_a_bad_request_is_invalid_argument(store, tmp_path):
    import grpc

    from tfservingcache_tpu_torch.protocol.grpc_client import make_channel

    with sender(tmp_path, store) as (_tier, info):
        ch = make_channel(f"127.0.0.1:{info.grpc_port}")
        try:
            call = ch.unary_stream(pt.PEER_FETCH_PATH, request_serializer=lambda b: b,
                                   response_deserializer=lambda b: b)
            with pytest.raises(grpc.RpcError) as err:
                list(call(b"not json", timeout=TIMEOUT))
            assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        finally:
            ch.close()


# -- faults on the path ---------------------------------------------------------------

def test_corrupt_peer_chunk_leads_to_the_store(store, tmp_path):
    with sender(tmp_path, store) as (tier, info), cold(tmp_path, store, [(info, 2)]) as b:
        tier.put(MID, _port_entry(_path(store, "m")))
        faults.arm([faults.FaultSpec(kind="corrupt_peer_chunk", count=1)])
        model = b.manager.ensure_servable(MID)
        assert faults.snapshot()[0]["fired"] == 1
        assert "fetch_source" not in model.metadata
        assert _sources(b.metrics)["store"] == 1 and _sources(b.metrics)["peer"] == 0
        assert b.metrics.peer_fetch_bytes.labels("error").value > 0
        _md, got = treg.load_artifact(b.cache.model_path(MID))
        assert leaves(got) == leaves(treg.load_artifact(_path(store, "m"))[1])


def test_stall_store_sleeps_at_the_managers_miss(store, tmp_path, monkeypatch):
    """The stall fires once, at the top of the provider miss, before the
    provider is asked anything: the sleep is recorded, not slept."""
    events = []
    monkeypatch.setattr(faults.time, "sleep", lambda s: events.append(("sleep", s)))
    provider = DiskModelProvider(str(store))
    real_size = provider.model_size
    provider.model_size = lambda *a: events.append(("model_size",)) or real_size(*a)
    manager = CacheManager(provider, ModelDiskCache(str(tmp_path / "cache"), 1 << 30),
                           FakeRuntime(), metrics=Metrics())
    try:
        faults.arm([faults.FaultSpec(kind="stall_store", duration_s=7.5, model=str(MID))])
        manager.ensure_servable(MID)
        manager.ensure_servable(MID)  # a hit: no provider miss, no stall
    finally:
        manager.close()
    assert events == [("sleep", 7.5), ("model_size",)]
    assert faults.snapshot() == [{"kind": "stall_store", "visits": 1, "fired": 1}]


# -- full nodes behind routers ----------------------------------------------------------

def _node_cfg(tmp_path, name, store, **cache):
    return config_from_dict({
        "serving": {"max_concurrent_models": 2},
        "cache": {"base_dir": str(tmp_path / f"cache_{name}"), **cache},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
        "proxy": {"rest_port": 0, "grpc_port": 0},
        "discovery": {"type": "static", "prefer_localhost": True},
        "cluster": {"max_replicas_per_model": 0, "status_poll_interval_s": 3600.0},
        "observability": {"flight_dir": str(tmp_path / "flight")},
    })


def _post(port, name, body) -> bytes:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{name}/versions/1:predict",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        assert resp.status == 200
        return resp.read()


def test_two_build_node_nodes_behind_routers_adopt(store, tmp_path):
    """``build_node`` wires the PeerProvider and the PeerSource; the router
    arms the provider. Node A answers first (its load retains the entry in
    its host tier); node B, asked directly, streams the model from A and
    answers A's reply byte for byte, and a prune of A closes B's channel."""
    from tfservingcache_tpu_torch.cluster.router import Router

    cfgs = [_node_cfg(tmp_path, n, store, host_tier_bytes=1 << 26) for n in ("a", "b")]
    nodes, routers = [], []
    try:
        for cfg in cfgs:
            nodes.append(build_node(cfg, device="cpu"))
            nodes[-1].start("127.0.0.1")
        idents = [f"127.0.0.1:{n.rest_port}:{n.grpc_port}" for n in nodes]
        for node, cfg in zip(nodes, cfgs):
            assert isinstance(node.manager.provider, PeerProvider)
            assert node.grpc.peer_source is not None
            cfg.discovery.nodes = idents
            routers.append(Router(cfg, node))
            routers[-1].start("127.0.0.1")
        a, b = nodes
        assert b.manager.provider._fleet is routers[1].fleet
        body = {"instances": X["input_ids"].tolist()}
        want = _post(a.rest_port, "m", body)
        assert a.runtime.host_tier_contains(MID)
        # B polls A's /monitoring/status until it shows the model resident
        a_info = routers[1].cluster._nodes_by_ident[idents[0]]
        wait_until(lambda: routers[1].fleet.ingest(routers[1].status_exchange._fetch(a_info))
                   or routers[1].fleet.warmth(idents[0], MID.key) == 3)
        assert routers[1].fleet.warmth(idents[0], MID.key) == 3
        assert _post(b.rest_port, "m", body) == want
        assert b.metrics.reload_source.labels("peer").value == 1
        assert b.metrics.reload_source.labels("store").value == 0
        assert b.metrics.peer_fetch_bytes.labels("ok").value > 0
        b.manager.provider.prune([n for n in routers[1].cluster._nodes_by_ident.values()
                                  if n.ident == idents[1]])
        assert not b.manager.provider._channels
    finally:
        for r in routers:
            r.close()
        for n in nodes:
            n.close()


# -- across the packages ---------------------------------------------------------------

class _LoopThread:
    """An asyncio loop on a thread of its own, for the reference's grpc.aio
    server; ``close`` stops and closes it."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(TIMEOUT)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT)
        self.loop.close()


@contextmanager
def reference_sender(tmp_path, store):
    """The reference's grpc.aio server with a PeerSource over its own tier."""
    tier = JHostRamTier(capacity_bytes=1 << 30)
    manager = JCacheManager(JDiskProvider(str(store)),
                            JDiskCache(str(tmp_path / "cache_ref"), capacity_bytes=1 << 30),
                            JFakeRuntime())
    backend = JBackend(manager)
    srv = JGrpcServer(backend)
    srv.peer_source = jpt.PeerSource(SimpleNamespace(_host_tier=tier), chunk_bytes=FRAME)
    loop = _LoopThread()
    started = False
    try:
        port = loop.run(srv.start(0, host="127.0.0.1"))
        started = True
        yield tier, NodeInfo("127.0.0.1", 1, port)
    finally:
        try:
            if started:
                loop.run(srv.close())
            backend.close()
            manager.close()
        finally:
            loop.close()


def _port_node_adopts_from_a_reference_node(store, tmp_path, name):
    mid = ModelId(name, 1)
    rt = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    with reference_sender(tmp_path, store) as (jtier, info), \
            cold(tmp_path, store, [(info, 2)], rt, mid=mid) as b:
        jtier.put(JModelId(name, 1), _ref_entry(_path(store, name)))
        model = b.manager.ensure_servable(mid)
        assert model.metadata["fetch_source"] == "peer"
        assert _sources(b.metrics)["peer"] == 1
        _md, got = treg.load_artifact(b.cache.model_path(mid), raw_quant=True)
        assert leaves(got) == leaves(treg.load_artifact(_path(store, name), raw_quant=True)[1])
        assert rt.is_loaded(mid) and not rt._adopted  # the adopted entry was promoted
        adopted = _predict(rt, mid)
        rt.unload(mid)
        assert rt.ensure_loaded(model) == "disk"
        for k, v in _predict(rt, mid).items():
            assert torch.equal(adopted[k], v), k
        assert jtier._pins == {}
    return b


def test_a_port_node_adopts_from_a_reference_node(store, tmp_path):
    """The reference node streams its own entry over the unchanged wire;
    the port node lands it, adopts it (promotion, no disk load) and
    predicts what its own disk load of the store's artifact predicts."""
    _port_node_adopts_from_a_reference_node(store, tmp_path, "m")


def test_a_port_node_adopts_an_int8_entry_from_a_reference_node(store, tmp_path, monkeypatch):
    """The same for the reference's int8 entry: adopted, not sent to the
    store, and promoted through the on-device dequant."""
    calls = []
    real = mr._dequantize_on_device
    monkeypatch.setattr(mr, "_dequantize_on_device", lambda p: calls.append(1) or real(p))
    b = _port_node_adopts_from_a_reference_node(store, tmp_path, "q")
    assert _sources(b.metrics)["store"] == 0
    assert calls  # the promotion and the disk load each dequantized on the device


def _reference_node_fetches_from_a_port_node(store, tmp_path, name):
    mid = ModelId(name, 1)
    entry = _port_entry(_path(store, name))
    with sender(tmp_path, store) as (tier, info):
        tier.put(mid, entry)
        jinfo = JNodeInfo(info.host, info.rest_port, info.grpc_port)
        metrics = JMetrics()
        fleet = JFleetView(metrics=metrics)
        fleet.ingest(JNodeStatus(ident=jinfo.ident, seq=1, models={mid.key: 2}))
        provider = JPeerProvider(JDiskProvider(str(store)), chunk_bytes=FRAME,
                                 timeout_s=TIMEOUT)
        provider.bind_fleet(fleet, SimpleNamespace(_nodes_by_ident={jinfo.ident: jinfo}), set())
        cache = JDiskCache(str(tmp_path / "cache_jcold"), capacity_bytes=1 << 30)
        manager = JCacheManager(provider, cache, JFakeRuntime(), metrics)
        try:
            model = manager.ensure_servable(JModelId(name, 1))
            assert model.metadata["fetch_source"] == "peer"
            assert metrics.registry.get_sample_value(
                "tpusc_peer_fetch_bytes_total", {"outcome": "ok"}) == entry.nbytes
            path = cache.model_path(JModelId(name, 1))
            _md, got = jreg.load_artifact(path, raw_quant=True)
            assert leaves(got) == leaves(jreg.load_artifact(_path(store, name), raw_quant=True)[1])
            jentry = model.metadata.get("packed_entry")
            if jentry is None:  # the reference's own retain of what landed
                jentry = _ref_entry(path)
            assert dict(jentry.quant_dtypes) == dict(entry.quant_dtypes)
        finally:
            provider.close()
            manager.close()
        assert tier._pins == {}


def test_a_reference_node_fetches_from_a_port_node(store, tmp_path):
    """The other direction: the reference's PeerProvider streams the port
    node's entry and lands the store's artifact byte for byte."""
    _reference_node_fetches_from_a_port_node(store, tmp_path, "m")


def test_a_reference_node_fetches_an_int8_entry_from_a_port_node(store, tmp_path):
    """The same for the port's int8 entry: the reference lands the store's
    int8 artifact byte for byte (raw ``q`` and ``scale``), with the port
    entry's ``quant_dtypes``."""
    _reference_node_fetches_from_a_port_node(store, tmp_path, "q")
