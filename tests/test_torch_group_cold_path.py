"""The device group's cold path in the port (tfservingcache_tpu_torch/
runtime/model_runtime.py: ``packed_device_put_sharded``,
``packed_device_put_group``, ``_dequantize_on_host``, ``unpack_entry_host``,
the group's host tier, ``_promote``'s sharded branch and adoption, and
``serving.mesh_fast_path``) against the JAX package's single-process mesh
runtime on the virtual 8-device CPU mesh (tests/conftest.py), mirroring
tests/test_mesh_parity.py:170 and :202 and tests/test_cold_pipeline.py:159.

Setup: the reference's f32 mesh-parity ``SMALL`` (2 layers, 4 heads over 2
KV heads, d_ff 128), a bf16 twin, and an int8 ``WIDE`` artifact (vocab
1024, d_ff 1024, so the embedding and the FFN quantize), each exported once
by the JAX package. The port's groups are ``["cpu"] * n`` for n = 2 (every
half cut) and 4 (attention whole on the leader, the rest cut);
``_PACK_CHUNK_BYTES`` is shrunk so that these models cut into many chunks.

Bars: exact. The pipelined, serialized, promoted and adopted group loads
give shards equal in values, shapes and strides and replies equal byte for
byte; greedy tokens equal the JAX mesh runtime's in f32 (the reference's
own parity bar, tests/test_mesh_parity.py:25); the host expansion of an
int8 artifact is ``torch.equal`` to the device one. Every runtime, engine
and node is closed in a ``finally``.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.parallel.mesh import make_mesh
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.parallel import sharding
from tfservingcache_tpu_torch.runtime import model_runtime as mr
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine, GenerateCoalescer
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId
from tfservingcache_tpu_torch.utils.tracing import TRACER

from torch_obs_globals import confined_globals

# the reference's mesh-parity config (tests/test_mesh_parity.py:29)
SMALL = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
         "d_ff": 128, "max_seq": 128, "dtype": "float32"}
WIDE = {"vocab_size": 1024, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 1024, "max_seq": 64, "dtype": "bfloat16"}
SMALL_CHUNK = 20000  # bytes: the test models cut into several chunks
TIER = 64 << 20
IDS = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]], np.int32)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("group_cold_store")
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=SMALL, seed=0)
    jreg.export_artifact("transformer_lm", str(base), name="lmb", version=1,
                         config=dict(SMALL, dtype="bfloat16"), seed=1)
    jreg.export_artifact("transformer_lm", str(base), name="q", version=1, config=WIDE, seed=2,
                         quantize="int8")
    return base


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)


def _model(store, name: str) -> Model:
    return Model(identifier=ModelId(name, 1), path=str(store / name / "1"))


def _group(n: int, tier: int = 0, **serving) -> TorchModelRuntime:
    return TorchModelRuntime(ServingConfig(**serving), devices=["cpu"] * n, host_tier_bytes=tier)


def _shards(rt, mid) -> list:
    """(path, spec, dim, shape, shards) of every leaf of a resident model."""
    return [(path, leaf.spec, leaf.dim, leaf.shape, leaf.shards)
            for path, leaf in treg.flatten_params(rt._resident.get(mid, touch=False).params)]


def _assert_same_shards(a: list, b: list) -> None:
    assert [x[:4] for x in a] == [x[:4] for x in b]
    for (path, *_rest, sa), (_p, *_r, sb) in zip(a, b):
        assert len(sa) == len(sb), path
        for x, y in zip(sa, sb):
            assert torch.equal(x, y) and x.dtype == y.dtype, path
            assert x.shape == y.shape and x.stride() == y.stride(), path
            assert x.is_contiguous(), path


def _logits(rt, mid) -> np.ndarray:
    return rt.predict(mid, {"input_ids": IDS}, output_filter=["logits"])["logits"]


def _last_load() -> dict:
    return next(s for s in TRACER.query(n=16) if s["name"] == "load")


def _stages(load: dict) -> dict:
    return {c["name"]: c for c in load.get("children", [])}


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_runtime_pipeline_gating(store, n):
    """A group that is not lockstep pipelines its tensor-parallel load
    (``device_transfer`` with ``pipelined`` and ``sharded``, many chunks);
    ``mesh_fast_path: false`` makes it lockstep and serialized; the replies
    are equal either way (reference tests/test_cold_pipeline.py:159)."""
    mid = ModelId("lm", 1)
    with confined_globals():
        on, off = _group(n), _group(n, mesh_fast_path=False)
        try:
            assert on.cold_pipeline_enabled and not on.mesh_lockstep
            assert off.mesh_lockstep and not off.cold_pipeline_enabled
            on.ensure_loaded(_model(store, "lm"))
            stages = _stages(_last_load())
            attrs = stages["device_transfer"]["attrs"]
            assert attrs["pipelined"] is True and attrs["sharded"] is True
            assert attrs["chunks"] > 2 and "transfer_sync" in stages
            off.ensure_loaded(_model(store, "lm"))
            assert "pipelined" not in _stages(_last_load())["device_transfer"].get("attrs", {})
            np.testing.assert_array_equal(_logits(on, mid), _logits(off, mid))
        finally:
            on.close()
            off.close()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["lm", "lmb", "q"])
def test_cold_load_pipelined_vs_serialized_parity_on_a_group(store, name, n):
    """The sharded pipelined transfer feeds each device only its own shard
    bytes; its shards equal the serialized group load's (values, shapes,
    strides, every shard contiguous), and so do the replies, byte for byte.
    The resident bytes are the artifact's logical bytes, one device's."""
    mid = ModelId(name, 1)
    pipe, ser = _group(n), _group(n, cold_load_pipeline=False)
    one = TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        for rt in (pipe, ser, one):
            assert rt.ensure_loaded(_model(store, name)) == "disk"
        _assert_same_shards(_shards(pipe, mid), _shards(ser, mid))
        np.testing.assert_array_equal(_logits(pipe, mid), _logits(ser, mid))
        nbytes = one._resident.get(mid, touch=False).nbytes
        assert pipe._resident.get(mid, touch=False).nbytes == nbytes
        assert ser._resident.get(mid, touch=False).nbytes == nbytes
    finally:
        pipe.close()
        ser.close()
        one.close()


def test_each_member_gets_only_its_own_shard_bytes(store):
    """The sharded plan (reference ``_shard_chunk_plan``): a cut leaf ships
    member i its i-th block and a replicated leaf ships once a distinct
    device, so on a group that repeats one device the transfer moves the
    tree's bytes once; each chunk holds one dtype of one member."""
    host = treg.load_artifact(str(store / "lm" / "1"))[1]
    group = (torch.device("cpu"),) * 2
    plan = treg.build("transformer_lm", SMALL).tensor_parallel(group)
    pairs = treg.flatten_params(host)
    arrs = [leaf for _path, leaf in pairs]
    cuts = [sharding.sharded_dim(sharding.spec_for(path, plan.rules, {"model": 2}),
                                 {"model": 2}) for path, _leaf in pairs]
    chunks = mr._shard_chunk_plan(arrs, cuts, group)
    sent = {0: 0, 1: 0}
    for member, segs in chunks:
        assert len({arrs[seg[0]].dtype for seg in segs}) == 1
        sent[member] += sum(mr._seg_nbytes(arrs, seg) for seg in segs)
    cut = sum(mr._leaf_nbytes(a) for a, c in zip(arrs, cuts) if c is not None)
    whole = sum(mr._leaf_nbytes(a) for a, c in zip(arrs, cuts) if c is None)
    assert cut and whole and sent == {0: cut // 2 + whole, 1: cut // 2}
    params, events, stats = mr.packed_device_put_sharded(
        host, plan.rules, group, {torch.device("cpu"): mr._ChunkCopier(torch.device("cpu"))})
    assert events == [] and stats["staging_bytes"] == 0 and stats["chunks"] == len(chunks)
    assert stats["bytes"] == mr.tree_nbytes(host) == mr.tree_nbytes(params)


@pytest.mark.parametrize("n", [2, 4])
def test_greedy_tokens_equal_the_jax_mesh_runtime_through_demote_and_promote(store, n):
    """f32: the group's greedy tokens after its pipelined load equal the JAX
    mesh runtime's; the model demoted to the group's tier and promoted back
    through the sharded replay (``tier`` host, ``device_transfer`` with
    ``promoted`` and ``sharded``) gives the same tokens and the same shards;
    a demotion with no retained entry gathers the shards back whole
    (reference tests/test_mesh_parity.py:202)."""
    mid, m = ModelId("lm", 1), _model(store, "lm")
    jrt = TPUModelRuntime(JServingConfig(platform="cpu"), mesh=make_mesh({"model": n}))
    with confined_globals():
        rt = _group(n, TIER)
        try:
            assert rt.host_tier_enabled and rt._demote_thread is not None
            assert rt.ensure_loaded(m) == "disk"
            assert rt.host_tier_contains(mid)  # the eager retain, whole leaves
            jrt.ensure_loaded(JModel(identifier=JModelId("lm", 1), path=m.path))
            want = np.asarray(jrt.generate(JModelId("lm", 1), IDS, max_new_tokens=10))
            first = _shards(rt, mid)
            np.testing.assert_array_equal(rt.generate(mid, IDS, max_new_tokens=10), want)
            for drop_entry in (False, True):
                if drop_entry:  # the demote worker repacks from the group's shards
                    rt._host_tier.remove(mid)
                rt.unload(mid)
                rt.drain_demotions()
                assert rt.host_tier_contains(mid) and not rt.is_loaded(mid)
                assert rt.ensure_loaded(m) == "host"
                load = _last_load()
                assert load["attrs"]["tier"] == "host"
                attrs = _stages(load)["device_transfer"]["attrs"]
                assert attrs["promoted"] is True and attrs["sharded"] is True
                assert rt._resident.get(mid, touch=False).tensor_parallel
                _assert_same_shards(_shards(rt, mid), first)
                np.testing.assert_array_equal(rt.generate(mid, IDS, max_new_tokens=10), want)
        finally:
            rt.close()
            jrt.close()


@pytest.mark.parametrize("n", [2, 4])
def test_an_adopted_entry_serves_byte_for_byte(store, n):
    """A packed entry from a one-device runtime's tier, adopted by a group,
    promotes through the sharded replay (source ``host``) and serves byte
    for byte the serialized group load; int8 entries (int8 chunks, as a
    peer ships them) expand on the host at the promotion."""
    for name in ("lmb", "q"):
        mid = ModelId(name, 1)
        one = TorchModelRuntime(ServingConfig(), device="cpu", host_tier_bytes=TIER)
        rt, ser = _group(n), _group(n, cold_load_pipeline=False)
        try:
            one.ensure_loaded(_model(store, name))
            entry = one._host_tier.get(mid)
            assert bool(entry.quant_dtypes) == (name == "q")
            rt.adopt_packed_entry(mid, entry)
            assert mid in rt._adopted
            assert rt.ensure_loaded(_model(store, name)) == "host"
            assert not rt._adopted and rt._resident.get(mid, touch=False).tensor_parallel
            ser.ensure_loaded(_model(store, name))
            _assert_same_shards(_shards(rt, mid), _shards(ser, mid))
            np.testing.assert_array_equal(_logits(rt, mid), _logits(ser, mid))
        finally:
            one.close()
            rt.close()
            ser.close()


def test_the_host_expansion_of_int8_equals_the_device_expansion(store):
    """``_dequantize_on_host`` against ``_dequantize_on_device`` on the same
    raw int8 tree: every leaf ``torch.equal``, in the original dtype; the
    entry's host unpack gives the same tree."""
    host = treg.load_artifact(str(store / "q" / "1"), raw_quant=True)[1]
    assert mr._has_quant(host)
    on_host = treg.flatten_params(mr._dequantize_on_host(host))
    on_device = treg.flatten_params(
        mr._dequantize_on_device(mr._to_device(host, torch.device("cpu"), copy=True)))
    unpacked = treg.flatten_params(mr.unpack_entry_host(
        mr.build_packed_entry(treg.build("transformer_lm", WIDE), host, 0)))
    assert [p for p, _ in on_host] == [p for p, _ in on_device] == [p for p, _ in unpacked]
    for (path, a), (_p, b), (_q, c) in zip(on_host, on_device, unpacked):
        assert a.dtype == b.dtype == c.dtype and torch.equal(a, b) and torch.equal(a, c), path


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serialized"])
def test_a_tp_int8_load_expands_on_the_host(store, pipeline, monkeypatch):
    """A TP-ruled int8 artifact expands on the host (its own ``host_dequant``
    stage, no ``device_dequant``) on both group paths; the weights are the
    device expansion cut by the plan."""
    calls = []
    real = mr._dequantize_on_device
    monkeypatch.setattr(mr, "_dequantize_on_device", lambda p: calls.append(1) or real(p))
    mid = ModelId("q", 1)
    with confined_globals():
        rt = _group(2, cold_load_pipeline=pipeline)
        try:
            rt.ensure_loaded(_model(store, "q"))
            stages = _stages(_last_load())
            assert "host_dequant" in stages and "device_dequant" not in stages and not calls
            host = treg.load_artifact(str(store / "q" / "1"), raw_quant=True)[1]
            want = mr._dequantize_on_device(mr._to_device(host, torch.device("cpu"), copy=True))
            plan = treg.build("transformer_lm", WIDE).tensor_parallel(rt.group)
            placed = sharding.shard_params(want, plan.rules, rt.group)
            _assert_same_shards(_shards(rt, mid),
                                [(p, x.spec, x.dim, x.shape, x.shards)
                                 for p, x in treg.flatten_params(placed)])
        finally:
            rt.close()


def test_mesh_fast_path_off_restores_lockstep_solo_dispatch(store):
    """``serving.mesh_fast_path: false`` is the A/B lever back: a lockstep
    group, serialized load, no host tier, adopted entries dropped, the
    continuous engine routing every request to the solo path with the same
    tokens, and no slot state built (reference
    tests/test_mesh_parity.py:170)."""
    mid = ModelId("lm", 1)
    fast, lock = _group(2, TIER), _group(2, TIER, mesh_fast_path=False)
    engines = []
    try:
        assert lock.mesh_lockstep and not lock.cold_pipeline_enabled
        assert not lock.host_tier_enabled and lock._demote_thread is None
        assert lock.mesh_topology()["mesh_fast_path"] is False
        assert fast.mesh_topology()["mesh_fast_path"] is True
        lock.adopt_packed_entry(mid, object())
        assert not lock._adopted
        for rt in (fast, lock):
            rt.ensure_loaded(_model(store, "lm"))
            engines.append(ContinuousGenerateEngine(rt, slots=4, chunk_tokens=4, page_tokens=16))
        p = np.array([[5, 17, 40, 3, 9, 61, 2, 11]], np.int32)
        out_fast = engines[0].generate(mid, p, max_new_tokens=8)
        out_lock = engines[1].generate(mid, p, max_new_tokens=8)
        np.testing.assert_array_equal(out_fast, out_lock)
        assert mid in fast._slot_states and mid not in lock._slot_states
        with pytest.raises(RuntimeError_, match="lockstep group"):
            lock.slot_decode_state(mid, 2)
    finally:
        for eng in engines:
            eng.close()
        fast.close()
        lock.close()


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("fast_path", [True, False])
def test_a_group_node_has_no_tier_and_stamps_the_knob(store, tmp_path, fast_path):
    """``build_node`` gives a group runtime no host tier, as the reference's
    node does, whatever ``cache.host_tier_bytes`` says; with the knob off a
    ``continuous`` node builds no engine and batching keeps the coalescer,
    and ``/monitoring/engine`` stamps the knob."""
    cfg = config_from_dict({
        "mesh": {"chips_per_group": 2},
        "serving": {"generate_engine": "continuous", "batch_window_ms": 1.0,
                    "kv_page_tokens": 16, "mesh_fast_path": fast_path},
        "cache": {"base_dir": str(tmp_path / "cache"), "host_tier_bytes": TIER},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
        "observability": {"flight_dir": ""},
    })
    with confined_globals():
        node = build_node(cfg, device="cpu")
        try:
            assert node.runtime.group == (torch.device("cpu"),) * 2
            assert not node.runtime.host_tier_enabled
            assert node.runtime.cold_pipeline_enabled is fast_path
            assert (node.engine is not None) is fast_path
            if not fast_path:
                assert isinstance(node.backend._generator, GenerateCoalescer)
            port = node.start("127.0.0.1")
            snap = _get(f"http://127.0.0.1:{port}/monitoring/engine")
            assert snap["mesh"] == {"mesh_devices": 2, "mesh_axes": {"model": 2},
                                    "mesh_fast_path": fast_path}
        finally:
            node.close()
    solo = TorchModelRuntime(ServingConfig(), device="cpu", host_tier_bytes=TIER)
    try:
        assert solo.host_tier_enabled  # one device keeps the knob's tier
    finally:
        solo.close()


def test_a_ring_group_keeps_the_one_device_paths(store):
    """A group whose plan cuts nothing (here a group of one) pipelines onto
    its leader as one device does, keeps whole-leaf entries and promotes
    them with the one-device replay."""
    mid, m = ModelId("lmb", 1), _model(store, "lmb")
    rt = TorchModelRuntime(ServingConfig(), devices=["cpu"], host_tier_bytes=TIER)
    one = TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        assert rt.ensure_loaded(m) == "disk" and one.ensure_loaded(m) == "disk"
        assert not rt._resident.get(mid, touch=False).tensor_parallel
        rt.unload(mid)
        rt.drain_demotions()
        assert rt.ensure_loaded(m) == "host"
        np.testing.assert_array_equal(_logits(rt, mid), _logits(one, mid))
    finally:
        rt.close()
        one.close()


def test_the_continuous_engine_serves_across_a_demotion_and_a_promotion(store):
    """The card check's flow: a group with a tier and the continuous engine
    answers a greedy ``:generate``, the model goes to the tier and comes
    back by promotion, and the engine's next ``:generate`` gives the same
    tokens, the page census green."""
    mid, m = ModelId("lm", 1), _model(store, "lm")
    rt = _group(2, TIER)
    eng = ContinuousGenerateEngine(rt, slots=4, chunk_tokens=4, page_tokens=16)
    p = np.array([[5, 17, 40, 3, 9, 61, 2, 11, 7, 7]], np.int32)
    try:
        assert rt.ensure_loaded(m) == "disk"
        before = eng.generate(mid, p, max_new_tokens=9)
        rt.unload(mid)
        rt.drain_demotions()
        assert rt.ensure_loaded(m) == "host"
        np.testing.assert_array_equal(eng.generate(mid, p, max_new_tokens=9), before)
        assert eng.decode_steps > 0
    finally:
        eng.close()
        rt.close()
