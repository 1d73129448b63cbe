"""The port's pipelined cold load (tfservingcache_tpu_torch/runtime/
model_runtime.py: ``_pack_plan``, ``packed_device_put_pipelined``) against
the JAX package's, on artifacts the JAX package wrote: the same transfer
plan, parameters equal to the serialized load's, predictions equal to the
serialized load's and within each family's bound of the JAX runtime's
(tests/test_torch_families.py, tests/test_torch_transformer_lm.py): exact
for half_plus_two, 2**-7 for mnist_cnn logits, 1e-4 for f32 transformer_lm
logits.

``_PACK_CHUNK_BYTES`` is shrunk on both packages so that test-size models
cut into many chunks. Every runtime is closed in a ``finally``; nothing is
page-locked on the CPU.
"""

import os
import threading

import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models.t5 import TINY_CONFIG as T5_TINY
from tfservingcache_tpu.runtime import model_runtime as jmr
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.runtime import model_runtime as mr
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.types import Model, ModelId
from tfservingcache_tpu_torch.utils import tracing
from torch_obs_globals import confined_globals

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
FAMILIES = {
    "half_plus_two": (None, lambda: {"x": np.linspace(-1, 1, 5).astype(np.float32)}),
    "mnist_cnn": (None, lambda: {"image": np.random.default_rng(0).random(
        (2, 28, 28, 1), dtype=np.float32)}),
    "transformer_lm": (TINY, lambda: {"input_ids": np.arange(1, 9, dtype=np.int32)[None]}),
    "t5": (T5_TINY, lambda: {"input_ids": np.array([[5, 6, 7, 8, 9, 0]], np.int32),
                             "decoder_input_ids": np.arange(1, 4, dtype=np.int32)[None]}),
}
TOL = {"half_plus_two": 0.0, "mnist_cnn": 2.0**-7, "transformer_lm": 1e-4, "t5": 2.0**-4}
SMALL_CHUNK = 20000  # bytes: the tiny models cut into several chunks


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    for family, (config, _inputs) in FAMILIES.items():
        jreg.export_artifact(family, str(base), name=family, version=1, config=config, seed=5)
    return base


def _model(store, family: str) -> Model:
    return Model(ModelId(family, 1), os.path.join(str(store), family, "1"), 0)


def _jax_plan(path: str) -> tuple[list[list[int]], list[str], list[tuple]]:
    host = jreg.load_artifact(path, raw_quant=True)[1]
    _outer, _treedef, arrs, _owner = jmr._flatten_for_pack(host)
    entry_paths = jmr.build_packed_entry(None, host, None, 0).paths
    return jmr._pack_plan(arrs), entry_paths, [a.shape for a in arrs]


@pytest.mark.parametrize("chunk_bytes", [mr._PACK_CHUNK_BYTES, SMALL_CHUNK, 4096, 1])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pack_plan_is_the_references(store, monkeypatch, family, chunk_bytes):
    """The same flat indices in the same chunks in the same order, over
    leaves flattened in the same order to the same paths and shapes."""
    monkeypatch.setattr(jmr, "_PACK_CHUNK_BYTES", chunk_bytes)
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", chunk_bytes)
    path = _model(store, family).path
    want_plan, want_paths, want_shapes = _jax_plan(path)
    _outer, treedef, arrs, owner = mr._flatten_for_pack(treg.load_artifact(path)[1])
    assert mr._pack_plan(arrs) == want_plan
    assert treedef == want_paths
    assert [tuple(a.shape) for a in arrs] == [tuple(s) for s in want_shapes]
    assert owner == [(i, "plain") for i in range(len(arrs))]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mapped_read_is_the_plain_read(store, family):
    """The pipelined load's read (``map_params``: a private mapping of
    ``params.bin``) gives the plain read's leaves, and a write through a
    leaf never reaches the file."""
    path = _model(store, family).path
    bin_path = os.path.join(path, "params.bin")
    before = open(bin_path, "rb").read()
    mapped = treg.flatten_params(treg.load_artifact(path, map_params=True)[1])
    plain = treg.flatten_params(treg.load_artifact(path)[1])
    assert [p for p, _ in mapped] == [p for p, _ in plain]
    assert all(torch.equal(m, q) and m.dtype == q.dtype for (_, m), (_, q) in zip(mapped, plain))
    mapped[0][1].view(-1)[0] += 1
    assert open(bin_path, "rb").read() == before


def _reference_predict(store, family: str, inputs: dict) -> dict:
    rt = jmr.TPUModelRuntime(JServingConfig(platform="cpu"))
    try:
        m = _model(store, family)
        rt.ensure_loaded(JModel(JModelId(family, 1), m.path, 0))
        return {k: np.asarray(v) for k, v in rt.predict(JModelId(family, 1), inputs).items()}
    finally:
        rt.close()


def _loaded(rt, mid):
    return rt._resident.get(mid, touch=False)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pipelined_load_equals_the_serialized_load(store, monkeypatch, family, depth):
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    m = _model(store, family)
    inputs = FAMILIES[family][1]()
    pipe = mr.TorchModelRuntime(ServingConfig(cold_pipeline_buffer_depth=depth), device="cpu")
    ser = mr.TorchModelRuntime(ServingConfig(cold_load_pipeline=False), device="cpu")
    try:
        assert pipe.cold_pipeline_enabled and not ser.cold_pipeline_enabled
        assert pipe.ensure_loaded(m) == ser.ensure_loaded(m) == "disk"
        got = treg.flatten_params(_loaded(pipe, m.identifier).params)
        want = treg.flatten_params(_loaded(ser, m.identifier).params)
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(torch.equal(g, w) and g.dtype == w.dtype for (_, g), (_, w) in zip(got, want))
        assert _loaded(pipe, m.identifier).nbytes == _loaded(ser, m.identifier).nbytes
        out_p, out_s = pipe.predict(m.identifier, inputs), ser.predict(m.identifier, inputs)
    finally:
        pipe.close()
        ser.close()
    ref = _reference_predict(store, family, inputs)
    assert set(out_p) == set(out_s) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out_p[k], out_s[k])
        if np.issubdtype(ref[k].dtype, np.floating):
            assert np.abs(out_p[k] - ref[k]).max() <= TOL[family], k
        elif family != "mnist_cnn":  # mnist classes: equal where decided (test_torch_families)
            np.testing.assert_array_equal(out_p[k], ref[k])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_leaves_are_views_into_their_chunks(store, monkeypatch, family):
    """A pipelined load's leaves share one storage a chunk (no split copy),
    and the model's device bytes are the reference's ``tree_nbytes`` of
    the same artifact: a chunk's storage is counted once."""
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    monkeypatch.setattr(jmr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    m = _model(store, family)
    plan = _jax_plan(m.path)[0]
    rt = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        rt.ensure_loaded(m)
        loaded = _loaded(rt, m.identifier)
        leaves = [leaf for _p, leaf in treg.flatten_params(loaded.params)]
        if len(leaves) > 2:  # two leaves or fewer are copied one by one (reference :350)
            storages = {leaf.untyped_storage().data_ptr() for leaf in leaves}
            assert len(plan) > 1 and len(storages) == len(plan)
        want = jmr.tree_nbytes(jreg.load_artifact(m.path)[1])
        assert loaded.nbytes == want
    finally:
        rt.close()


class _FakeCudart:
    """``cudaHostRegister`` / ``cudaHostUnregister`` over a set of locked
    pages: a range that touches a page already locked is refused with
    cudaErrorHostMemoryAlreadyRegistered (712), as the runtime refuses it."""

    def __init__(self) -> None:
        self.pages: dict[int, int] = {}  # locked page -> start of its range
        self.ranges: dict[int, int] = {}  # start -> bytes

    def _span(self, ptr: int, nbytes: int) -> range:
        return range(ptr // mr._PAGE, -(-(ptr + nbytes) // mr._PAGE))

    def cudaHostRegister(self, ptr: int, nbytes: int, flags: int) -> int:
        span = self._span(ptr, nbytes)
        if any(p in self.pages for p in span):
            return 712
        self.pages.update((p, ptr) for p in span)
        self.ranges[ptr] = nbytes
        return 0

    def cudaHostUnregister(self, ptr: int) -> int:
        for p in self._span(ptr, self.ranges.pop(ptr)):
            del self.pages[p]
        return 0


@pytest.mark.parametrize("chunk_bytes", [mr._PACK_CHUNK_BYTES, SMALL_CHUNK, 1])
def test_tier_chunks_lock_pages_of_their_own(store, monkeypatch, chunk_bytes):
    """Every page-locked tier chunk starts on a page and spans whole pages
    that no other chunk shares, so chunks of a few bytes (half_plus_two's
    scalars, a short last chunk) lock beside each other; the locked bytes
    are counted while the chunks live and released with them."""
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", chunk_bytes)
    cudart = _FakeCudart()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: cudart)
    base = mr.locked_chunk_bytes()[0]
    entries = []
    for _round in range(2):
        for family in sorted(FAMILIES):
            model_def, params = treg.load_artifact(_model(store, family).path)
            entries.append(mr.build_packed_entry(model_def, params, 0, pin=True))
    chunks = [buf for entry in entries for _chunk, buf in entry.chunks]
    assert len(cudart.ranges) == len(chunks)
    assert all(buf.data_ptr() % mr._PAGE == 0 for buf in chunks)
    locked = sum(cudart.ranges.values())
    assert locked % mr._PAGE == 0
    assert mr.locked_chunk_bytes()[0] - base == locked
    want = [treg.flatten_params(treg.load_artifact(_model(store, f).path)[1])
            for f in sorted(FAMILIES)] * 2
    for entry, leaves in zip(entries, want):  # the fill is the leaves' bytes
        flat = torch.cat([buf.reshape(-1).float() for _c, buf in entry.chunks])
        assert torch.equal(flat, torch.cat([leaf.reshape(-1).float() for _p, leaf in leaves]))
    del entries, chunks, entry
    assert not cudart.ranges and not cudart.pages
    assert mr.locked_chunk_bytes()[0] == base


def _no_assembler() -> bool:
    return not any(t.name == "tpusc-chunk-assembler" and t.is_alive()
                   for t in threading.enumerate())


@pytest.mark.parametrize("side", ["assembler", "copy"])
@pytest.mark.parametrize("at", [0, 2, 6])
def test_midstream_failure_leaves_nothing_behind(store, monkeypatch, side, at):
    """A chunk assembly (or a chunk's copy) that raises at chunk ``at``:
    no resident model, no tier entry, no live assembler thread; a later
    load on the same runtime succeeds and predicts as a clean one."""
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    m = _model(store, "transformer_lm")
    assert len(mr._pack_plan(mr._flatten_for_pack(treg.load_artifact(m.path)[1])[2])) > 6
    seen = []
    real_fill, real_land = mr._fill_chunk, mr._ChunkCopier.land

    def fill(buf, arrs, chunk):
        seen.append(chunk)
        if len(seen) == at + 1:
            raise OSError("the disk went away mid-read")
        real_fill(buf, arrs, chunk)

    def land(self, buf):
        seen.append(buf)
        if len(seen) == at + 1:
            raise RuntimeError("the copy failed")
        return real_land(self, buf)

    if side == "assembler":
        monkeypatch.setattr(mr, "_fill_chunk", fill)
    else:
        monkeypatch.setattr(mr._ChunkCopier, "land", land)
    rt = mr.TorchModelRuntime(ServingConfig(), device="cpu", host_tier_bytes=1 << 24)
    clean = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        with pytest.raises(RuntimeError_, match="failed to load"):
            rt.ensure_loaded(m)
        assert not rt.is_loaded(m.identifier) and rt.resident_models() == []
        assert not rt.host_tier_contains(m.identifier) and len(rt._host_tier) == 0
        assert not rt._assemblers and _no_assembler()
        monkeypatch.undo()
        monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
        assert rt.ensure_loaded(m) == "disk"
        assert rt.host_tier_contains(m.identifier)
        clean.ensure_loaded(m)
        x = FAMILIES["transformer_lm"][1]()
        np.testing.assert_array_equal(rt.predict(m.identifier, x)["last_token_logits"],
                                      clean.predict(m.identifier, x)["last_token_logits"])
    finally:
        rt.close()
        clean.close()
    assert _no_assembler()


def _names(span: dict) -> list[str]:
    return [c["name"] for c in span.get("children", [])]


def test_load_spans_and_stage_metrics(store, monkeypatch):
    """The load span's children are the reference's stage names: the
    pipelined load reads, transfers (chunk count and bytes on the span),
    syncs and runs the warm-up forward; the serialized one syncs inside
    its transfer. Each child feeds ``tpusc_cold_stage_seconds{stage}`` and
    the load ``tpusc_cold_overlap_ratio`` (sum of stages / wall)."""
    from tfservingcache_tpu_torch.utils.metrics import Metrics

    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    m = _model(store, "transformer_lm")
    plan = mr._pack_plan(mr._flatten_for_pack(treg.load_artifact(m.path)[1])[2])
    with confined_globals():
        for pipeline, want in ((True, ["artifact_read", "device_transfer", "transfer_sync",
                                       "compile_warmup"]),
                               (False, ["artifact_read", "device_transfer", "compile_warmup"])):
            metrics = Metrics()
            rt = mr.TorchModelRuntime(ServingConfig(cold_load_pipeline=pipeline), device="cpu",
                                      metrics=metrics)
            try:
                tracing.TRACER.clear()
                rt.ensure_loaded(m)
                (load,) = tracing.TRACER.query(n=1)
            finally:
                rt.close()
            assert load["name"] == "load" and load["attrs"]["tier"] == "disk"
            assert _names(load) == want
            transfer = load["children"][1].get("attrs", {})
            if pipeline:
                assert transfer["pipelined"] and transfer["chunks"] == len(plan)
                assert transfer["bytes"] == _loaded_bytes(m)
            ratio = load["attrs"]["cold_overlap_ratio"]
            assert 0 < ratio <= 1.0 + 1e-3  # one thread: the stages run back to back
            assert sum(metrics.cold_overlap_ratio._only().counts) == 1
            for stage in want:
                assert sum(metrics.cold_stage_seconds.labels(stage).counts) == 1


def _loaded_bytes(m) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _p, leaf in treg.flatten_params(treg.load_artifact(m.path)[1]))


def test_group_runtime_keeps_the_serialized_path(store):
    """A lockstep group (``serving.mesh_fast_path`` off) neither pipelines
    nor keeps a host tier (reference tests/test_mesh_parity.py:170); a
    fast-path group does both (tests/test_torch_group_cold_path.py)."""
    rt = mr.TorchModelRuntime(ServingConfig(mesh_fast_path=False), devices=["cpu", "cpu"],
                              host_tier_bytes=1 << 24)
    try:
        assert not rt.cold_pipeline_enabled and not rt.host_tier_enabled
        assert rt._demote_thread is None
        m = _model(store, "mnist_cnn")
        assert rt.ensure_loaded(m) == "disk"
        rt.precompile_from_meta({})  # a documented no-op
        rt.unload(m.identifier)
        rt.drain_demotions()
        assert rt.ensure_loaded(m) == "disk"
    finally:
        rt.close()
