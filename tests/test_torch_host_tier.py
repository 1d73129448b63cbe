"""The port's host-RAM warm tier (tfservingcache_tpu_torch/cache/host_tier.py
and the runtime's tier surface: ``ensure_loaded`` -> "hbm" | "host" |
"disk", ``_promote``, demotion on the demote worker, ``unload_and_discard``)
against the JAX package's, on artifacts the JAX package wrote.

The same schedule of loads and evictions runs through a port cache manager
and a reference one: every step's ``tpusc_reload_source`` counts, the tier's
``keys_mru_first`` (budget overflow in LRU order), the host evictions and the
tier's byte gauge must agree, and each model's predictions must be those of
its first load, byte for byte as a REST body, and within 1e-4 of the
reference's (f32 transformer_lm, tests/test_torch_transformer_lm.py). A
retained entry's chunks must be the reference's ``build_packed_entry``
output on the same artifact, byte for byte.

Every runtime, manager and node is closed in a ``finally`` (joining the
demote worker); tiers are a few hundred KiB to a few MiB; no test waits on
the clock for a result.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskProvider
from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime import model_runtime as jmr
from tfservingcache_tpu.runtime.base import ModelNotLoadedError as JModelNotLoadedError
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.protocol import codec
from tfservingcache_tpu_torch.runtime import model_runtime as mr
from tfservingcache_tpu_torch.runtime.base import ModelNotLoadedError
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId
from tfservingcache_tpu_torch.utils.metrics import Metrics

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
NAMES = ("a", "b", "c", "d")
ENTRY_BYTES = 185472  # a TINY f32 model's packed bytes (the params)
LM_TOL = 1e-4
SMALL_CHUNK = 20000
X = {"input_ids": np.arange(1, 9, dtype=np.int32)[None]}
TIERS = ("hbm", "host", "disk", "store")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    for seed, name in enumerate(NAMES):
        jreg.export_artifact("transformer_lm", str(base), name=name, version=1, config=TINY,
                             seed=seed)
    for family in ("half_plus_two", "mnist_cnn"):
        jreg.export_artifact(family, str(base), name=family, version=1, seed=7)
    return base


def _model(store, name: str) -> Model:
    return Model(ModelId(name, 1), os.path.join(str(store), name, "1"), 0)


def _jmodel(store, name: str) -> JModel:
    return JModel(JModelId(name, 1), os.path.join(str(store), name, "1"), 0)


def _chunk_bytes(buf) -> bytes:
    if isinstance(buf, np.ndarray):
        return buf.tobytes()
    return buf.contiguous().view(torch.uint8).numpy().tobytes()


def _hold_entry(got, want, quant=None, hbm=None) -> None:
    """``quant``: the entry's expected ``quant_dtypes`` ({} unless given);
    ``hbm``: its expected device bytes (``want.hbm_bytes`` unless given)."""
    assert [list(c) for c, _ in got.chunks] == [list(c) for c, _ in want.chunks]
    assert got.nbytes == want.nbytes
    assert got.hbm_bytes == (want.hbm_bytes if hbm is None else hbm)
    assert got.owner == want.owner and got.paths == want.paths
    assert [tuple(s) for s in got.shapes] == [tuple(s) for s in want.shapes]
    assert got.quant_dtypes == want.quant_dtypes == (quant or {})
    for (_c, g), (_c2, w) in zip(got.chunks, want.chunks):
        assert g.is_contiguous() and g._base is None  # owned, not a view
        assert _chunk_bytes(g) == _chunk_bytes(w)


@pytest.mark.parametrize("route", ["pipelined", "serialized", "demoted"])
@pytest.mark.parametrize("family", ["transformer_lm", "mnist_cnn", "half_plus_two"])
def test_entry_is_the_references_build_packed_entry(store, monkeypatch, family, route):
    """The entry a load retains (captured off the pipelined copy, packed
    from a serialized load's params, or copied back off the device by the
    demote worker) holds the reference's chunks: the same flat indices,
    bytes, shapes, owner roles and paths."""
    name = "a" if family == "transformer_lm" else family
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    monkeypatch.setattr(jmr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    path = _model(store, name).path
    model_def, host = jreg.load_artifact(path, raw_quant=True)
    want = jmr.build_packed_entry(model_def, host, None, jmr.tree_nbytes(host))
    rt = mr.TorchModelRuntime(ServingConfig(cold_load_pipeline=route != "serialized"),
                              device="cpu", host_tier_bytes=1 << 24)
    try:
        m = _model(store, name)
        assert rt.ensure_loaded(m) == "disk"
        if route == "demoted":
            rt._host_tier.remove(m.identifier)
            rt.unload(m.identifier)
            rt.drain_demotions()
        got = rt._host_tier.get(m.identifier)
        _hold_entry(got, want)
        assert got.make_module is got.model_def.make_module
    finally:
        rt.close()


QUANT_CFG = {"vocab_size": 512, "d_model": 256, "n_layers": 1, "n_heads": 4,
             "n_kv_heads": 2, "d_ff": 512, "max_seq": 64, "dtype": "bfloat16"}


@pytest.fixture(scope="module")
def qpath(tmp_path_factory):
    base = tmp_path_factory.mktemp("qstore")
    return jreg.export_artifact("transformer_lm", str(base), name="q", version=1,
                                config=QUANT_CFG, seed=2, quantize="int8")


@pytest.mark.parametrize("route", ["pipelined", "serialized", "demoted"])
def test_int8_entry_is_the_references_build_packed_entry(qpath, monkeypatch, route):
    """An int8 artifact's retained entry is the reference's
    ``build_packed_entry`` of its raw load: each quantized leaf as a ``q``
    flat tensor in an int8 chunk and a ``scale`` one in an f32 chunk, its
    bf16 dtype in ``quant_dtypes`` (embed, wq, wo, w1, w2, w3), the entry's bytes the int8 and scale
    chunks' (under half the device bytes), its device bytes the
    dequantized params' (the reference runtime's ``tree_nbytes`` after
    the dequant). A demoted model (its entry dropped, copied back off the
    device) is retained dequantized, as the device holds it."""
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK * 8)
    monkeypatch.setattr(jmr, "_PACK_CHUNK_BYTES", SMALL_CHUNK * 8)
    model_def, raw = jreg.load_artifact(qpath, raw_quant=True)
    dequantized = jreg.load_artifact(qpath)[1]
    hbm = jmr.tree_nbytes(dequantized)
    if route == "demoted":
        want = jmr.build_packed_entry(model_def, dequantized, None, hbm)
    else:
        want = jmr.build_packed_entry(model_def, raw, None, hbm)
        assert {role for _oi, role in want.owner} == {"plain", "q", "scale"}
    rt = mr.TorchModelRuntime(ServingConfig(cold_load_pipeline=route != "serialized"),
                              device="cpu", host_tier_bytes=1 << 24)
    try:
        m = Model(ModelId("q", 1), qpath, 0)
        assert rt.ensure_loaded(m) == "disk"
        if route == "demoted":
            rt._host_tier.remove(m.identifier)
            rt.unload(m.identifier)
            rt.drain_demotions()
        got = rt._host_tier.get(m.identifier)
        _hold_entry(got, want, quant=dict(want.quant_dtypes), hbm=hbm)
        if route != "demoted":
            assert len(got.quant_dtypes) == 6 and set(got.quant_dtypes.values()) == {"bfloat16"}
            assert got.nbytes < hbm / 1.8
    finally:
        rt.close()


def _port_stack(store, tmp_path, tier_bytes, disk_bytes=1 << 30, **serving):
    metrics = Metrics()
    rt = mr.TorchModelRuntime(ServingConfig(max_concurrent_models=1, **serving), device="cpu",
                              metrics=metrics, host_tier_bytes=tier_bytes)
    cache = ModelDiskCache(str(tmp_path / "port_cache"), capacity_bytes=disk_bytes)
    mgr = CacheManager(DiskModelProvider(str(store)), cache, rt, metrics=metrics)
    return mgr, rt, cache, metrics


def _ref_stack(store, tmp_path, tier_bytes, disk_bytes=1 << 30):
    metrics = JMetrics()
    rt = jmr.TPUModelRuntime(JServingConfig(platform="cpu", max_concurrent_models=1,
                                            hbm_capacity_bytes=1 << 30),
                             metrics, host_tier_bytes=tier_bytes)
    cache = JDiskCache(str(tmp_path / "ref_cache"), capacity_bytes=disk_bytes)
    mgr = JCacheManager(JDiskProvider(str(store)), cache, rt, metrics)
    return mgr, rt, cache, metrics


def _sources(port_metrics, ref_metrics) -> tuple[dict, dict]:
    got = {t: port_metrics.reload_source.labels(t).value for t in TIERS}
    want = {t: ref_metrics.reload_source.labels(t)._value.get() for t in TIERS}
    return got, want


# a -> store, b -> store (a demoted), a -> host, c -> store (b falls out of
# the 2-entry tier), d -> store (a falls out), b -> disk, a -> disk, a -> hbm,
# c -> disk: every tier of reload_source, overflow in LRU order
SCHEDULE = ("a", "b", "a", "c", "d", "b", "a", "a", "c", "d")


def _recording(runtime, returns: list):
    """``runtime.ensure_loaded``, its every return appended to ``returns``."""
    real = runtime.ensure_loaded

    def ensure_loaded(model):
        returns.append(real(model))
        return returns[-1]

    return ensure_loaded


def test_schedule_matches_the_reference(store, tmp_path):
    mgr, rt, cache, metrics = _port_stack(store, tmp_path, int(2.5 * ENTRY_BYTES))
    jmgr, jrt, jcache, jmetrics = _ref_stack(store, tmp_path, int(2.5 * ENTRY_BYTES))
    first_body: dict[str, bytes] = {}
    got_returns, want_returns = [], []
    rt.ensure_loaded = _recording(rt, got_returns)
    jrt.ensure_loaded = _recording(jrt, want_returns)
    try:
        for step, name in enumerate(SCHEDULE):
            mgr.ensure_servable(ModelId(name, 1))
            jmgr.ensure_servable(JModelId(name, 1))
            rt.drain_demotions()
            jrt.drain_demotions()
            got, want = _sources(metrics, jmetrics)
            assert got == want, (step, name)
            assert [m.name for m in rt._host_tier.keys_mru_first()] == \
                [m.name for m in jrt._host_tier.keys_mru_first()], (step, name)
            assert [m.name for m in rt.resident_models()] == [name]
            out = rt.predict(ModelId(name, 1), X)
            body = codec.encode_predict_json_bytes(out, True)
            assert first_body.setdefault(name, body) == body, (step, name)
            ref = np.asarray(jrt.predict(JModelId(name, 1), X)["last_token_logits"])
            assert np.abs(out["last_token_logits"] - ref).max() <= LM_TOL
        assert got == {"hbm": 1.0, "host": 1.0, "disk": 4.0, "store": 4.0}
        assert got_returns == want_returns
        assert got_returns.count("host") == 1 and got_returns.count("disk") == 8
        evicted = metrics.evictions.labels("host").value
        assert evicted == jmetrics.evictions.labels("host")._value.get() and evicted >= 3
        assert metrics.host_tier_bytes._only().value == rt._host_tier.total_bytes \
            == jmetrics.host_tier_bytes._value.get() == 2 * ENTRY_BYTES
    finally:
        mgr.close()
        jmgr.close()


def test_disk_eviction_discards_the_host_entry(store, tmp_path):
    """The disk tier evicting an artifact takes its host entry with it
    (``unload_and_discard``): the next request goes back to the store, on
    both sides, though the host tier had room."""
    art = sum(os.path.getsize(os.path.join(str(store), "a", "1", f))
              for f in ("params.bin", "model.json"))
    disk = int(1.5 * art)  # one artifact at a time
    mgr, rt, cache, metrics = _port_stack(store, tmp_path, 1 << 24, disk_bytes=disk)
    jmgr, jrt, jcache, jmetrics = _ref_stack(store, tmp_path, 1 << 24, disk_bytes=disk)
    try:
        for name in ("a", "b", "a", "a"):
            mgr.ensure_servable(ModelId(name, 1))
            jmgr.ensure_servable(JModelId(name, 1))
            for c, r in ((cache, rt), (jcache, jrt)):
                c.drain_evictions()
                r.drain_demotions()
            assert rt.host_tier_contains(ModelId("a", 1)) == \
                jrt.host_tier_contains(JModelId("a", 1))
            assert rt.host_tier_contains(ModelId("b", 1)) == \
                jrt.host_tier_contains(JModelId("b", 1))
        got, want = _sources(metrics, jmetrics)
        assert got == want == {"hbm": 1.0, "host": 0.0, "disk": 0.0, "store": 3.0}
        assert not rt.host_tier_contains(ModelId("b", 1))  # discarded with its artifact
    finally:
        mgr.close()
        jmgr.close()


def test_zero_budget_is_todays_behavior(store):
    """``host_tier_bytes`` 0: no tier and no demote thread; every reload
    reads the artifact, ``"host"`` never comes back."""
    m = _model(store, "a")
    rt = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        assert rt._host_tier is None and rt._demote_thread is None
        assert rt._demote_queue is None and not rt.host_tier_enabled
        assert rt.ensure_loaded(m) == "disk"
        out = rt.predict(m.identifier, X)
        rt.unload(m.identifier)
        rt.drain_demotions()  # no-op without a tier
        assert rt.ensure_loaded(m) == "disk"
        np.testing.assert_array_equal(out["last_token_logits"],
                                      rt.predict(m.identifier, X)["last_token_logits"])
        rt.unload_and_discard(m.identifier)
        assert not rt.is_loaded(m.identifier) and not rt.host_tier_contains(m.identifier)
    finally:
        rt.close()


def test_demotion_runs_on_the_worker(store):
    """A demotion that must copy a model back off the device runs on the
    demote worker: held there on an event, it blocks neither the eviction
    nor another model's load and predict. Released, it lands the model's
    entry, and the model promotes with its first predictions."""
    ma, mb = _model(store, "a"), _model(store, "b")
    rt = mr.TorchModelRuntime(ServingConfig(max_concurrent_models=2), device="cpu",
                              host_tier_bytes=1 << 24)
    release, held = threading.Event(), threading.Event()
    real_impl = rt._demote_impl

    def held_impl(mid, loaded):
        held.set()
        assert release.wait(60)
        real_impl(mid, loaded)

    try:
        rt.ensure_loaded(ma)
        want = rt.predict(ma.identifier, X)
        rt._demote_impl = held_impl
        rt._host_tier.remove(ma.identifier)  # force the copy off the device
        rt.unload(ma.identifier)
        assert held.wait(60) and not release.is_set()
        assert rt.ensure_loaded(mb) == "disk"  # a load and a predict meanwhile
        rt.predict(mb.identifier, X)
        assert not rt.host_tier_contains(ma.identifier)
        release.set()
        rt.drain_demotions()
        assert rt.host_tier_contains(ma.identifier)
        assert rt.ensure_loaded(ma) == "host"
        np.testing.assert_array_equal(rt.predict(ma.identifier, X)["last_token_logits"],
                                      want["last_token_logits"])
    finally:
        release.set()
        rt.close()
    assert not rt._demote_thread.is_alive()


def test_eviction_between_ensure_and_predict_is_the_references(store):
    """The race behind the reference's
    tests/test_host_tier.py::test_round_trip_under_concurrent_requests, made
    deterministic: under a 1-model budget, a model evicted between its
    ``ensure_loaded`` and its ``predict`` answers ModelNotLoadedError on
    both runtimes (the backends reload once and retry); its next
    ``ensure_loaded`` promotes it on both."""
    rt = mr.TorchModelRuntime(ServingConfig(max_concurrent_models=1), device="cpu",
                              host_tier_bytes=1 << 24)
    jrt = jmr.TPUModelRuntime(JServingConfig(platform="cpu", max_concurrent_models=1,
                                             hbm_capacity_bytes=1 << 30),
                              host_tier_bytes=1 << 24)
    try:
        for runtime, model, mid, err in (
                (rt, _model, ModelId, ModelNotLoadedError),
                (jrt, _jmodel, JModelId, JModelNotLoadedError)):
            assert runtime.ensure_loaded(model(store, "a")) == "disk"
            assert runtime.ensure_loaded(model(store, "b")) == "disk"  # evicts a
            with pytest.raises(err):
                runtime.predict(mid("a", 1), X)
            runtime.drain_demotions()
            assert runtime.ensure_loaded(model(store, "a")) == "host"
    finally:
        rt.close()
        jrt.close()


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def _post(url: str, body: dict) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        return resp.read()


def test_node_promotes_over_rest_and_exposes_the_tier(store, tmp_path):
    """``cache.host_tier_bytes`` on a node: the third request promotes its
    model and answers the first request's body byte for byte; the scrape
    carries the tier's families under the reference's names."""
    node = build_node(config_from_dict({
        "serving": {"max_concurrent_models": 1},
        "cache": {"base_dir": str(tmp_path / "cache"), "host_tier_bytes": 1 << 24},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    }), device="cpu")
    try:
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}"
        body = {"instances": [[5, 1, 4, 2]]}
        first = _post(f"{base}/v1/models/a/versions/1:predict", body)
        _post(f"{base}/v1/models/b/versions/1:predict", body)
        assert _post(f"{base}/v1/models/a/versions/1:predict", body) == first
        node.runtime.drain_demotions()
        text = _get(base + node.cfg.metrics.path)
        for line in ('tpusc_reload_source_total{tier="store"} 2.0',
                     'tpusc_reload_source_total{tier="host"} 1.0',
                     f"tpusc_host_tier_bytes {float(2 * ENTRY_BYTES)}",
                     "tpusc_cold_overlap_ratio_count 2.0",
                     "# HELP tpusc_host_tier_bytes_peak ",
                     'tpusc_cold_stage_seconds_count{stage="provider_fetch"} 2.0',
                     'tpusc_cold_stage_seconds_count{stage="transfer_sync"} 2.0'):
            assert line in text, line
        assert node.manager.residency_warmth(ModelId("b", 1)) == 2
    finally:
        node.close()
    assert not node.runtime._demote_thread.is_alive()
