"""The port's serving path end to end on the CPU: a ``CacheNode`` built with
``device="cpu"`` serves REST ``:predict`` (plus status and metadata) on
artifacts the JAX package exported, and its answers match the JAX model.

Small config: 2 layers, d_model 128, 4 heads / 2 KV heads, vocab 512.
Tolerances: f32 logits 1e-4; bf16 logits 2**-4 with argmax equal wherever
the top-2 margin exceeds twice the row's max |diff| (bf16 logits tie
exactly; see tests/test_torch_transformer_lm.py).
"""

import base64
import json
import os
import re
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import ModelId, ModelState

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"vocab_size": 512, "d_model": 128, "n_layers": 2, "n_heads": 4,
         "n_kv_heads": 2, "d_ff": 256}


@pytest.fixture()
def store(tmp_path):
    base = tmp_path / "store"
    jreg.export_artifact("transformer_lm", str(base), name="lm",
                         config=dict(SMALL, dtype="float32"), seed=1)
    jreg.export_artifact("transformer_lm", str(base), name="lmb",
                         config=dict(SMALL, dtype="bfloat16"), seed=2)
    return base


@contextmanager
def serving(tmp_path, store, **serving_cfg):
    cfg = config_from_dict({
        "serving": serving_cfg,
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"type": "disk", "base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    })
    node = build_node(cfg, device="cpu")
    port = node.start("127.0.0.1")
    try:
        yield node, f"http://127.0.0.1:{port}"
    finally:
        node.close()


def call(url: str, method: str = "GET", body=None, raw: bytes | None = None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def jax_last_token_logits(store, name: str, ids: np.ndarray) -> np.ndarray:
    """The reference: JAX apply on the bucket-padded ids, then the family's
    last_token_logits derived output."""
    model, params = jreg.load_artifact(str(store / name / "1"))
    b, s = ids.shape
    pb, ps = 1 << (b - 1).bit_length(), 1 << (s - 1).bit_length()
    padded = np.zeros((pb, ps), np.int32)
    padded[:b, :s] = ids
    out = jax.jit(model.apply)(params, {"input_ids": jnp.asarray(padded)})
    fn, _spec = model.derived_outputs["last_token_logits"]
    return np.asarray(fn(out, {"batch": b, "seq": s}))


def test_predict_matches_jax_f32(tmp_path, store):
    ids = np.random.default_rng(0).integers(0, 512, size=(3, 37)).astype(np.int32)
    with serving(tmp_path, store) as (_node, url):
        status, out = call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                           {"instances": ids.tolist()})
    assert status == 200
    got = np.asarray(out["predictions"], np.float32)
    want = jax_last_token_logits(store, "lm", ids)
    assert got.shape == want.shape == (3, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_predict_matches_jax_bf16(tmp_path, store):
    ids = np.random.default_rng(1).integers(0, 512, size=(4, 150)).astype(np.int32)
    with serving(tmp_path, store) as (_node, url):
        status, out = call(f"{url}/v1/models/lmb/versions/1:predict", "POST",
                           {"inputs": {"input_ids": ids.tolist()}})
    assert status == 200
    got = np.asarray(out["outputs"], np.float32)
    want = jax_last_token_logits(store, "lmb", ids)
    diff = np.abs(got - want)
    assert diff.max() <= 2.0**-4
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * diff.max(axis=-1)
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()


def test_status_and_metadata(tmp_path, store):
    with serving(tmp_path, store) as (_node, url):
        status, _ = call(f"{url}/v1/models/lm/versions/1")
        assert status == 404  # never touched: 404 by design, as the reference
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                    {"instances": [[1, 2, 3]]})[0] == 200
        status, body = call(f"{url}/v1/models/lm/versions/1")
        assert status == 200
        assert body["model_version_status"] == [
            {"version": "1", "state": "AVAILABLE",
             "status": {"error_code": "OK", "error_message": ""}}
        ]
        status, meta = call(f"{url}/v1/models/lm/versions/1/metadata")
    assert status == 200
    sig = meta["metadata"]["signature_def"]["signature_def"]["serving_default"]
    assert meta["model_spec"] == {"name": "lm", "version": "1"}
    assert sig["inputs"]["input_ids"]["dtype"] == "int32"
    assert [d["size"] for d in sig["inputs"]["input_ids"]["tensor_shape"]["dim"]] == ["-1", "-1"]
    assert set(sig["outputs"]) == {"logits", "last_token_logits"}
    assert sig["method_name"] == "tensorflow/serving/predict"


def test_rest_error_contract(tmp_path, store):
    with serving(tmp_path, store) as (_node, url):
        assert call(f"{url}/healthz") == (200, {"status": "ok"})
        # a node serves an unversioned URL at the latest version, as the
        # reference's node does; the 400 is the router's (require_version,
        # tests/test_torch_router.py)
        status, body = call(f"{url}/v1/models/lm:predict", "POST", {"instances": [[1]]})
        assert status == 200 and np.asarray(body["predictions"]).shape == (1, 512)
        assert call(f"{url}/nowhere") == (404, {"Status": "Error", "Message": "Not found"})
        assert call(f"{url}/v1/models/nope/versions/1:predict", "POST",
                    {"instances": [[1]]})[0] == 404
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST", raw=b"{not json")[0] == 400
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST", {"instances": []})[0] == 400
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                    {"instances": [[1]], "output_filter": ["nope"]})[0] == 400
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                    {"instances": [[1]], "output_encoding": "xml"})[0] == 400
        # :classify is served; an example feature the signature lacks is
        # refused by the runtime, a 500 as the reference answers it
        assert call(f"{url}/v1/models/lm/versions/1:classify", "POST",
                    {"examples": [{"x": 1}]}) == (
            500, {"error": "RuntimeError_: missing inputs ['input_ids'] for lm@1"})
        # "draft_model" is served (speculative decoding on the solo path):
        # a model may draft for itself; an unknown draft is 404
        assert call(f"{url}/v1/models/lm/versions/1:generate", "POST",
                    {"input_ids": [[1]], "draft_model": "lm"})[0] == 200
        assert call(f"{url}/v1/models/lm/versions/1:generate", "POST",
                    {"input_ids": [[1]], "draft_model": "ghost"})[0] == 404


def test_rest_server_listens_with_the_references_backlog(tmp_path, store):
    """The stdlib server's listen backlog is the reference's (aiohttp's
    ``TCPSite`` default, 128), not socketserver's 5: with 16 concurrent
    clients the smaller queue dropped connects, which waited a second for
    their retry. 32 concurrent requests all answer."""
    import inspect
    from concurrent.futures import ThreadPoolExecutor

    from aiohttp.web_runner import TCPSite

    want = inspect.signature(TCPSite.__init__).parameters["backlog"].default
    with serving(tmp_path, store) as (node, url):
        assert node.rest._httpd.request_queue_size == want == 128
        with ThreadPoolExecutor(32) as pool:
            got = list(pool.map(lambda _i: call(f"{url}/healthz"), range(32)))
    assert got == [(200, {"status": "ok"})] * 32


def test_output_filter_and_base64_encoding(tmp_path, store):
    ids = np.random.default_rng(2).integers(0, 512, size=(2, 5)).astype(np.int32)
    with serving(tmp_path, store) as (_node, url):
        status, full = call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                            {"inputs": ids.tolist(), "output_filter": ["logits"]})
        assert status == 200
        logits = np.asarray(full["outputs"], np.float32)
        assert logits.shape == (2, 5, 512)  # un-padded from the (2, 8) bucket
        status, b64 = call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                           {"inputs": ids.tolist(), "output_encoding": "base64"})
    assert status == 200
    enc = b64["outputs"]
    last = np.frombuffer(base64.b64decode(enc["b64"]), dtype=enc["dtype"]).reshape(enc["shape"])
    np.testing.assert_array_equal(last, logits[:, -1, :])


def test_resident_lru_evicts_past_max_concurrent_models(tmp_path, store):
    with serving(tmp_path, store, max_concurrent_models=1) as (node, url):
        for name in ("lm", "lmb", "lm"):
            assert call(f"{url}/v1/models/{name}/versions/1:predict", "POST",
                        {"instances": [[5, 6]]})[0] == 200
        rt = node.runtime
        assert rt.resident_models() == [ModelId("lm", 1)]
        assert rt.state(ModelId("lmb", 1)) == ModelState.END
        assert rt.state(ModelId("lm", 1)) == ModelState.AVAILABLE


def test_disk_eviction_unloads_the_model(tmp_path, store):
    size = sum(f.stat().st_size for f in (store / "lm" / "1").iterdir())
    cfg = config_from_dict({
        "cache": {"base_dir": str(tmp_path / "cache"), "disk_capacity_bytes": int(size * 1.5)},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    })
    node = build_node(cfg, device="cpu")
    try:
        mgr = node.manager
        mgr.ensure_servable(ModelId("lm", 1))
        mgr.ensure_servable(ModelId("lmb", 1))  # bf16: half the bytes, still evicts lm
        node.disk_cache.drain_evictions()
        assert mgr.list_cached() == [ModelId("lmb", 1)]
        assert not node.runtime.is_loaded(ModelId("lm", 1))
        assert not (tmp_path / "cache" / "lm" / "1").exists()
    finally:
        node.close()


def test_runtime_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError_, match="device='cpu'"):
        TorchModelRuntime()
    with pytest.raises(RuntimeError_, match="CUDA is not available"):
        build_node(config_from_dict({}))  # serving.device defaults to "cuda"
    assert TorchModelRuntime(device="cpu").device.type == "cpu"


def test_port_serves_without_importing_jax(tmp_path):
    """The port's whole serving path — ``:predict``, ``:generate`` on the
    continuous paged engine with speculative rounds, a solo
    ``"draft_model"`` request, a streamed answer, a conversation parked and
    resumed, chunked prefill, shared-prefix pages and the
    solo prefix cache, the batchers on a ``batch_window_ms`` node over the
    native host tier, a model promoted from the host RAM tier, and a ring
    ``:predict`` on a node whose
    runtime is bound to a 4-copy CPU group — and a scrape of the node's
    metrics and monitoring endpoints, in a fresh interpreter (this test
    process has JAX loaded by the harness): neither ``jax`` nor the JAX
    package, nor ``prometheus_client`` or ``aiohttp``, may enter
    ``sys.modules``; nor may they with the peer wire's model half and the
    peer and object-store providers imported and a tier entry streamed
    through the wire, nor with an int8 artifact loaded, promoted and its
    entry streamed, nor with a moe_lm model served (``:predict``, greedy
    ``:generate`` and a moe_lm draft's speculative ``:generate``, all on the
    solo path of a continuous node), nor with bert (``:predict`` at its
    capped seq bucket, ``:classify``) and resnet (``:predict``) built and
    served, nor with a t5 exported, repacked and warmed through ``cli`` and
    served (``:predict``). ``jax``, ``jaxlib`` and ``flax`` are unimportable
    in the subprocess from its first line."""
    script = textwrap.dedent(f"""
        import json, sys, urllib.request

        class RefuseJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax"):
                    raise ModuleNotFoundError(f"{{name}} is unimportable here")
                return None

        sys.meta_path.insert(0, RefuseJax())
        sys.path.insert(0, {str(ROOT)!r})
        from tfservingcache_tpu_torch.config import config_from_dict
        from tfservingcache_tpu_torch.models import registry
        from tfservingcache_tpu_torch.server import build_node
        store = {str(tmp_path / "store")!r}
        registry.export_artifact("transformer_lm", store, name="lm",
                                 config={dict(SMALL, dtype="bfloat16")!r}, device="cpu")
        registry.export_artifact("transformer_lm", store, name="dr",
                                 config={dict(SMALL, n_layers=1, dtype="bfloat16")!r},
                                 device="cpu")
        cfg = config_from_dict({{"serving": {{"generate_engine": "continuous",
                                             "kv_page_tokens": 16,
                                             "spec_draft_model": "dr",
                                             "conversation_kv_bytes": 1 << 24,
                                             "conversation_kv_dir":
                                                 {str(tmp_path / "conv_kv")!r}}},
                                "cache": {{"base_dir": {str(tmp_path / "cache")!r}}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        port = node.start("127.0.0.1")
        req = urllib.request.Request(
            f"http://127.0.0.1:{{port}}/v1/models/lm/versions/1:predict",
            data=json.dumps({{"instances": [[1, 2, 3]]}}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            assert len(json.loads(resp.read())["predictions"][0]) == 512
        req = urllib.request.Request(
            f"http://127.0.0.1:{{port}}/v1/models/lm/versions/1:generate",
            data=json.dumps({{"input_ids": [[1, 2, 3]], "max_new_tokens": 4}}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            assert len(json.loads(resp.read())["tokens"][0]) == 4
        assert node.engine.admitted == 1  # the continuous paged engine served it
        assert node.engine.spec_rounds > 0  # in speculative rounds with the draft
        req = urllib.request.Request(
            f"http://127.0.0.1:{{port}}/v1/models/lm/versions/1:generate",
            data=json.dumps({{"input_ids": [[1, 2, 3]], "max_new_tokens": 4,
                              "draft_model": "dr"}}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:  # the solo spec path
            assert resp.status == 200
            assert len(json.loads(resp.read())["tokens"][0]) == 4
        assert "tfservingcache_tpu_torch.models.speculative" in sys.modules
        # a streamed answer (SSE over chunked transfer), then a two-turn
        # conversation parked in and resumed from the conversation tier
        url = f"http://127.0.0.1:{{port}}/v1/models/lm/versions/1:generate"
        req = urllib.request.Request(
            url + "?stream=true",
            data=json.dumps({{"input_ids": [[1, 2, 3]], "max_new_tokens": 4}}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            frames = [json.loads(line[6:]) for line in resp.read().split(b"\\n")
                      if line.startswith(b"data: ")]
        assert len(frames) == 5 and frames[-1]["done"], frames
        turn = [1, 2, 3, 4, 5]
        for _ in range(2):
            req = urllib.request.Request(url, data=json.dumps({{
                "input_ids": [turn], "max_new_tokens": 4, "conversation_id": "c"}}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                turn = turn + json.loads(resp.read())["tokens"][0] + [6]
        assert node.engine.parks == 2 and node.engine.resumes == 1, vars(node.engine)
        for mod in ("cache.conversation_kv", "lab.faults"):
            assert "tfservingcache_tpu_torch." + mod in sys.modules
        base = f"http://127.0.0.1:{{port}}"
        with urllib.request.urlopen(base + "/monitoring/prometheus/metrics", timeout=60) as resp:
            text = resp.read().decode()
        assert 'tfservingcache_proxy_requests_total{{protocol="rest"}} 6.0' in text, text
        assert 'tpusc_kv_resume_total{{outcome="hit"}} 1.0' in text
        assert "tpusc_gen_kv_pages_used 0.0" in text
        for path in ("/monitoring/engine?reset=0", "/monitoring/traces", "/monitoring/tenants"):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                assert resp.status == 200 and json.loads(resp.read())
        node.close()
        # the KV-reuse knobs: chunked prefill, shared-prefix pages, the solo
        # path's prefix cache
        cfg = config_from_dict({{"serving": {{"generate_engine": "continuous",
                                             "kv_page_tokens": 4,
                                             "prefill_chunk_tokens": 4,
                                             "kv_share_prefix_bytes": 1 << 20,
                                             "prefix_cache_bytes": 1 << 24}},
                                "cache": {{"base_dir": {str(tmp_path / "cache_kv")!r}}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        port = node.start("127.0.0.1")
        url = f"http://127.0.0.1:{{port}}/v1/models/lm/versions/1:generate"
        for body in ({{"input_ids": [list(range(1, 12))], "max_new_tokens": 4}},) * 2 + (
                {{"input_ids": [list(range(1, 20))], "max_new_tokens": 4, "seed": 1}},
                {{"input_ids": [list(range(1, 30))], "max_new_tokens": 4, "seed": 1}}):
            req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
                assert len(json.loads(resp.read())["tokens"][0]) == 4
        eng = node.engine
        assert eng.prefill_chunks == 3 and eng.prefix_hits_exact == 1, vars(eng)
        assert node.runtime._prefix_cache.hits == 1  # the second seeded (solo) request
        node.close()
        # the batchers (batch_window_ms > 0) and the native host tier: a
        # 70-token body the native parser extracts, a native-encoded reply
        cfg = config_from_dict({{"serving": {{"batch_window_ms": 1}},
                                "cache": {{"base_dir": {str(tmp_path / "cache_batch")!r}}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        port = node.start("127.0.0.1")
        for verb, body in (("predict", {{"instances": [list(range(1, 71))]}}),
                           ("generate", {{"input_ids": [list(range(1, 71))],
                                          "max_new_tokens": 4}})):
            req = urllib.request.Request(
                f"http://127.0.0.1:{{port}}/v1/models/lm/versions/1:{{verb}}",
                data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200 and json.loads(resp.read())
        from tfservingcache_tpu_torch import native
        from tfservingcache_tpu_torch.runtime.batcher import GenerateCoalescer, MicroBatcher
        assert native.active_path() == "native"
        assert isinstance(node.backend._predictor, MicroBatcher)
        assert isinstance(node.backend._generator, GenerateCoalescer)
        assert type(node.disk_cache.lru).__name__ == "NativeLRUCache"
        node.close()
        # the host tier: one resident model, so the third request promotes
        # "lm" from its packed chunks (a pipelined load retained them)
        cfg = config_from_dict({{"serving": {{"max_concurrent_models": 1}},
                                "cache": {{"base_dir": {str(tmp_path / "cache_tier")!r},
                                          "host_tier_bytes": 1 << 26}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        port = node.start("127.0.0.1")
        bodies = []
        for name in ("lm", "dr", "lm"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{{port}}/v1/models/{{name}}/versions/1:predict",
                data=json.dumps({{"instances": [[1, 2, 3]]}}).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
                bodies.append(resp.read())
        assert bodies[2] == bodies[0]
        assert node.metrics.reload_source.labels("host").value == 1
        assert "tfservingcache_tpu_torch.cache.host_tier" in sys.modules
        # an int8 artifact the port wrote: loaded raw and dequantized on the
        # device, retained as int8 chunks, promoted with the same reply
        from tfservingcache_tpu_torch.types import ModelId
        registry.export_artifact("transformer_lm", store, name="lmq",
                                 config={dict(SMALL, dtype="bfloat16")!r}, device="cpu",
                                 quantize="int8")
        qbodies = []
        for name in ("lmq", "lm", "lmq"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{{port}}/v1/models/{{name}}/versions/1:predict",
                data=json.dumps({{"instances": [[1, 2, 3]]}}).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
                qbodies.append(resp.read())
        assert qbodies[2] == qbodies[0]
        assert node.metrics.reload_source.labels("host").value == 3
        qentry = node.runtime._host_tier.get(ModelId("lmq", 1))
        assert qentry.quant_dtypes == {{0: "bfloat16"}}
        # the model half of the peer wire: the tier's entry streamed into a
        # receiver and rebuilt, and the object-store and peer providers
        from tfservingcache_tpu_torch.cache.providers import azblob, gcs, peer, s3
        from tfservingcache_tpu_torch.protocol import peer_transfer
        assert isinstance(node.manager.provider, peer.PeerProvider)
        for i, entry in enumerate((node.runtime._host_tier.get(ModelId("lm", 1)), qentry)):
            rx = peer_transfer.PeerStreamReceiver({str(tmp_path / "peer_rx")!r} + str(i),
                                                  assemble=True)
            kinds = [rx.feed(f) for f in peer_transfer.iter_frames(entry, 1 << 16)]
            rx.close()
            rebuilt = rx.build_entry()
            assert kinds[-1] == "end" and rebuilt.nbytes == entry.nbytes
            assert rebuilt.quant_dtypes == entry.quant_dtypes
        for mod in ("cache.providers.peer", "cache.providers.s3", "cache.providers.gcs",
                    "cache.providers.azblob", "cache.providers.object_store"):
            assert "tfservingcache_tpu_torch." + mod in sys.modules
        node.close()
        registry.export_artifact("transformer_lm", store, name="ring",
                                 config={dict(SMALL, n_kv_heads=4, dtype="bfloat16",
                                              attention="ring")!r}, device="cpu")
        from tfservingcache_tpu_torch.parallel import ring_attention
        hops = []
        real_carry = ring_attention.attention_carry
        ring_attention.attention_carry = lambda *a: hops.append(a[6]) or real_carry(*a)
        cfg = config_from_dict({{"mesh": {{"chips_per_group": 4}},
                                "cache": {{"base_dir": {str(tmp_path / "cache_ring")!r}}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        port = node.start("127.0.0.1")
        req = urllib.request.Request(
            f"http://127.0.0.1:{{port}}/v1/models/ring/versions/1:predict",
            data=json.dumps({{"instances": [list(range(1, 9))]}}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            assert len(json.loads(resp.read())["predictions"][0]) == 512
        assert len(hops) == 2 * 16  # 2 layers x 4^2 ring hops
        node.close()
        moe_cfg = {{"vocab_size": 512, "d_model": 64, "n_layers": 2, "n_heads": 2,
                    "n_kv_heads": 2, "d_ff": 64, "n_experts": 4}}
        registry.export_artifact("moe_lm", store, name="moe", config=moe_cfg, device="cpu")
        registry.export_artifact("moe_lm", store, name="moedr",
                                 config=dict(moe_cfg, n_layers=1), device="cpu")
        cfg = config_from_dict({{"serving": {{"generate_engine": "continuous",
                                             "kv_page_tokens": 16}},
                                "cache": {{"base_dir": {str(tmp_path / "cache_moe")!r}}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        base = f"http://127.0.0.1:{{node.start('127.0.0.1')}}/v1/models/moe/versions/1"
        for verb, body in (("predict", {{"instances": [[1, 2, 3]]}}),
                           ("generate", {{"input_ids": [[1, 2, 3]], "max_new_tokens": 4}}),
                           ("generate", {{"input_ids": [[1, 2, 3]], "max_new_tokens": 4,
                                          "draft_model": "moedr"}})):
            req = urllib.request.Request(f"{{base}}:{{verb}}", data=json.dumps(body).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200 and json.loads(resp.read())
        assert node.engine.admitted == 0  # moe_lm never takes the continuous engine
        assert "tfservingcache_tpu_torch.models.moe_lm" in sys.modules
        node.close()
        registry.export_artifact("bert", store, name="bert",
                                 config={{"vocab_size": 128, "hidden": 32, "n_layers": 1,
                                          "n_heads": 2, "d_ff": 64, "max_seq": 24,
                                          "num_labels": 2}}, device="cpu")
        registry.export_artifact("resnet", store, name="resnet",
                                 config={{"depth": 18, "width": 8, "image_size": 16,
                                          "num_classes": 5}}, device="cpu")
        import os
        from tfservingcache_tpu_torch import cli
        os.environ["TPUSC_SERVING_DEVICE"] = "cpu"
        t5_cfg = {{"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 2, "d_ff": 64,
                   "rel_buckets": 8, "rel_max_dist": 32}}
        assert cli.main(["export", "t5", store, "--name", "t5",
                         "--config-json", json.dumps(t5_cfg)]) == 0
        assert cli.main(["repack", store + "/t5/1", store + "/t5/2"]) == 0
        assert cli.main(["warm", store + "/t5/2", "--batches", "1,2", "--lm-seq", "16"]) == 0
        cfg = config_from_dict({{"serving": {{"max_concurrent_models": 1}},
                                "cache": {{"base_dir": {str(tmp_path / "cache_zoo")!r}}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        base = f"http://127.0.0.1:{{node.start('127.0.0.1')}}/v1/models"
        row = {{"input_ids": list(range(1, 21)), "attention_mask": [1] * 20}}  # pads to 24
        for path, body, key in (
                ("bert/versions/1:predict", {{"instances": [row]}}, "predictions"),
                ("bert/versions/1:classify", {{"examples": [row, row]}}, "results"),
                ("resnet/versions/1:predict", {{"instances": [[[[0.5] * 3] * 16] * 16]}},
                 "predictions"),
                ("t5/versions/2:predict", {{"inputs": {{"input_ids": [[5, 6, 7, 0]],
                                                       "decoder_input_ids": [[1, 2, 3]]}}}},
                 "outputs")):
            req = urllib.request.Request(f"{{base}}/{{path}}", data=json.dumps(body).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200 and json.loads(resp.read())[key]
        for mod in ("bert", "resnet", "t5"):
            assert "tfservingcache_tpu_torch.models." + mod in sys.modules
        node.close()
        banned = ("jax", "tfservingcache_tpu", "prometheus_client", "aiohttp")
        bad = sorted(m for m in sys.modules
                     if m in banned or m.startswith(tuple(b + "." for b in banned)))
        print("FORBIDDEN", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FORBIDDEN []" in r.stdout


def test_port_serves_rest_without_grpc_or_protobuf(tmp_path):
    """With ``grpc`` and ``google.protobuf`` made unimportable (a meta-path
    finder refuses them, as on a machine without ``grpcio`` and
    ``protobuf``), the port's server, REST server, backend and codec
    import; ``build_node`` logs one line naming the missing package, leaves
    ``grpc_port`` None, and the node serves REST ``:predict``,
    ``/labels/`` and ``:regress``."""
    script = textwrap.dedent(f"""
        import importlib.abc, json, logging, sys, urllib.request
        sys.path.insert(0, {str(ROOT)!r})

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name in ("grpc", "google.protobuf") or name.startswith(
                        ("grpc.", "google.protobuf.")):
                    raise ModuleNotFoundError(f"No module named {{name!r}}", name=name)
                return None

        sys.meta_path.insert(0, Refuse())
        logging.basicConfig(level=logging.WARNING, stream=sys.stdout, format="LOG %(message)s")
        from tfservingcache_tpu_torch.protocol import codec, local_backend, rest  # noqa: F401
        from tfservingcache_tpu_torch.config import config_from_dict
        from tfservingcache_tpu_torch.models import registry
        from tfservingcache_tpu_torch.server import build_node
        store = {str(tmp_path / "store")!r}
        registry.export_artifact("transformer_lm", store, name="lm",
                                 config={dict(SMALL, dtype="bfloat16")!r}, device="cpu")
        registry.export_artifact("half_plus_two", store, name="hpt", device="cpu")
        cfg = config_from_dict({{"serving": {{"version_labels": {{"hpt": {{"stable": 1}}}}}},
                                "cache": {{"base_dir": {str(tmp_path / "cache")!r}}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        port = node.start("127.0.0.1")
        try:
            assert node.grpc is None and node.grpc_port is None
            def post(path, body):
                req = urllib.request.Request(f"http://127.0.0.1:{{port}}/v1/models/" + path,
                                             data=json.dumps(body).encode(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    assert resp.status == 200
                    return json.loads(resp.read())
            assert len(post("lm/versions/1:predict", {{"instances": [[1, 2, 3]]}})[
                "predictions"][0]) == 512
            assert post("hpt/labels/stable:predict", {{"instances": [2.0]}}) == {{
                "predictions": [3.0]}}
            assert post("hpt/versions/1:regress", {{"examples": [{{"x": 4.0}}]}}) == {{
                "results": [4.0]}}
        finally:
            node.close()
        bad = sorted(m for m in sys.modules if m == "grpc" or m.startswith(
            ("grpc.", "google.protobuf")))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout
    off = [line for line in r.stdout.splitlines() if "gRPC surface off" in line]
    assert len(off) == 1 and "'grpc'" in off[0], r.stdout


def test_cli_serve_answers_and_stops_on_sigterm(tmp_path, store):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg_path = tmp_path / "node.json"
    cfg_path.write_text(json.dumps({
        "serving": {"device": "cpu"},
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": port, "grpc_port": 0},
        "observability": {"flight_dir": str(tmp_path / "flight")},
        "logging": {"fmt": "json"},
    }))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfservingcache_tpu_torch.cli", "serve", "--config", str(cfg_path)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if call(f"http://127.0.0.1:{port}/healthz")[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
            time.sleep(0.2)
        status, out = call(f"http://127.0.0.1:{port}/v1/models/lm/versions/1:predict", "POST",
                           {"instances": [[3, 1, 4, 1, 5]]})
        assert status == 200 and np.asarray(out["predictions"]).shape == (1, 512)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert rc == 0
    # logging.fmt json: one JSON object a line
    lines = [json.loads(line) for line in proc.stdout.read().splitlines() if line.startswith("{")]
    assert any(rec["logger"] == "tpusc_torch.cli" and rec["level"] == "info" for rec in lines)


def test_profiler_capture_writes_a_chrome_trace(tmp_path):
    """``POST /monitoring/profiler`` takes a real ``torch.profiler`` capture
    (CPU activity here) into ``<base>/<label>/``, in a fresh interpreter
    with a timeout of its own: the capture's native state stays out of the
    test process."""
    script = textwrap.dedent(f"""
        import json, os, sys, urllib.request
        sys.path.insert(0, {str(ROOT)!r})
        from tfservingcache_tpu_torch.config import config_from_dict
        from tfservingcache_tpu_torch.server import build_node
        cfg = config_from_dict({{"cache": {{"base_dir": {str(tmp_path / "cache")!r}}},
                                "model_provider": {{"base_dir": {str(tmp_path)!r}}},
                                "cache_node": {{"rest_port": 0, "grpc_port": 0}}}})
        node = build_node(cfg, device="cpu")
        node.rest.profiler_base_dir = {str(tmp_path / "profiles")!r}
        port = node.start("127.0.0.1")
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{{port}}/monitoring/profiler?duration_s=0.2&label=cpu",
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                body = json.loads(resp.read())
            print("ANSWER", json.dumps(body))
        finally:
            node.close()
    """)
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    body = json.loads(r.stdout.split("ANSWER ", 1)[1])
    assert body["status"] == "ok" and body["dir"] == str(tmp_path / "profiles" / "cpu")
    assert os.path.dirname(body["trace"]) == body["dir"]
    with open(body["trace"]) as fh:
        assert "traceEvents" in json.load(fh)


def _post_raw(url: str, body: dict) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        return resp.read()


def _reference_bodies(tmp_path, store, verb: str, bodies: list) -> list[bytes]:
    """The reference node's REST answers to ``bodies`` on "lmb", all in
    flight at once: its ``LocalServingBackend`` with ``batch_window_ms`` 1
    over a CPU runtime."""
    import asyncio

    from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
    from tfservingcache_tpu.cache.manager import CacheManager as JManager
    from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JProvider
    from tfservingcache_tpu.config import ServingConfig as JServingConfig
    from tfservingcache_tpu.protocol.local_backend import LocalServingBackend as JBackend
    from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime

    mgr = JManager(JProvider(str(store)),
                   JDiskCache(str(tmp_path / "ref_cache"), capacity_bytes=1 << 30),
                   TPUModelRuntime(JServingConfig(platform="cpu")))
    backend = JBackend(mgr, batch_window_ms=1.0)

    async def main():
        return await asyncio.gather(*(
            backend.handle_rest("POST", "lmb", 1, verb, json.dumps(b).encode())
            for b in bodies))

    try:
        return [r.body for r in asyncio.run(main())]
    finally:
        backend.close()
        mgr.close()


def _gated_port_bodies(node, url: str, method: str, kind: str, bodies: list,
                       inflight: int) -> list[bytes]:
    """POST every body at once to a port node whose runtime ``method``
    blocks until ``inflight`` batches are inside it and every other request
    is queued behind them (the node's batcher queue-depth gauge): the rest
    must then coalesce. -> the reply bodies in order."""
    from concurrent.futures import ThreadPoolExecutor

    gate, lock, entered = threading.Event(), threading.Lock(), [0, 0]
    real = getattr(node.runtime, method)

    def gated(model_id, input_ids, *a, **kw):
        with lock:
            entered[0] += 1
            entered[1] += int(np.asarray(input_ids["input_ids"] if isinstance(input_ids, dict)
                                         else input_ids).shape[0])
        assert gate.wait(120)
        return real(model_id, input_ids, *a, **kw)

    setattr(node.runtime, method, gated)  # shadows the method for this node
    depth = node.metrics.batcher_queue_depth.labels(kind)
    try:
        with ThreadPoolExecutor(len(bodies)) as pool:
            futs = [pool.submit(_post_raw, url, b) for b in bodies]
            deadline = time.monotonic() + 120
            while not (entered[0] == inflight and entered[1] + depth.value == len(bodies)):
                assert time.monotonic() < deadline, (entered, depth.value)
                time.sleep(0.001)
            gate.set()
            return [f.result() for f in futs]
    finally:
        gate.set()
        delattr(node.runtime, method)


_NUM = re.compile(rb"-?(?:[0-9][0-9.eE+-]*|Infinity)|NaN")


def _same_text_where_equal(port_body: bytes, ref_body: bytes) -> int:
    """The bodies have one envelope, and every number whose f32 value is the
    same in both is the same text. -> how many numbers were equal."""
    assert _NUM.sub(b"#", port_body) == _NUM.sub(b"#", ref_body)
    equal = 0
    for p, r in zip(_NUM.findall(port_body), _NUM.findall(ref_body)):
        if np.float32(float(p)) == np.float32(float(r)):
            assert p == r
            equal += 1
    return equal


def test_batching_nodes_answer_like_the_reference(tmp_path, store):
    """A port node and a reference node, both with ``batch_window_ms`` 1,
    serve the bf16 artifact. Concurrent ``:predict`` requests coalesce on
    the port (its runtime held until 4 batches are inside and the rest
    queue) and answer within 2**-4 of the reference, argmax equal off
    near-ties; concurrent greedy ``:generate`` requests of one bucket
    coalesce into one solo-path generate and emit the reference's tokens up
    to bf16 near-ties. Every reply's text equals the reference's wherever
    the values are equal, and is the reference codec's encoding of the
    port's own outputs byte for byte."""
    from tfservingcache_tpu.protocol import codec as jcodec

    rng = np.random.default_rng(5)
    predict = [{"instances": rng.integers(0, 512, (1, 80)).tolist()} for _ in range(8)]
    generate = [{"input_ids": [rng.integers(1, 512, int(n)).tolist()], "max_new_tokens": 6}
                for n in rng.integers(17, 33, 8)]  # one seq bucket (32)
    with serving(tmp_path, store, batch_window_ms=1) as (node, url):
        base = f"{url}/v1/models/lmb/versions/1"
        _post_raw(base + ":predict", predict[0])  # cold load outside the gated window
        port_pred = _gated_port_bodies(node, base + ":predict", "predict", "predict",
                                       predict, inflight=4)
        port_gen = _gated_port_bodies(node, base + ":generate", "generate", "generate",
                                      generate, inflight=2)
        mb, gc = node.backend._predictor, node.backend._generator
        assert mb.batches >= 1 and gc.batches >= 1
        scrape = node.metrics.render().decode()
    assert f'tpusc_coalesced_requests_total{{kind="generate"}} {float(gc.batched_requests)}' in scrape
    ref_pred = _reference_bodies(tmp_path, store, "predict", predict)
    ref_gen = _reference_bodies(tmp_path, store, "generate", generate)

    equal = 0
    for pb, rb in zip(port_pred, ref_pred):
        got = np.asarray(json.loads(pb)["predictions"], np.float32)
        want = np.asarray(json.loads(rb)["predictions"], np.float32)
        diff = np.abs(got - want)
        assert got.shape == want.shape == (1, 512) and diff.max() <= 2.0**-4
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * diff.max(axis=-1)
        assert (got.argmax(-1) == want.argmax(-1))[decided].all()
        assert jcodec.encode_predict_json_bytes({"last_token_logits": got}, True) == pb
        equal += _same_text_where_equal(pb, rb)
    assert equal  # some logits are the same value in both, and the same text

    model, params = jreg.load_artifact(str(store / "lmb" / "1"))
    for body, pb, rb in zip(generate, port_gen, ref_gen):
        got, want = json.loads(pb)["tokens"][0], json.loads(rb)["tokens"][0]
        if got == want:
            assert pb == rb
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = np.asarray([body["input_ids"][0] + want[:i]], np.int32)
        logits = np.asarray(model.apply(params, {"input_ids": jnp.asarray(seq)})["logits"])[0, -1]
        top = logits.max()
        assert top - logits[got[i]] <= 2.0**-3 and top - logits[want[i]] <= 2.0**-3, (
            f"generate diverges at token {i} off a near-tie")


def test_manager_versions_health_and_stale_reload(tmp_path, store):
    jreg.export_artifact("transformer_lm", str(store), name="lm", version=3,
                         config=dict(SMALL, dtype="float32"), seed=7)
    cfg = config_from_dict({
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    })
    node = build_node(cfg, device="cpu")
    try:
        mgr, mid = node.manager, ModelId("lm", 3)
        assert mgr.available_versions("lm") == [1, 3]
        assert mgr.resolve_version("lm", None) == 3
        assert mgr.is_healthy() and node.is_healthy()
        mgr.ensure_servable(mid)
        node.runtime.unload(mid)
        assert node.runtime.state(mid) == ModelState.END

        def no_refetch(*_a, **_k):
            raise AssertionError("a STALE model must reload from the disk cache")

        node.provider.load_model = no_refetch
        mgr.ensure_servable(mid)
        assert node.runtime.is_loaded(mid)
        assert mgr.resolve_version("lm", None) == 3  # the resident version
    finally:
        node.close()


def test_concurrent_cold_requests_share_one_load(tmp_path, store):
    import threading

    with serving(tmp_path, store) as (node, url):
        loads = []
        real_load = node.runtime._load
        node.runtime._load = lambda model: (loads.append(model.identifier), real_load(model))[1]
        results = []

        def hit():
            results.append(call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                                {"instances": [[1, 2, 3, 4]]}))

        threads = [threading.Thread(target=hit) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert [r[0] for r in results] == [200] * 6
    assert loads == [ModelId("lm", 1)]
    first = np.asarray(results[0][1]["predictions"])
    for _status, body in results[1:]:
        np.testing.assert_array_equal(np.asarray(body["predictions"]), first)


def test_config_from_json_file_and_unknown_keys(tmp_path, caplog):
    from tfservingcache_tpu_torch.config import load_config

    path = tmp_path / "node.json"
    path.write_text(json.dumps({
        "serving": {"max_concurrent_models": 3, "load_timeout_s": 5, "device": "cpu"},
        "cache": {"disk_capacity_bytes": 1234},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
        "bogus": 1,
    }))
    with caplog.at_level("WARNING"):
        cfg = load_config(str(path))
    assert cfg.serving.max_concurrent_models == 3
    assert cfg.serving.load_timeout_s == 5.0 and isinstance(cfg.serving.load_timeout_s, float)
    assert cfg.serving.device == "cpu" and cfg.cache.disk_capacity_bytes == 1234
    assert cfg.cache_node.rest_port == 0
    assert "bogus" in caplog.text
    assert load_config(None).serving.device == "cuda"
