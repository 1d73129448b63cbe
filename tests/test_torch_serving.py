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
import signal
import socket
import subprocess
import sys
import textwrap
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
        "cache_node": {"rest_port": 0},
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
        assert call(f"{url}/v1/models/lm:predict", "POST", {"instances": [[1]]}) == (
            400, {"Status": "Error", "Message": "Model version must be provided"})
        assert call(f"{url}/nowhere") == (404, {"Status": "Error", "Message": "Not found"})
        assert call(f"{url}/v1/models/nope/versions/1:predict", "POST",
                    {"instances": [[1]]})[0] == 404
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST", raw=b"{not json")[0] == 400
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST", {"instances": []})[0] == 400
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                    {"instances": [[1]], "output_filter": ["nope"]})[0] == 400
        assert call(f"{url}/v1/models/lm/versions/1:predict", "POST",
                    {"instances": [[1]], "output_encoding": "xml"})[0] == 400
        assert call(f"{url}/v1/models/lm/versions/1:generate", "POST",
                    {"input_ids": [[1]]})[0] == 501


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
        "cache_node": {"rest_port": 0},
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
    """The port's whole serving path in a fresh interpreter (this test
    process has JAX loaded by the harness): neither ``jax`` nor the JAX
    package may enter ``sys.modules``."""
    script = textwrap.dedent(f"""
        import json, sys, urllib.request
        sys.path.insert(0, {str(ROOT)!r})
        from tfservingcache_tpu_torch.config import config_from_dict
        from tfservingcache_tpu_torch.models import registry
        from tfservingcache_tpu_torch.server import build_node
        store = {str(tmp_path / "store")!r}
        registry.export_artifact("transformer_lm", store, name="lm",
                                 config={dict(SMALL, dtype="bfloat16")!r}, device="cpu")
        cfg = config_from_dict({{"cache": {{"base_dir": {str(tmp_path / "cache")!r}}},
                                "model_provider": {{"base_dir": store}},
                                "cache_node": {{"rest_port": 0}}}})
        node = build_node(cfg, device="cpu")
        port = node.start("127.0.0.1")
        req = urllib.request.Request(
            f"http://127.0.0.1:{{port}}/v1/models/lm/versions/1:predict",
            data=json.dumps({{"instances": [[1, 2, 3]]}}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            assert len(json.loads(resp.read())["predictions"][0]) == 512
        node.close()
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "tfservingcache_tpu") or m.startswith(("jax.", "tfservingcache_tpu.")))
        print("FORBIDDEN", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FORBIDDEN []" in r.stdout


def test_cli_serve_answers_and_stops_on_sigterm(tmp_path, store):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg_path = tmp_path / "node.json"
    cfg_path.write_text(json.dumps({
        "serving": {"device": "cpu"},
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": port},
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


def test_manager_versions_health_and_stale_reload(tmp_path, store):
    jreg.export_artifact("transformer_lm", str(store), name="lm", version=3,
                         config=dict(SMALL, dtype="float32"), seed=7)
    cfg = config_from_dict({
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
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
        "cache_node": {"rest_port": 0},
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
