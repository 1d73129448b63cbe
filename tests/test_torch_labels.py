"""Version labels and the ``:classify``/``:regress`` verbs over REST: the
port's node (``build_node`` on the CPU) against the JAX package's REST server
over its ``LocalServingBackend``, on one store, over real HTTP. Status and
body are compared byte for byte.

Where the two models' numbers differ (mnist_cnn in bf16, transformer_lm at
f32 summation order), the port's backend is also run over the reference's
runtime, so that everything the backend adds (feature typing, softmax,
labels, f32 scores, the JSON) is held byte for byte, and the port's own
numbers are held to the reference's within the families' bounds
(tests/test_torch_families.py: 2**-7 for mnist_cnn scores; 1e-4 for f32
transformer_lm logits, tests/test_torch_transformer_lm.py).

The reference's REST server is aiohttp on an event loop of its own thread,
closed with it; every port is 0. The tests share one pair of servers (a
module fixture); a test that puts the reference's runtime behind a backend
puts the backend's own back. Both servers parse request bodies with their
package's native parser (``same_parser``), whose error text for a malformed
body is the same in both packages and differs from ``json.loads``'.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskProvider
from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu import native as jnative
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.protocol.local_backend import LocalServingBackend as JBackend
from tfservingcache_tpu.protocol.rest import RestServingServer as JRest
from tfservingcache_tpu.protocol.rest import parse_model_url as jparse
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch import native as pnative
from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.protocol.rest import parse_model_url
from tfservingcache_tpu_torch.server import build_node

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
LABELS = {"hpt": {"stable": 1}, "lm": {"canary": 1}}
MNIST_TOL = 2.0**-7
LM_TOL = 1e-4

# tests/test_protocol.py::test_parse_model_url_rules, plus edge cases
URLS = [
    "/v1/models/m/versions/3:predict", "/v1/models/m:predict", "/v1/models/m/versions/3",
    "/v1/models/m", "/V1/MODELS/m/VERSIONS/3", "/v1/models/m/versions/3/metadata",
    "/v2/nope", "/v1/models/m:poke", "/v1/models/m/versions/notanumber",
    "/v1/models/m/labels/stable:predict", "/v1/models/m/labels/canary",
    "/v1/models/m/labels/stable/metadata", "/v1/models/m/LABELS/Beta:CLASSIFY",
    "/v1/models/m/labels/stable:regress", "/v1/models/m/labels/:predict",
    "/v1/models/m/labels/a/b:predict", "/v1/models/m/versions/3/labels/x",
    "/v1/models/m/labels/x:generate",
]


@pytest.mark.parametrize("url", URLS)
def test_parse_model_url_matches_the_reference(url):
    assert parse_model_url(url) == jparse(url)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    for family, name, version in (("half_plus_two", "hpt", 1), ("half_plus_two", "hpt", 2),
                                  ("mnist_cnn", "mn", 1)):
        jreg.export_artifact(family, str(base), name=name, version=version)
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    return base


class RefRest:
    """The reference's backend behind its aiohttp REST server, on an event
    loop of its own thread."""

    def __init__(self, store, cache_dir) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.metrics = JMetrics()
        self.manager = JCacheManager(
            JDiskProvider(str(store)), JDiskCache(str(cache_dir), capacity_bytes=1 << 30),
            TPUModelRuntime(JServingConfig(platform="cpu"), self.metrics), self.metrics,
            version_labels=LABELS)
        self.backend = JBackend(self.manager)
        # a cache node's server, as the reference's CacheNode builds it: an
        # unversioned URL serves the latest version (the router's 400 is
        # held in tests/test_torch_router.py)
        self.rest = JRest(self.backend, self.metrics, require_version=False)
        try:
            port = self._run(self.rest.start(0, host="127.0.0.1"))
        except BaseException:
            self.close()
            raise
        self.url = f"http://127.0.0.1:{port}"

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def close(self) -> None:
        try:
            self.backend.close()
            self._run(self.rest.close())
            self.manager.close()
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()


@pytest.fixture(scope="module")
def same_parser():
    """The reference's native library loaded wherever the port's is.

    The JAX package builds its library with ``make`` in the package
    directory at first use, and a process whose ``make`` finds the library
    another process is still writing fails to open it and keeps
    ``json.loads`` for its lifetime; that process's reference server then
    answers a malformed body with json's text, where the port's answers
    with the native parser's. The load is retried until the other
    process's build has finished."""
    if pnative.load() is None:
        return  # neither package has its library: both use json.loads
    deadline = time.monotonic() + 120
    while jnative.load() is None:
        assert time.monotonic() < deadline, "the JAX package's native library never loaded"
        time.sleep(0.5)
        jnative._load_attempted = False


@pytest.fixture(scope="module")
def served(store, tmp_path_factory, same_parser):
    with pair(store, tmp_path_factory.mktemp("served")) as trio:
        yield trio


@contextmanager
def swapped_predictors(node, ref, port_predictor, ref_predictor=None):
    """Both backends' predictors replaced for a block, then put back."""
    saved = node.backend._predictor, ref.backend._predictor
    node.backend._predictor = port_predictor
    if ref_predictor is not None:
        ref.backend._predictor = ref_predictor
    try:
        yield
    finally:
        node.backend._predictor, ref.backend._predictor = saved


@contextmanager
def pair(store, tmp_path):
    """-> (port node, port base URL, reference server)."""
    node = build_node(config_from_dict({
        "serving": {"version_labels": LABELS},
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    }), device="cpu")
    ref = None
    try:
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}"
        ref = RefRest(store, tmp_path / "ref_cache")
        yield node, base, ref
    finally:
        if ref is not None:
            ref.close()
        node.close()


def http(url: str, body=None, method=None) -> tuple[int, bytes]:
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method or ("POST" if data else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def same(port_base: str, ref_base: str, path: str, body=None) -> tuple[int, bytes]:
    """Both servers' (status, body) for one request, which must be equal."""
    got, want = http(port_base + path, body), http(ref_base + path, body)
    assert got == want, (path, got, want)
    return got


class RefPredictor:
    """The reference's runtime behind the port's backend (ModelIds
    translated, the model ensured on the reference's manager)."""

    def __init__(self, manager, reshape_image: bool = False) -> None:
        self.manager, self.reshape_image = manager, reshape_image

    def predict(self, model_id, inputs, output_filter=None):
        mid = JModelId(model_id.name, model_id.version)
        self.manager.ensure_servable(mid)
        if self.reshape_image and "image" in inputs:
            img = np.asarray(inputs["image"])
            inputs = dict(inputs, image=img.reshape(img.shape[0], 28, 28, 1))
        return self.manager.runtime.predict(mid, inputs, output_filter)


def test_version_labels_resolve_or_fail(served):
    """A /labels/<label> URL serves the mapped version even with a newer one
    present, its status names that version, and an unmapped label answers
    412 with the reference's body byte for byte
    (test_e2e_single_node.py::test_version_labels_resolve_or_fail)."""
    _node, base, ref = served
    status, body = same(base, ref.url, "/v1/models/hpt/labels/stable:predict",
                        {"instances": [1.0, 2.0]})
    assert status == 200 and json.loads(body) == {"predictions": [2.5, 3.0]}
    status, body = same(base, ref.url, "/v1/models/hpt/labels/stable")
    assert [v["version"] for v in json.loads(body)["model_version_status"]] == ["1"]
    same(base, ref.url, "/v1/models/hpt/labels/stable/metadata")
    for path, body in (("/v1/models/hpt/labels/nope:predict", {"instances": [1.0]}),
                       ("/v1/models/hpt/labels/nope", None),
                       ("/v1/models/hpt/labels/nope/metadata", None),
                       ("/v1/models/ghost/labels/stable:predict", {"instances": [1.0]}),
                       ("/v1/models/hpt/labels/nope:regress", {"examples": [{"x": 1.0}]})):
        status, raw = same(base, ref.url, path, body)
        assert status == 412, (path, raw)  # a label of an unknown model is unmapped too
    # the mapped label beside a newer version: v1, not the latest
    status, body = same(base, ref.url, "/v1/models/hpt/versions/2:predict",
                        {"inputs": {"x": [4.0]}})
    assert json.loads(body) == {"outputs": [4.0]}
    same(base, ref.url, "/v1/models/hpt/labels/stable:predict", {"inputs": {"x": [4.0]}})
    # neither a version nor a label: a node serves the latest resident
    # version, as the reference's node does
    status, body = same(base, ref.url, "/v1/models/hpt:predict", {"instances": [1.0]})
    assert status == 200 and json.loads(body) == {"predictions": [2.5]}


@pytest.mark.parametrize("verb,body", [
    ("regress", {"examples": [{"x": 1.0}, {"x": 3}, {"x": 0.1}, {"x": -2.5e-3}]}),
    ("regress", {"examples": [{"x": [1.0]}, {"x": True}]}),
    ("classify", {"examples": [{"x": 1.0}]}),
    ("regress", {"examples": []}),
    ("regress", {"examples": "x"}),
    ("regress", {"instances": [1.0]}),
    ("regress", {"examples": [{"x": [1.0, 2.0]}, {"x": [1.0]}]}),
    ("regress", {"examples": [{"x": "abc"}]}),
    ("regress", {"examples": [{"y": 1.0}]}),
    ("regress", b"{not json"),
])
def test_classify_and_regress_half_plus_two_bodies(served, verb, body):
    """``:regress`` and ``:classify`` on half_plus_two, answers and failures
    (400, 500) byte for byte, through /versions/ and /labels/ URLs."""
    _node, base, ref = served
    for path in ("/v1/models/hpt/versions/1", "/v1/models/hpt/labels/stable"):
        same(base, ref.url, f"{path}:{verb}", body)


def test_regress_values_are_the_f32_outputs(served):
    _node, base, ref = served
    _status, body = same(base, ref.url, "/v1/models/hpt/versions/2:regress",
                         {"examples": [{"x": 0.1}, {"x": 7}]})
    assert json.loads(body) == {"results": [float(np.float32(0.1) * np.float32(0.5) + 2),
                                            5.5]}


def _images(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 28, 28, 1), dtype=np.float32)


def test_mnist_predict_rest(served):
    """mnist_cnn ``:predict`` over REST answers a logits row and a class a
    row, the logits within the family bound of the reference's and the
    classes equal where decided
    (test_e2e_single_node.py::test_mnist_classify_rest_and_grpc)."""
    imgs = _images(1, 4)
    _node, base, ref = served
    status, raw = http(f"{base}/v1/models/mn/versions/1:predict",
                       {"instances": [{"image": i.tolist()} for i in imgs]})
    rstatus, rraw = http(f"{ref.url}/v1/models/mn/versions/1:predict",
                         {"instances": [{"image": i.tolist()} for i in imgs]})
    assert status == rstatus == 200
    got, want = json.loads(raw)["predictions"], json.loads(rraw)["predictions"]
    assert all(len(r["logits"]) == 10 and isinstance(r["classes"], int) for r in got)
    gl = np.asarray([r["logits"] for r in got])
    wl = np.asarray([r["logits"] for r in want])
    diff = np.abs(gl - wl)
    assert diff.max() <= MNIST_TOL
    top2 = np.sort(wl, -1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * diff.max(-1)
    assert all(g["classes"] == w["classes"] for g, w, d in zip(got, want, decided) if d)


def test_mnist_classify_rest(served):
    """``:classify`` on mnist_cnn: a nested image fails as the reference's
    does (a tf.Example feature is flat); a flat image takes the signature's
    shape on the port (ROADMAP C9; the reference's model refuses the flat
    array). The port's body is the reference backend's byte for byte on the
    reference's own logits, and its own scores are within the bound of the
    reference's forward."""
    imgs = _images(2, 3)
    flat = {"examples": [{"image": i.reshape(-1).tolist()} for i in imgs]}
    node, base, ref = served
    status, _ = same(base, ref.url, "/v1/models/mn/versions/1:classify",
                     {"examples": [{"image": imgs[0].tolist()}]})
    assert status == 500
    status, raw = http(f"{base}/v1/models/mn/versions/1:classify", flat)
    assert status == 200
    assert http(f"{ref.url}/v1/models/mn/versions/1:classify", flat)[0] == 500
    logits = ref.manager.runtime.predict(JModelId("mn", 1), {"image": imgs},
                                         ["logits"])["logits"].astype(np.float64)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    want = e / e.sum(-1, keepdims=True)
    rows = json.loads(raw)["results"]
    assert [[lab for lab, _s in row] for row in rows] == [[str(j) for j in range(10)]] * 3
    assert np.abs(np.asarray([[s for _l, s in row] for row in rows]) - want).max() <= MNIST_TOL
    # the backend's own work byte for byte: both over the reference's
    # runtime, the reference's given the image in the signature's shape
    with swapped_predictors(node, ref, RefPredictor(ref.manager),
                            RefPredictor(ref.manager, reshape_image=True)):
        same(base, ref.url, "/v1/models/mn/versions/1:classify", flat)


def test_transformer_lm_classify_and_regress(served):
    """On transformer_lm ``:classify`` fails as the reference's (its logits
    carry a sequence axis, so a score is a vector), an unknown feature is
    the runtime's 500, and ``:regress`` answers the logits as f32 values:
    byte for byte over the reference's runtime, within 1e-4 on the port's;
    through the /labels/ URL as through /versions/."""
    ids = {"examples": [{"input_ids": [5, 1, 4]}, {"input_ids": [9, 2, 6]}]}
    node, base, ref = served
    for path in ("/v1/models/lm/versions/1", "/v1/models/lm/labels/canary"):
        assert same(base, ref.url, f"{path}:classify", ids)[0] == 500
        assert same(base, ref.url, f"{path}:classify", {"examples": [{"x": 1}]})[0] == 500
    status, raw = http(f"{base}/v1/models/lm/labels/canary:regress", ids)
    rstatus, rraw = http(f"{ref.url}/v1/models/lm/labels/canary:regress", ids)
    assert status == rstatus == 200
    got, want = np.asarray(json.loads(raw)["results"]), np.asarray(json.loads(rraw)["results"])
    assert got.shape == want.shape == (2 * 3 * TINY["vocab_size"],)
    assert np.abs(got - want).max() <= LM_TOL
    with swapped_predictors(node, ref, RefPredictor(ref.manager)):
        for path in ("/v1/models/lm/versions/1", "/v1/models/lm/labels/canary"):
            same(base, ref.url, f"{path}:regress", ids)
