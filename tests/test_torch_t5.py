"""The port's t5 (tfservingcache_tpu_torch/models/t5.py) against the JAX
package, on the CPU: the relative bucket tables, the forward, the runtime's
two independent sequence buckets, REST and gRPC ``:predict``, the batcher,
the ``:generate`` refusal and the group runtime's refusal.

Configs: the reference's TINY_CONFIG (vocab 256, d_model 64, 2 + 2 layers, 4
heads, d_ff 128, 8 buckets over distance 32), in f32 and bf16, and the
DEFAULT_CONFIG's bucket settings (32 over 128). Weights are the port's
``init`` on a seeded CPU generator, fed to both packages as numpy; inputs
come from ``numpy.random.default_rng(seed)``, with source tails of the pad
token 0. Tolerances:
  - bucket indices: exact, every |rel| <= 4096, both directions;
  - f32: logits 1e-5 (the same math in another summation order; measured
    ~1.3e-6);
  - bf16: 2**-4 (measured up to ~0.042 at |logits| <= ~0.6: the JAX
    package's own bf16 forward sits 0.03-0.07 from its f32 forward on these
    random weights, and the two frameworks round the GeGLU and the norms'
    products at different points), with the argmax equal on every position
    whose top-2 margin exceeds twice that position's |diff| (the rule of
    tests/test_torch_transformer_lm.py);
  - the reference's padding test: its own 2e-2 in bf16, 1e-5 in f32.
Every directory comes from ``tmp_path``; every runtime, node and channel is
closed in a ``finally``; no result waits on the clock.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models import t5 as jt5
from tfservingcache_tpu.runtime.base import RuntimeError_ as JRuntimeError
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import t5 as tt5
from tfservingcache_tpu_torch.protocol import codec
from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel
from tfservingcache_tpu_torch.protocol.grpc_server import PREDICTION_SERVICE
from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.batcher import MicroBatcher
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId

from torch_obs_globals import confined_globals

TINY = jt5.TINY_CONFIG
F32 = dict(TINY, dtype="float32")
F32_TOL = 1e-5
BF16_TOL = 2.0**-4
PAD_TOL_BF16 = 2e-2  # the reference's own bound (tests/test_model_zoo.py:149)
TIMEOUT = 120.0
GENERATE_REFUSAL = "generate is supported for transformer_lm/moe_lm models, not 't5'"


def _params(cfg: dict, seed: int) -> dict:
    """Seeded f32 weights in the reference's tree, as numpy arrays."""
    tree = treg.build("t5", cfg).init(torch.Generator().manual_seed(seed))
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


def _inputs(cfg: dict, seed: int, rows: int = 4, src: int = 24, tgt: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg["vocab_size"], size=(rows, src)).astype(np.int32)
    for r in range(1, rows):  # row 0 full, the others with padded tails
        ids[r, rng.integers(1, src + 1):] = 0
    dec = rng.integers(0, cfg["vocab_size"], size=(rows, tgt)).astype(np.int32)
    return {"input_ids": ids, "decoder_input_ids": dec}


def _jax_forward(cfg: dict, params: dict, inputs: dict) -> np.ndarray:
    out = jax.jit(jreg.build("t5", cfg).apply)(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    return np.asarray(out["logits"])


def _port_forward(cfg: dict, params: dict, inputs: dict) -> np.ndarray:
    module = treg.build("t5", cfg).make_module(treg.params_from_jax(params))
    with torch.inference_mode():
        out = module({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert set(out) == {"logits"}
    return out["logits"].numpy()


def _hold(got: np.ndarray, want: np.ndarray, tol: float) -> None:
    """Logits within ``tol``; the argmax equal wherever the reference's
    top-2 margin exceeds twice that position's |diff|."""
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.max() <= tol, diff.max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * diff.max(axis=-1)
    agree = got.argmax(-1) == want.argmax(-1)
    assert agree[decided].all()


# -- relative buckets ----------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
@pytest.mark.parametrize("cfg", [TINY, jt5.DEFAULT_CONFIG], ids=["tiny", "default"])
def test_bucket_tables_are_the_references(cfg, bidirectional):
    """Every relative position |rel| <= 4096, including the distances where
    the log's exact value is an integer (16, 32, 64 at 32 buckets over 128;
    8, 32, 128 at 8 over 32), lands in the reference's bucket."""
    rel = np.arange(-4096, 4097, dtype=np.int32)
    want = np.asarray(jt5._rel_bucket(jnp.asarray(rel), bidirectional, cfg["rel_buckets"],
                                      cfg["rel_max_dist"]))
    got = tt5.rel_bucket(torch.from_numpy(rel), bidirectional, cfg["rel_buckets"],
                         cfg["rel_max_dist"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < cfg["rel_buckets"]


@pytest.mark.parametrize("q_len,k_len", [(1, 1), (7, 7), (3, 300), (256, 256)])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_relative_bias_is_the_references(q_len, k_len, bidirectional):
    """The module's (1, h, q, k) f32 bias, gathered from a bf16 table, is
    the reference's ``_rel_bias`` bit for bit, and a second call reuses the
    cached indices."""
    cfg = jt5.DEFAULT_CONFIG
    table = np.random.default_rng(q_len).standard_normal(
        (cfg["rel_buckets"], cfg["n_heads"])).astype(np.float32)
    table16 = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(jt5._rel_bias(table16, q_len, k_len, bidirectional, cfg))
    small = dict(TINY, n_heads=8, rel_buckets=cfg["rel_buckets"],
                 rel_max_dist=cfg["rel_max_dist"])
    module = tt5.T5EncoderDecoder(treg.params_from_jax(_params(small, 0)), small)
    ttable = treg.params_from_jax(np.asarray(table16))
    for _call in range(2):
        got = module._bias(ttable, q_len, k_len, bidirectional)
        assert got.dtype == torch.float32 and tuple(got.shape) == (1, 8, q_len, k_len)
        np.testing.assert_array_equal(got.numpy(), want)
    assert list(module._buckets) == [(q_len, k_len, bidirectional)]


# -- the arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f32_forward_matches_jax(seed):
    params, inputs = _params(F32, seed), _inputs(F32, seed)
    _hold(_port_forward(F32, params, inputs), _jax_forward(F32, params, inputs), F32_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_forward_matches_jax(seed):
    params, inputs = _params(TINY, seed), _inputs(TINY, seed)
    _hold(_port_forward(TINY, params, inputs), _jax_forward(TINY, params, inputs), BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_does_not_change_valid_logits(dtype):
    """The reference's padding test (tests/test_model_zoo.py:131) on the
    port: pad tokens (0) on the source are masked, and padded target
    positions come after the valid ones (causal); the padded request also
    gives the JAX package's logits."""
    cfg = dict(TINY, dtype=dtype)
    params = _params(cfg, 0)
    short = {"input_ids": np.array([[5, 6, 7]], np.int32),
             "decoder_input_ids": np.array([[9, 8]], np.int32)}
    padded = {"input_ids": np.array([[5, 6, 7, 0, 0]], np.int32),
              "decoder_input_ids": np.array([[9, 8, 0, 0]], np.int32)}
    l_short = _port_forward(cfg, params, short)
    l_pad = _port_forward(cfg, params, padded)
    tol = F32_TOL if dtype == "float32" else PAD_TOL_BF16
    np.testing.assert_allclose(l_short[0], l_pad[0, :2], atol=tol, rtol=tol)
    _hold(l_pad, _jax_forward(cfg, params, padded),
          F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_an_all_padding_request_stays_finite(dtype):
    """The load's warm-up sends an all-zero (1, 1) request: every source
    position is padding, the masked softmax is uniform (-1e30, not -inf)
    and the logits are finite, as the reference's."""
    cfg = dict(TINY, dtype=dtype)
    params = _params(cfg, 1)
    zeros = {"input_ids": np.zeros((1, 1), np.int32),
             "decoder_input_ids": np.zeros((1, 1), np.int32)}
    got = _port_forward(cfg, params, zeros)
    assert got.shape == (1, 1, TINY["vocab_size"]) and np.isfinite(got).all()
    _hold(got, _jax_forward(cfg, params, zeros), F32_TOL if dtype == "float32" else BF16_TOL)


def test_out_of_range_ids_gather_as_jax_does():
    """Negative ids wrap and ids past the vocabulary clamp, on both
    sequences, as JAX's gather does; the pad mask reads the ids as sent
    (-256 gathers row 0 but is no pad)."""
    params = _params(F32, 4)
    inputs = _inputs(F32, 4, rows=2, src=8, tgt=6)
    inputs["input_ids"][0, :4] = [-1, -300, 256, 10**6]
    inputs["input_ids"][1, 0] = -256
    inputs["decoder_input_ids"][0, :3] = [-5, 999, -256]
    _hold(_port_forward(F32, params, inputs), _jax_forward(F32, params, inputs), F32_TOL)


# -- the family's definition ---------------------------------------------------

@pytest.mark.parametrize("cfg", [TINY, jt5.DEFAULT_CONFIG, F32], ids=["tiny", "default", "f32"])
def test_model_def_mirrors_the_reference(cfg):
    jm, tm = jreg.build("t5", cfg), treg.build("t5", cfg)
    assert tm.family == jm.family == "t5" and tm.config == jm.config
    for spec in ("input_spec", "output_spec"):
        assert {k: (v.dtype, tuple(v.shape)) for k, v in getattr(tm, spec).items()} == {
            k: (v.dtype, tuple(v.shape)) for k, v in getattr(jm, spec).items()}
    assert tm.input_spec["input_ids"].shape == ("batch", "src")
    assert tm.input_spec["decoder_input_ids"].shape == ("batch", "tgt")
    assert tm.partition_rules == jm.partition_rules
    assert tm.axis_caps == {}  # no position table bounds a relative bias
    assert tm.store_param_dtype == jm.store_param_dtype == cfg["dtype"]
    assert tt5.DEFAULT_CONFIG == jt5.DEFAULT_CONFIG
    assert tt5.TINY_CONFIG == jt5.TINY_CONFIG
    assert "t5" in treg.families()


@pytest.mark.parametrize("cfg", [TINY, dict(TINY, n_layers=3, rel_buckets=16, d_ff=96)],
                         ids=["tiny", "three_layers"])
def test_init_tree_is_the_references(cfg):
    """Paths, shapes and dtypes of the reference's tree; unit gains exactly;
    each weight's spread within 10% of the reference's (50% for the bias
    tables' few dozen N(0, 1) draws)."""
    want = jax.device_get(jreg.build("t5", cfg).init(jax.random.PRNGKey(0)))
    got = treg.build("t5", cfg).init(torch.Generator().manual_seed(0))
    wflat, gflat = dict(treg.flatten_params(want)), dict(treg.flatten_params(got))
    assert list(wflat) == list(gflat)
    for path, w in wflat.items():
        g = gflat[path].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, path
        if "ln" in path.rsplit("/", 1)[-1]:
            assert (g == 1).all() and (w == 1).all(), path
        else:
            assert abs(g.std() / w.std() - 1) < (0.1 if g.size >= 1024 else 0.5), path


def test_a_bf16_module_holds_no_second_copy():
    """Built on a bf16 tree (what a bf16 artifact loads), every parameter of
    the module is a leaf of the tree itself: same storage, no cast copy."""
    tree = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16),
                                  treg.build("t5", TINY).init(torch.Generator().manual_seed(2)))
    module = treg.build("t5", TINY).make_module(tree)
    leaves = {leaf.data_ptr() for _p, leaf in treg.flatten_params(tree)}
    params = list(module.parameters())
    assert len(params) == len(leaves) == len(treg.flatten_params(tree))
    assert all(p.data_ptr() in leaves for p in params)


# -- the runtime ---------------------------------------------------------------

@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    """A bf16 TINY artifact the JAX package exported, in both runtimes."""
    store = tmp_path_factory.mktemp("t5_rt")
    path = jreg.export_artifact("t5", str(store), name="t5t", version=1, config=TINY, seed=3)
    port = TorchModelRuntime(ServingConfig(), device="cpu")
    ref = TPUModelRuntime(JConfig(platform="cpu"))
    try:
        port.ensure_loaded(Model(identifier=ModelId("t5t", 1), path=path))
        ref.ensure_loaded(JModel(identifier=JModelId("t5t", 1), path=path))
        yield port, ref, path
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("src,tgt,buckets", [(7, 3, (8, 4)), (1, 1, (1, 1)), (33, 17, (64, 32)),
                                             (16, 5, (16, 8))])
def test_independent_seq_buckets_answer_as_the_reference(runtimes, src, tgt, buckets):
    """src and tgt pad to their own power-of-two buckets (reference
    tests/test_model_zoo.py:111: (1, 7) and (1, 3) give (1, 3, 256)); the
    logits come back at the true tgt and equal the JAX runtime's."""
    port, ref, _path = runtimes
    inputs = {"input_ids": np.ones((1, src), np.int32),
              "decoder_input_ids": np.ones((1, tgt), np.int32)}
    spec = port.signature(ModelId("t5t", 1))[0]
    sizes, padded = port._pad_to_bucket(spec, inputs, {})
    assert sizes == {"batch": 1, "src": src, "tgt": tgt}
    assert {k: v.shape for k, v in padded.items()} == {
        "input_ids": (1, buckets[0]), "decoder_input_ids": (1, buckets[1])}
    got = port.predict(ModelId("t5t", 1), inputs)
    want = ref.predict(JModelId("t5t", 1), inputs)
    assert got["logits"].shape == (1, tgt, 256)
    _hold(got["logits"], np.asarray(want["logits"]), BF16_TOL)


def test_generate_is_refused_with_the_references_message(runtimes):
    port, ref, _path = runtimes
    ids = np.ones((1, 4), np.int32)
    with pytest.raises(JRuntimeError) as want:
        ref.generate(JModelId("t5t", 1), ids, max_new_tokens=2)
    with pytest.raises(RuntimeError_) as got:
        port.generate(ModelId("t5t", 1), ids, max_new_tokens=2)
    assert str(got.value) == str(want.value) == GENERATE_REFUSAL


def test_a_group_runtime_refuses_the_tp_rules(runtimes):
    """t5's Megatron rules are served on a group of two by
    ``TensorParallelT5`` (the refusal this test pinned is lifted): within
    the bf16 bar of the one-device runtime's reply, the resident bytes one
    device's, and ``:generate`` still the reference's refusal."""
    port, _ref, path = runtimes
    mid = ModelId("t5t", 1)
    inputs = _inputs(TINY, 8)
    rt = TorchModelRuntime(ServingConfig(), devices=["cpu", "cpu"])
    try:
        assert rt.ensure_loaded(Model(identifier=mid, path=path)) == "disk"
        loaded = rt._resident.get(mid, touch=False)
        assert loaded.tensor_parallel and isinstance(loaded.module, tt5.TensorParallelT5)
        assert loaded.nbytes == port._resident.get(mid, touch=False).nbytes
        _hold(rt.predict(mid, inputs)["logits"], port.predict(mid, inputs)["logits"], BF16_TOL)
        with pytest.raises(RuntimeError_) as got:
            rt.generate(mid, np.ones((1, 4), np.int32), max_new_tokens=2)
        assert str(got.value) == GENERATE_REFUSAL
    finally:
        rt.close()


def test_the_loaded_module_shares_the_artifacts_storage(runtimes, tmp_path):
    """The resident module's parameters are the loaded tree's leaves, for a
    bf16 artifact and for an f32 one served in bf16 (the module casts at
    use: no cast copy on the device)."""
    import dataclasses

    port, _ref, _path = runtimes
    loaded = port._resident.get(ModelId("t5t", 1), touch=False)
    leaves = {leaf.data_ptr() for _p, leaf in treg.flatten_params(loaded.params)}
    assert all(p.dtype == torch.bfloat16 and p.data_ptr() in leaves
               for p in loaded.module.parameters())
    f32_model = dataclasses.replace(jreg.build("t5", TINY), store_param_dtype=None)
    path = jreg.save_artifact(str(tmp_path / "t5f" / "1"), f32_model, _params(TINY, 3))
    rt = TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        rt.ensure_loaded(Model(identifier=ModelId("t5f", 1), path=path))
        loaded = rt._resident.get(ModelId("t5f", 1), touch=False)
        leaves = {leaf.data_ptr() for _p, leaf in treg.flatten_params(loaded.params)}
        assert all(p.dtype == torch.float32 and p.data_ptr() in leaves
                   for p in loaded.module.parameters())
    finally:
        rt.close()


def test_concurrent_requests_batch_and_answer_their_solo_replies(runtimes):
    """Two same-shape requests that arrive while a third holds the runtime
    form one batch of two through the ``MicroBatcher``; each answer equals
    the same request run solo."""
    port, _ref, _path = runtimes
    mid = ModelId("t5t", 1)
    reqs = [_inputs(TINY, 20 + i, rows=1, src=11, tgt=5) for i in range(3)]
    solo = [port.predict(mid, r)["logits"] for r in reqs]
    release = threading.Event()
    rows: list[int] = []
    real = port.predict

    def gated(model_id, inputs, output_filter=None):
        rows.append(int(inputs["input_ids"].shape[0]))
        if len(rows) == 1:
            assert release.wait(TIMEOUT)
        return real(model_id, inputs, output_filter)

    mb = MicroBatcher(SimpleNamespace(predict=gated, signature=port.signature), max_inflight=1)
    out: list = [None] * 3

    def run(i):
        out[i] = mb.predict(mid, reqs[i])["logits"]

    threads = [threading.Thread(target=run, args=(0,), daemon=True)]
    threads[0].start()
    deadline = time.monotonic() + TIMEOUT
    while not rows:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    for i in (1, 2):
        threads.append(threading.Thread(target=run, args=(i,), daemon=True))
        threads[-1].start()
    while not any(len(p.slots) == 2 for p in list(mb._pending.values())):
        assert time.monotonic() < deadline
        time.sleep(0.001)
    release.set()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert rows == [1, 2] and (mb.batches, mb.batched_requests) == (1, 2)
    for got, want in zip(out, solo):
        np.testing.assert_array_equal(got, want)


# -- REST and gRPC -------------------------------------------------------------

def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port node on an f32 t5 the JAX package exported, and the JAX
    runtime on the same artifact."""
    base = tmp_path_factory.mktemp("t5_rest")
    path = jreg.export_artifact("t5", str(base / "store"), name="t5f", version=1, config=F32,
                                seed=11)
    with confined_globals():
        node = build_node(config_from_dict({
            "cache": {"base_dir": str(base / "cache")},
            "model_provider": {"type": "disk", "base_dir": str(base / "store")},
            "cache_node": {"rest_port": 0, "grpc_port": 0},
        }), device="cpu")
        ref = TPUModelRuntime(JConfig(platform="cpu"))
        try:
            url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/t5f/versions/1"
            ref.ensure_loaded(JModel(identifier=JModelId("t5f", 1), path=path))
            yield node, url, ref
        finally:
            node.close()
            ref.close()


@pytest.mark.parametrize("fmt", ["columnar", "row"])
def test_rest_predict_answers_the_jax_runtimes_logits(served, fmt):
    _node, url, ref = served
    inputs = _inputs(F32, 12, rows=3, src=10, tgt=6)
    if fmt == "columnar":
        body, key = {"inputs": {k: v.tolist() for k, v in inputs.items()}}, "outputs"
    else:
        body = {"instances": [{k: v[r].tolist() for k, v in inputs.items()} for r in range(3)]}
        key = "predictions"
    status, reply = _post(f"{url}:predict", body)
    assert status == 200, reply
    want = np.asarray(ref.predict(JModelId("t5f", 1), inputs)["logits"])
    _hold(np.asarray(reply[key], np.float32), want, F32_TOL)


def test_grpc_predict_answers_the_jax_runtimes_logits(served):
    node, _url, ref = served
    inputs = _inputs(F32, 13, rows=2, src=9, tgt=4)
    req = sv.PredictRequest()
    req.model_spec.name = "t5f"
    req.model_spec.version.value = 1
    for k, v in inputs.items():
        req.inputs[k].CopyFrom(codec.numpy_to_tensorproto(v))
    channel = make_channel(f"127.0.0.1:{node.grpc_port}")
    try:
        resp = ServingStub(channel).method(PREDICTION_SERVICE, "Predict")(req, timeout=TIMEOUT)
    finally:
        channel.close()
    assert set(resp.outputs) == {"logits"}
    want = np.asarray(ref.predict(JModelId("t5f", 1), inputs)["logits"])
    _hold(codec.tensorproto_to_numpy(resp.outputs["logits"]), want, F32_TOL)


def test_rest_generate_answers_the_references_refusal(served):
    _node, url, _ref = served
    status, reply = _post(f"{url}:generate", {"input_ids": [[1, 2, 3]], "max_new_tokens": 2})
    assert status == 400 and reply["error"] == GENERATE_REFUSAL
