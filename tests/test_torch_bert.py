"""The port's bert (tfservingcache_tpu_torch/models/bert.py) and the runtime's
``ModelDef.axis_caps`` against the JAX package, on the CPU.

Configs: the reference's TINY_CONFIG (vocab 512, hidden 64, 2 layers, 4
heads, d_ff 128, max_seq 64, 3 labels), in f32 and bf16; the runtime's cap
at max_seq 48 (reference tests/test_model_zoo.py:162). Weights are the
port's ``init`` on a seeded CPU generator, fed to both packages as numpy;
inputs come from ``numpy.random.default_rng(seed)``, with attention-mask
tails of zeros. Tolerances:
  - f32: logits and pooled output 1e-5 (the same math in another summation
    order);
  - bf16: 2**-5 (measured up to ~0.014 on the pooled output, |x| <= 1:
    both sides round at the same points, and XLA fuses a bias add into its
    product's rounding where torch rounds twice, a few bf16 ulps through two
    layers);
  - ``:classify`` scores: the float64 softmax of the JAX runtime's logits
    within 1e-5 (an f32 model; the REST body rounds scores to f32).
Every directory comes from ``tmp_path``; every runtime and node is closed in
a ``finally``; no result waits on the clock.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import bert as jbert
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime.base import RuntimeError_ as JRuntimeError
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.models import bert as tbert
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId

TINY = jbert.TINY_CONFIG
F32_TOL = 1e-5
BF16_TOL = 2.0**-5
CAP48 = dict(TINY, max_seq=48)


def _params(cfg: dict, seed: int) -> dict:
    """Seeded f32 weights in the reference's tree, as numpy arrays."""
    tree = treg.build("bert", cfg).init(torch.Generator().manual_seed(seed))
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


def _inputs(cfg: dict, seed: int, shape=(4, 24)) -> dict:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg["vocab_size"], size=shape).astype(np.int32)
    mask = np.ones(shape, np.int32)
    for r in range(1, shape[0]):  # row 0 full, the others with padded tails
        mask[r, rng.integers(1, shape[1] + 1):] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _jax_forward(cfg: dict, params: dict, inputs: dict) -> dict:
    out = jax.jit(jreg.build("bert", cfg).apply)(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _port_forward(cfg: dict, params: dict, inputs: dict) -> dict:
    module = treg.build("bert", cfg).make_module(treg.params_from_jax(params))
    with torch.inference_mode():
        out = module({k: torch.from_numpy(v) for k, v in inputs.items()})
    return {k: v.numpy() for k, v in out.items()}


def _hold(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want) == {"logits", "pooled_output"}
    for name in want:
        assert got[name].dtype == np.float32 and got[name].shape == want[name].shape, name
        diff = np.abs(got[name] - want[name]).max()
        assert diff <= tol, (name, diff)


# -- the arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f32_forward_matches_jax(seed):
    cfg = dict(TINY, dtype="float32")
    params, inputs = _params(cfg, seed), _inputs(cfg, seed)
    _hold(_port_forward(cfg, params, inputs), _jax_forward(cfg, params, inputs), F32_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_forward_matches_jax(seed):
    params, inputs = _params(TINY, seed), _inputs(TINY, seed)
    _hold(_port_forward(TINY, params, inputs), _jax_forward(TINY, params, inputs), BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_leaves_the_logits_alone(dtype):
    """Masked positions add exact zeros to every softmax (reference
    tests/test_model_zoo.py:97): a (1, 3) request and the same ids with two
    masked junk tokens give the same logits, and the padded request gives
    the JAX package's."""
    cfg = dict(TINY, dtype=dtype)
    params = _params(cfg, 3)
    short = {"input_ids": np.array([[5, 6, 7]], np.int32),
             "attention_mask": np.ones((1, 3), np.int32)}
    padded = {"input_ids": np.array([[5, 6, 7, 99, 42]], np.int32),
              "attention_mask": np.array([[1, 1, 1, 0, 0]], np.int32)}
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = _port_forward(cfg, params, padded)
    _hold(_port_forward(cfg, params, short), got, tol)
    _hold(got, _jax_forward(cfg, params, padded), tol)


def test_out_of_range_ids_gather_as_jax_does():
    """Negative ids wrap and ids past the vocabulary clamp, as JAX's gather
    does (an unchecked index on the card would fault the context)."""
    cfg = dict(TINY, dtype="float32")
    params = _params(cfg, 4)
    inputs = _inputs(cfg, 4, (2, 8))
    inputs["input_ids"][0, :4] = [-1, -600, 512, 10**6]
    _hold(_port_forward(cfg, params, inputs), _jax_forward(cfg, params, inputs), F32_TOL)


def test_overlong_sequence_raises_the_references_error():
    params = _params(TINY, 0)
    inputs = {"input_ids": np.ones((1, 70), np.int32),
              "attention_mask": np.ones((1, 70), np.int32)}
    with pytest.raises(ValueError) as want:
        _jax_forward(TINY, params, inputs)
    with pytest.raises(ValueError) as got:
        _port_forward(TINY, params, inputs)
    assert str(got.value) == str(want.value) == "sequence length 70 exceeds max_seq 64"


# -- the family's definition ---------------------------------------------------

@pytest.mark.parametrize("cfg", [TINY, jbert.DEFAULT_CONFIG, dict(jbert.DEFAULT_CONFIG,
                                                                  max_seq=384)],
                         ids=["tiny", "default", "max_seq_384"])
def test_model_def_mirrors_the_reference(cfg):
    jm, tm = jreg.build("bert", cfg), treg.build("bert", cfg)
    assert tm.family == jm.family == "bert" and tm.config == jm.config
    for spec in ("input_spec", "output_spec"):
        assert {k: (v.dtype, tuple(v.shape)) for k, v in getattr(tm, spec).items()} == {
            k: (v.dtype, tuple(v.shape)) for k, v in getattr(jm, spec).items()}
    assert tm.partition_rules == jm.partition_rules
    assert tm.axis_caps == jm.axis_caps == {"seq": cfg["max_seq"]}
    assert tm.store_param_dtype is None  # f32 artifacts, as the reference writes them
    assert tbert.DEFAULT_CONFIG == jbert.DEFAULT_CONFIG
    assert tbert.TINY_CONFIG == jbert.TINY_CONFIG


@pytest.mark.parametrize("cfg", [TINY, dict(TINY, n_layers=3, num_labels=5, max_seq=48)],
                         ids=["tiny", "three_layers"])
def test_init_tree_is_the_references(cfg):
    """Paths, shapes and dtypes of the reference's tree; zero biases and unit
    gains exactly; each weight's spread within 10% of the reference's."""
    want = jax.device_get(jreg.build("bert", cfg).init(jax.random.PRNGKey(0)))
    got = treg.build("bert", cfg).init(torch.Generator().manual_seed(0))
    wflat, gflat = dict(treg.flatten_params(want)), dict(treg.flatten_params(got))
    assert list(wflat) == list(gflat)
    for path, w in wflat.items():
        g = gflat[path].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, path
        leaf = path.rsplit("/", 1)[-1]
        if leaf.startswith("b") or leaf.endswith("_b"):
            assert not g.any() and not w.any(), path
        elif leaf.endswith("_g"):
            assert (g == 1).all() and (w == 1).all(), path
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, path


# -- the runtime: axis_caps ------------------------------------------------------

@pytest.fixture(scope="module")
def cap_runtimes(tmp_path_factory):
    """One artifact the JAX package exported at max_seq 48, in both
    runtimes."""
    store = tmp_path_factory.mktemp("bert_cap")
    path = jreg.export_artifact("bert", str(store), name="b48", version=1, config=CAP48, seed=7)
    port = TorchModelRuntime(ServingConfig(), device="cpu")
    ref = TPUModelRuntime(JConfig(platform="cpu"))
    try:
        port.ensure_loaded(Model(identifier=ModelId("b48", 1), path=path))
        ref.ensure_loaded(JModel(identifier=JModelId("b48", 1), path=path))
        yield port, ref
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("n,bucket", [(40, 48), (48, 48), (17, 32), (1, 1)])
def test_capped_seq_bucket_answers_as_the_reference(cap_runtimes, n, bucket):
    """A 40-token request pads to 48 (not 64, which the forward refuses)
    and answers the JAX runtime's logits and pooled output."""
    port, ref = cap_runtimes
    inputs = _inputs(CAP48, n, (2, n))
    spec = port.signature(ModelId("b48", 1))[0]
    _sizes, padded = port._pad_to_bucket(spec, inputs, treg.build("bert", CAP48).axis_caps)
    assert {k: v.shape for k, v in padded.items()} == {
        "input_ids": (2, bucket), "attention_mask": (2, bucket)}
    got = port.predict(ModelId("b48", 1), inputs)
    want = ref.predict(JModelId("b48", 1), inputs)
    _hold(got, {k: np.asarray(v) for k, v in want.items()}, BF16_TOL)


def test_past_the_cap_both_runtimes_refuse_alike(cap_runtimes):
    port, ref = cap_runtimes
    inputs = {"input_ids": np.ones((1, 50), np.int32),
              "attention_mask": np.ones((1, 50), np.int32)}
    with pytest.raises(JRuntimeError) as want:
        ref.predict(JModelId("b48", 1), inputs)
    with pytest.raises(RuntimeError_) as got:
        port.predict(ModelId("b48", 1), inputs)
    assert str(got.value) == str(want.value) == "'seq' dim 50 exceeds this model's maximum 48"


def test_a_group_runtime_refuses_the_tp_rules(tmp_path):
    """bert's Megatron rules are served on a group of more than one device
    by ``TensorParallelBert`` (the refusal this test pinned is lifted): the
    group's replies sit within the bf16 bar of one device's, with the
    halves cut and the resident bytes one device's; a group of one serves
    it on its leader."""
    path = jreg.export_artifact("bert", str(tmp_path), name="bg", version=1, config=TINY,
                                seed=2)
    model = Model(identifier=ModelId("bg", 1), path=path)
    inputs = _inputs(TINY, 7)
    rt = TorchModelRuntime(ServingConfig(), devices=["cpu", "cpu"])
    one = TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        assert rt.ensure_loaded(model) == one.ensure_loaded(model) == "disk"
        loaded = rt._resident.get(model.identifier, touch=False)
        assert loaded.tensor_parallel and isinstance(loaded.module, tbert.TensorParallelBert)
        assert loaded.nbytes == one._resident.get(model.identifier, touch=False).nbytes
        got, want = rt.predict(model.identifier, inputs), one.predict(model.identifier, inputs)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= BF16_TOL, k
    finally:
        rt.close()
        one.close()
    rt = TorchModelRuntime(ServingConfig(), devices=["cpu"])
    try:
        assert rt.ensure_loaded(model) == "disk"
        assert not rt._resident.get(model.identifier, touch=False).tensor_parallel
    finally:
        rt.close()


def test_an_uncapped_family_still_pads_to_a_power_of_two(cap_runtimes):
    port, _ref = cap_runtimes
    spec = {"x": treg.TensorSpec("int32", ("batch", "seq"))}
    sizes, padded = port._pad_to_bucket(spec, {"x": np.ones((3, 50), np.int32)}, {})
    assert sizes == {"batch": 3, "seq": 50} and padded["x"].shape == (4, 64)


# -- REST ----------------------------------------------------------------------

def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port node on an f32 bert the JAX package exported, and the JAX
    runtime on the same artifact."""
    base = tmp_path_factory.mktemp("bert_rest")
    cfg = dict(TINY, dtype="float32")
    path = jreg.export_artifact("bert", str(base / "store"), name="bt", version=1, config=cfg,
                                seed=11)
    node = build_node(config_from_dict({
        "cache": {"base_dir": str(base / "cache")},
        "model_provider": {"type": "disk", "base_dir": str(base / "store")},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    }), device="cpu")
    ref = TPUModelRuntime(JConfig(platform="cpu"))
    try:
        url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/bt/versions/1"
        ref.ensure_loaded(JModel(identifier=JModelId("bt", 1), path=path))
        yield url, ref
    finally:
        node.close()
        ref.close()


def test_rest_predict_answers_the_jax_runtimes_outputs(served):
    url, ref = served
    inputs = _inputs(TINY, 12, (3, 10))
    status, body = _post(f"{url}:predict", {"inputs": {k: v.tolist() for k, v in inputs.items()}})
    assert status == 200, body
    want = ref.predict(JModelId("bt", 1), inputs)
    got = {k: np.asarray(v, np.float32) for k, v in body["outputs"].items()}
    _hold(got, {k: np.asarray(v) for k, v in want.items()}, F32_TOL)


def test_rest_classify_scores_are_the_softmax_of_the_jax_logits(served):
    url, ref = served
    inputs = _inputs(TINY, 13, (2, 9))
    examples = [{k: v[r].tolist() for k, v in inputs.items()} for r in range(2)]
    status, body = _post(f"{url}:classify", {"examples": examples})
    assert status == 200, body
    logits = np.asarray(ref.predict(JModelId("bt", 1), inputs)["logits"], np.float64)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    want = e / e.sum(axis=-1, keepdims=True)
    results = body["results"]
    assert [[label for label, _s in row] for row in results] == [["0", "1", "2"]] * 2
    np.testing.assert_allclose([[s for _l, s in row] for row in results], want, rtol=0,
                               atol=1e-5)


def test_rest_classify_refuses_a_ragged_example_list(served):
    url, _ref = served
    examples = [{"input_ids": [1, 2, 3], "attention_mask": [1, 1, 1]},
                {"input_ids": [4, 5], "attention_mask": [1, 1]}]
    status, body = _post(f"{url}:classify", {"examples": examples})
    assert status == 400
    assert "inconsistent lengths across examples" in body["error"]
