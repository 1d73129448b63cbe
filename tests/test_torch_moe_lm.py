"""The port's moe_lm (tfservingcache_tpu_torch/models/moe_lm.py) and its
serving paths against the JAX package, on the CPU.

Configs: module parity at 2 layers, d_model 128, 4 heads / 2 KV heads, 4
experts of width 128, vocab 512; the runtimes serve the reference's
generate-feature model (tests/test_prefix_cache.py: d_model 32, 4 experts of
width 64, capacity factor 2.0, vocab 97, max_seq 128, f32) and a 1-layer
draft of the same vocabulary; "drop" is that model at capacity factor 0.5,
where tokens overflow their expert, and "roomy" at capacity factor 4.0 (=
n_experts), where no expert can overflow. Inputs come from
``numpy.random.default_rng(seed)``. Tolerances:
  - f32: the block and the forward 1e-5 (same math, other summation order;
    the one-hot dispatch of the reference adds exact zeros), greedy tokens
    identical (routing is argmax of f32 probabilities; no near-tie at these
    seeds);
  - bf16: logits 2**-4 and argmax agreeing wherever the top-2 margin exceeds
    twice the position's max |diff|, on most positions (the rule of
    tests/test_torch_transformer_lm.py);
  - int8 artifacts: bytes identical to the reference's.
Capacity is taken over the whole padded batch, so the runtimes' tests feed
shapes off the power-of-two buckets: pad tokens queue for experts in the
same row-major order on both sides. It also makes the prefix cache's
suffix-only prefill and speculation's verify chunks route other shapes than
the plain path's full prefill and width-1 steps: where a token can overflow
its expert their tokens may differ from the plain path's, in the reference
as here, and they are held to the JAX runtime's same path; with "roomy"
capacity they are held to the plain path as well.
"""

import json
import math
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import moe_lm as jmoe
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.models import moe_lm as tmoe
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.ops.attention import KERNEL_HEAD_DIMS
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.batcher import GenerateCoalescer
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId

SMALL = {"vocab_size": 512, "d_model": 128, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
         "d_ff": 128, "n_experts": 4}
MOE = {"vocab_size": 97, "d_model": 32, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
       "d_ff": 64, "n_experts": 4, "capacity_factor": 2.0, "aux_loss_weight": 0.01,
       "max_seq": 128, "dtype": "float32"}
DRAFT = dict(MOE, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=32)
DROP = dict(MOE, capacity_factor=0.5)
ROOMY = dict(MOE, capacity_factor=4.0)
LM_CFG = {"vocab_size": 97, "d_model": 32, "n_layers": 1, "n_heads": 4, "n_kv_heads": 2,
          "d_ff": 64, "max_seq": 128, "dtype": "float32"}
BUDGET = 64 << 20
M, DR, DROPPED = ModelId("moe", 1), ModelId("draft", 1), ModelId("drop", 1)


# -- the family ---------------------------------------------------------------

def _params(cfg: dict, seed: int):
    """Seeded f32 weights in the reference's tree, as numpy arrays (the
    port's ``init`` on a CPU generator: no JAX program to compile)."""
    tree = treg.build("moe_lm", dict(cfg, dtype="float32")).init(
        torch.Generator().manual_seed(seed))
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


def _dropped(x: np.ndarray, router: np.ndarray, cfg: dict) -> int:
    """Tokens past their expert's capacity under the reference's routing."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float32)
    expert = np.asarray(jax.nn.softmax(jnp.asarray(xt @ router.astype(np.float32)))).argmax(-1)
    capacity = max(1, math.ceil(cfg["capacity_factor"] * len(expert) / cfg["n_experts"]))
    counts = np.bincount(expert, minlength=cfg["n_experts"])
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("dtype,capacity_factor", [
    ("float32", 1.25), ("float32", 0.5), ("bfloat16", 1.25), ("bfloat16", 0.5)])
def test_moe_block_matches_jax(dtype, capacity_factor):
    cfg = dict(SMALL, dtype=dtype, capacity_factor=capacity_factor)
    layer = _params(cfg, 0)["layers"][0]["moe"]
    x = np.random.default_rng(1).standard_normal((2, 24, 128)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want, _aux = jax.jit(lambda p, xx: jmoe._moe_block(p, xx, cfg))(
        {"router": jnp.asarray(layer["router"]), "w1": jnp.asarray(layer["w1"]).astype(jdt),
         "w2": jnp.asarray(layer["w2"]).astype(jdt)}, jnp.asarray(x).astype(jdt))
    tdt = getattr(torch, dtype)
    got = tmoe.moe_block(torch.from_numpy(np.asarray(layer["router"])),
                         torch.from_numpy(np.asarray(layer["w1"])).to(tdt),
                         torch.from_numpy(np.asarray(layer["w2"])).to(tdt),
                         torch.from_numpy(x).to(tdt), cfg)
    assert got.dtype == tdt and got.shape == (2, 24, 128)
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= (1e-5 if dtype == "float32" else 2.0**-4)
    dropped = _dropped(np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32)),
                       np.asarray(layer["router"]), cfg)
    assert dropped > (8 if capacity_factor < 1 else -1)
    # a dropped token's row is exactly zero on both sides
    assert int((~want.any(-1)).sum()) == int((~got.float().numpy().any(-1)).sum()) == dropped


def _logits_both(cfg: dict, seed: int, shape=(2, 48)):
    params = _params(cfg, seed)
    ids = np.random.default_rng(seed).integers(0, cfg["vocab_size"], size=shape).astype(np.int32)
    want = np.asarray(jax.jit(jreg.build("moe_lm", cfg).apply)(
        params, {"input_ids": jnp.asarray(ids)})["logits"])
    module = treg.build("moe_lm", cfg).make_module(treg.params_from_jax(params))
    with torch.inference_mode():
        got = module({"input_ids": torch.from_numpy(ids)})["logits"].numpy()
    return got, want


@pytest.mark.parametrize("seed,capacity_factor", [(0, 1.25), (1, 0.5)])
def test_forward_matches_jax_f32(seed, capacity_factor):
    got, want = _logits_both(dict(SMALL, dtype="float32", capacity_factor=capacity_factor), seed)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 48, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("seed,capacity_factor", [(0, 1.25), (2, 0.5)])
def test_forward_matches_jax_bf16(seed, capacity_factor):
    got, want = _logits_both(dict(SMALL, dtype="bfloat16", capacity_factor=capacity_factor),
                             seed)
    diff = np.abs(got - want)
    assert diff.max() <= 2.0**-4
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * diff.max(axis=-1)
    assert decided.mean() > 0.75
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()


def test_model_def_mirrors_the_reference():
    j, t = jreg.build("moe_lm", {}), treg.build("moe_lm", {})
    assert t.config == j.config
    assert t.input_spec == {k: treg.TensorSpec(v.dtype, v.shape) for k, v in j.input_spec.items()}
    assert {k: (v.dtype, v.shape) for k, v in t.output_spec.items()} == {
        k: (v.dtype, v.shape) for k, v in j.output_spec.items()}
    assert t.default_outputs == j.default_outputs == ["last_token_logits"]
    assert t.store_param_dtype == j.store_param_dtype == "bfloat16"
    assert t.partition_rules == j.partition_rules
    assert "moe_lm" in treg.families()


def test_init_has_the_references_layout():
    cfg = dict(SMALL, dtype="float32")
    want = jax.eval_shape(jreg.build("moe_lm", cfg).init, jax.random.PRNGKey(0))
    got = treg.build("moe_lm", cfg).init(torch.Generator().manual_seed(0))
    jflat = {p: (tuple(s.shape), str(s.dtype)) for p, s in treg.flatten_params(
        jax.tree_util.tree_map(lambda s: s, want))}
    tflat = {p: (tuple(v.shape), treg.dtype_name(v.dtype)) for p, v in treg.flatten_params(got)}
    assert tflat == jflat
    assert tflat["layers/0/moe/w1"] == ((4, 128, 128), "float32")


def test_last_token_logits_matches_jax_derived_output():
    logits = np.random.default_rng(5).standard_normal((4, 8, 512), dtype=np.float32)
    dyn = {"batch": 3, "seq": 5}
    jfn, _ = jreg.build("moe_lm", SMALL).derived_outputs["last_token_logits"]
    tfn, _ = treg.build("moe_lm", SMALL).derived_outputs["last_token_logits"]
    np.testing.assert_array_equal(tfn({"logits": torch.from_numpy(logits)}, dyn).numpy(),
                                  np.asarray(jfn({"logits": jnp.asarray(logits)}, dyn)))


@pytest.mark.parametrize("family", ["transformer_lm", "moe_lm"])
def test_each_lm_default_head_dim_has_a_kernel(family):
    """Every port family whose attention reaches ``ops.attention`` serves its
    DEFAULT_CONFIG on the card: its head_dim (d_model / n_heads, 32 for both
    LM families) is one the kernels take, so a default-config model does not
    raise there."""
    cfg = treg.build(family, {}).config
    assert cfg["d_model"] // cfg["n_heads"] in KERNEL_HEAD_DIMS


def test_a_group_runtime_refuses_the_expert_rules(store):
    rt = TorchModelRuntime(ServingConfig(), devices=["cpu", "cpu"])
    try:
        with pytest.raises(RuntimeError_, match="tensor parallelism over a group"):
            rt.ensure_loaded(Model(identifier=M, path=str(store / "moe" / "1")))
    finally:
        rt.close()


# -- the runtimes ---------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Artifacts both runtimes load (one format; the port writes them)."""
    base = tmp_path_factory.mktemp("moe_store")
    for family, name, cfg, seed in (("moe_lm", "moe", MOE, 0), ("moe_lm", "draft", DRAFT, 1),
                                    ("moe_lm", "drop", DROP, 0), ("moe_lm", "roomy", ROOMY, 0),
                                    ("transformer_lm", "lm", LM_CFG, 2)):
        treg.export_artifact(family, str(base), name=name, config=cfg, seed=seed, device="cpu")
    return base


def _port(store, budget=0, names=("moe",)):
    rt = TorchModelRuntime(ServingConfig(prefix_cache_bytes=budget), device="cpu")
    for n in names:
        rt.ensure_loaded(Model(identifier=ModelId(n, 1), path=str(store / n / "1")))
    return rt


def _jax(store, budget=0, names=("moe",)):
    rt = TPUModelRuntime(JConfig(platform="cpu", prefix_cache_bytes=budget))
    for n in names:
        rt.ensure_loaded(JModel(identifier=JModelId(n, 1), path=str(store / n / "1")))
    return rt


@pytest.fixture(scope="module")
def jrt(store):
    """A JAX runtime for the tests without a prefix cache (the jit caches,
    the expensive part, are the JAX package's and outlive any runtime)."""
    rt = _jax(store, names=("moe", "draft", "drop"))
    yield rt
    rt.close()


@pytest.mark.parametrize("name", ["moe", "drop"])
def test_predict_at_a_non_bucket_shape_matches_the_jax_runtime(store, jrt, name):
    """(3, 13) pads to the (4, 16) bucket on both runtimes, and the pad
    tokens take expert capacity alike; "drop" drops tokens there."""
    ids = np.random.default_rng(4).integers(1, 97, (3, 13)).astype(np.int32)
    port = _port(store, names=(name,))
    try:
        for flt in (None, ["logits"]):
            got = port.predict(ModelId(name, 1), {"input_ids": ids}, output_filter=flt)
            want = jrt.predict(JModelId(name, 1), {"input_ids": ids}, output_filter=flt)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].shape == np.asarray(want[k]).shape
                np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-5)
    finally:
        port.close()


def test_solo_greedy_matches_the_jax_runtime(store, jrt):
    """Three ragged prompts to the model that drops tokens: the batch pads
    to 4 rows and the prompt to 16 positions, so prefill and decode route
    the same padded shapes."""
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 97, (3, 11)).astype(np.int32)
    lens = [11, 5, 8]
    port = _port(store, names=("drop",))
    try:
        got = port.generate(DROPPED, ids, prompt_lengths=lens, max_new_tokens=9)
        want = jrt.generate(JModelId("drop", 1), ids, prompt_lengths=lens, max_new_tokens=9)
        assert got.shape == (3, 9)
        np.testing.assert_array_equal(got, np.asarray(want))
    finally:
        port.close()


def _conversation(rt, mid, **kw):
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 97, (1, 24)).astype(np.int32)
    t1 = rt.generate(mid, prompt, max_new_tokens=8, **kw)
    turn2 = np.concatenate([prompt, t1, [[5, 6]]], axis=1).astype(np.int32)
    t2 = rt.generate(mid, turn2, max_new_tokens=8, **kw)
    return t1, t2, turn2


@pytest.mark.parametrize("name", ["moe", "roomy"])
def test_prefix_cache_conversation_matches_the_jax_runtime(store, name):
    """The reference's moe_lm conversation (tests/test_prefix_cache.py:158):
    turn 2 hits turn 1's entry. Token-exact against the JAX runtime with the
    cache on ("moe") and, with roomy capacity, against the cache-off path."""
    mid = ModelId(name, 1)
    port, off = _port(store, budget=BUDGET, names=(name,)), _port(store, names=(name,))
    jr = _jax(store, budget=BUDGET, names=(name,)) if name == "moe" else None
    try:
        got = _conversation(port, mid, seed=3)
        if jr is not None:
            want = _conversation(jr, JModelId(name, 1), seed=3)
            assert jr._prefix_cache.hits == 1
        else:
            want = _conversation(off, mid, seed=3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert port._prefix_cache.hits == 1
    finally:
        for rt in (port, off, jr):
            if rt is not None:
                rt.close()


@pytest.mark.parametrize("name", ["moe", "roomy"])
def test_speculative_moe_target_and_draft(store, name):
    """A moe_lm target verifying a moe_lm draft's proposals. "moe", with the
    prefix cache on (turn 2's target prefill starts from the cached rows):
    the JAX runtime's tokens under the same knob. "roomy", B = 1 and 2: the
    target's own plain greedy decode."""
    mid, names = ModelId(name, 1), (name, "draft")
    try:
        if name == "moe":
            port, ref = _port(store, budget=BUDGET, names=names), _jax(store, BUDGET, names)
            _t1, _t2, turn2 = _conversation(port, mid)
            _conversation(ref, JModelId(name, 1))
            cases = [(turn2, lambda rows: ref.generate(
                JModelId(name, 1), rows, max_new_tokens=10,
                draft_model_id=JModelId("draft", 1), spec_tokens=4))]
        else:
            port, ref = _port(store, names=names), _port(store, names=(name,))
            _t1, _t2, turn2 = _conversation(port, mid)
            cases = [(rows, lambda rows: ref.generate(mid, rows, max_new_tokens=10))
                     for rows in (turn2, np.concatenate([turn2, turn2[:, ::-1]], axis=0))]
        for rows, want in cases:
            got = port.generate(mid, rows, max_new_tokens=10, draft_model_id=DR, spec_tokens=4)
            np.testing.assert_array_equal(got, np.asarray(want(rows)))
        assert port.spec_rounds["solo"] > 0
    finally:
        port.close()
        ref.close()


def test_the_continuous_surface_refuses_moe_lm_like_the_reference(store, jrt):
    """moe_lm never takes the continuous engine (reference :2048, :2836):
    its slot state and a moe_lm draft on a transformer_lm state are refused
    with the reference's messages."""
    port = _port(store, names=("moe", "draft", "lm"))
    jrt.ensure_loaded(JModel(identifier=JModelId("lm", 1), path=str(store / "lm" / "1")))
    try:
        msgs = []
        for rt, mid, draft, lm in ((port, M, DR, ModelId("lm", 1)),
                                   (jrt, JModelId("moe", 1), JModelId("draft", 1),
                                    JModelId("lm", 1))):
            with pytest.raises(Exception, match="continuous decode supports") as e1:
                rt.slot_decode_state(mid, 2)
            state = rt.slot_decode_state(lm, 2, page_tokens=8, arena_pages=16)
            with pytest.raises(Exception, match="continuous speculation supports") as e2:
                rt.slot_attach_draft(state, draft)
            msgs.append((str(e1.value), str(e2.value)))
        assert msgs[0] == msgs[1]
        assert msgs[0][0] == "continuous decode supports transformer_lm only, not 'moe_lm'"
    finally:
        jrt.unload(JModelId("lm", 1))
        port.close()


def test_the_coalescer_never_cobatches_moe_lm(store):
    """Unseeded moe_lm requests skip the coalescer's gate: each reaches the
    runtime's solo generate alone, with its own rows."""
    port = _port(store)
    calls = []
    real = port.generate
    port.generate = lambda mid, ids, **kw: calls.append(np.asarray(ids).shape) or real(
        mid, ids, **kw)
    coal = GenerateCoalescer(port, max_batch=8)
    try:
        prompts = np.random.default_rng(8).integers(1, 97, (3, 1, 6)).astype(np.int32)
        outs = [coal.generate(M, p, max_new_tokens=4, temperature=0.0) for p in prompts]
        assert calls == [(1, 6)] * 3
        assert (coal.batches, coal.batched_requests) == (0, 0)
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, real(M, p, max_new_tokens=4))
    finally:
        port.close()


@pytest.mark.parametrize("engine", ["coalesce", "continuous"])
def test_rest_generate_serves_moe_lm(store, tmp_path, engine):
    """The reference's ``test_rest_generate_moe`` on a port node: greedy
    ``:generate`` of two rows answers 200 with the runtime's own tokens; a
    continuous node serves it on the solo path (its engine admits
    nothing)."""
    cfg = config_from_dict({"serving": {"generate_engine": engine, "kv_page_tokens": 8},
                            "cache": {"base_dir": str(tmp_path / "cache")},
                            "model_provider": {"base_dir": str(store)},
                            "cache_node": {"rest_port": 0, "grpc_port": 0}})
    node = build_node(cfg, device="cpu")
    try:
        port = node.start("127.0.0.1")
        ids = [[1, 2, 3], [4, 5, 6]]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/moe/versions/1:generate",
            data=json.dumps({"input_ids": ids, "max_new_tokens": 3}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            toks = json.loads(resp.read())["tokens"]
        want = node.runtime.generate(M, np.asarray(ids, np.int32), max_new_tokens=3)
        assert toks == want.tolist()
        if engine == "continuous":
            assert node.engine.admitted == 0
    finally:
        node.close()


# -- int8 artifacts -------------------------------------------------------------

INT8 = dict(MOE, d_model=64, d_ff=256)  # w1 and w2 reach the 65536-element floor


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_moe_artifact_is_the_references(tmp_path, dtype):
    """An (E, d, ff) expert leaf quantizes over every axis but the last: one
    f32 scale per ff column across all experts, the reference's bytes."""
    cfg = dict(INT8, dtype=dtype)
    params = _params(cfg, 3)
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16), params)
    jpath = jreg.save_artifact(str(tmp_path / "j"), jreg.build("moe_lm", cfg), params,
                               quantize="int8")
    tpath = treg.save_artifact(str(tmp_path / "t"), treg.build("moe_lm", cfg),
                               treg.params_from_jax(params), quantize="int8")
    for name in ("params.bin", "model.json"):
        with open(os.path.join(jpath, name), "rb") as a, open(os.path.join(tpath, name), "rb") as b:
            assert a.read() == b.read(), name
    _m, raw = treg.load_artifact(tpath, raw_quant=True)
    w1 = raw["layers"][0]["moe"]["w1"]
    assert isinstance(w1, treg.QuantLeaf) and tuple(w1.scale.shape) == (1, 1, 256)
    assert not isinstance(raw["layers"][0]["moe"]["router"], treg.QuantLeaf)


def test_the_port_serves_the_references_int8_moe_artifact(tmp_path):
    """The port's runtime loads the reference's int8 moe_lm artifact raw,
    dequantizes on the device (here the CPU) and answers as the JAX runtime
    does (logits 1e-5)."""
    jreg.save_artifact(str(tmp_path / "q" / "1"), jreg.build("moe_lm", INT8), _params(INT8, 4),
                       quantize="int8")
    mid = ModelId("q", 1)
    port = TorchModelRuntime(ServingConfig(), device="cpu")
    jr = TPUModelRuntime(JConfig(platform="cpu"))
    try:
        port.ensure_loaded(Model(identifier=mid, path=str(tmp_path / "q" / "1")))
        jr.ensure_loaded(JModel(identifier=JModelId("q", 1), path=str(tmp_path / "q" / "1")))
        ids = np.random.default_rng(9).integers(1, 97, (2, 10)).astype(np.int32)
        got = port.predict(mid, {"input_ids": ids})["last_token_logits"]
        want = np.asarray(jr.predict(JModelId("q", 1), {"input_ids": ids})["last_token_logits"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    finally:
        port.close()
        jr.close()
