"""Tensor parallelism in the port (tfservingcache_tpu_torch/parallel/
sharding.py, ``TensorParallelLM`` in models/transformer_lm.py, the group
runtime) against the JAX package on the virtual 8-device CPU mesh
(tests/conftest.py), mirroring tests/test_parallel.py:43, :54, :74, :118.

On the CPU a group is copies of the CPU device: the shards run one after
another, their weights views of the loaded tree. Inputs come from
``numpy.random.default_rng``; params from the JAX ``init`` reach the port
through ``registry.params_from_jax``, or from an artifact the JAX package
exported.

Bars: the reference test's own, ``atol = rtol = 5e-2`` and a correlation
above 0.9999 against the JAX single-device and sharded forwards in bf16 (at
SMALL, |logits| <= ~4.3, measured max |diff| 0.035 / 0.051 / 0.031 at P = 2
/ 4 / 8 against the JAX single-device forward and 0.039 / 0.047 / 0.039
against its sharded one; the port's own single-device forward sits 0.031 /
0.024 / 0.031 from the JAX one on the same inputs); 1e-5 in f32 against
the port's single-device forward (measured 2.3e-6 / 2.1e-6 / 1.7e-6: the
partial sums add in another order). ``-s`` prints each case's error.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.parallel import sharding as jsharding
from tfservingcache_tpu.parallel.mesh import make_mesh
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import transformer_lm as tlm
from tfservingcache_tpu_torch.parallel import mesh as tmesh
from tfservingcache_tpu_torch.parallel import sharding
from tfservingcache_tpu_torch.runtime import model_runtime as mr
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId
from tfservingcache_tpu_torch.utils.tracing import TRACER

from torch_obs_globals import confined_globals

# the reference test's config (tests/test_parallel.py:20)
SMALL = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 4,
         "d_ff": 128, "max_seq": 64}
# int8 export quantizes leaves of >= 65536 elements: embed and the FFN here
WIDE = {"vocab_size": 1024, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 1024, "max_seq": 64}
MOE_TINY = {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 4, "n_kv_heads": 4,
            "d_ff": 64, "n_experts": 4, "max_seq": 32}
BAR = 5e-2


def _group(n: int) -> tuple:
    return tmesh.group_mesh(["cpu"] * n, n, 0)


def _jparams(family: str, cfg: dict, seed: int = 0):
    return jax.device_get(jreg.build(family, cfg).init(jax.random.PRNGKey(seed)))


def _tp_module(family: str, cfg: dict, params, n: int):
    model = treg.build(family, cfg)
    plan = model.tensor_parallel(_group(n))
    return plan, plan.make_module(sharding.shard_params(params, plan.rules, _group(n)))


def _forward(module, ids: np.ndarray, **kw) -> np.ndarray:
    with torch.inference_mode():
        return module({"input_ids": torch.from_numpy(ids)}, **kw)["logits"].numpy()


def _hold(got: np.ndarray, want: np.ndarray) -> float:
    np.testing.assert_allclose(got, want, atol=BAR, rtol=BAR)
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.9999, corr
    return float(np.abs(got - want).max())


def test_group_axes_are_one_model_axis():
    assert tmesh.group_axes(_group(4)) == {"model": 4}
    assert tmesh.group_axes(("cpu",)) == {"model": 1}


def test_spec_for_degrades_as_the_reference():
    rules = {r"layers/\d+/attn/w[qkv]": (None, "model")}
    for n in (8, 1):
        mesh = make_mesh({"model": n})
        for path in ("layers/0/attn/wq", "unmatched/path"):
            want = tuple(jsharding.spec_for(path, rules, mesh))
            assert sharding.spec_for(path, rules, {"model": n}) == want
    assert sharding.spec_for("layers/0/attn/wq", rules, {"model": 8}) == (None, "model")
    assert sharding.spec_for("layers/0/attn/wq", rules, {"model": 1}) == (None, None)
    assert sharding.spec_for("layers/0/attn/wq", rules, {}) == (None, None)
    assert sharding.spec_for("unmatched/path", rules, {"model": 8}) == ()
    # the first matching rule wins
    both = {r"layers/0/.*": (), r"layers/\d+/attn/w[qkv]": (None, "model")}
    assert sharding.spec_for("layers/0/attn/wq", both, {"model": 8}) == ()


@pytest.mark.parametrize("family,cfg", [("transformer_lm", SMALL), ("moe_lm", MOE_TINY)])
def test_param_specs_cover_the_tree_as_the_references_shardings(family, cfg):
    params = _jparams(family, cfg)
    mesh = make_mesh({"model": 8})
    want = jsharding.param_shardings(params, jreg.build(family, cfg).partition_rules, mesh)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got = sharding.param_specs(tlm.params_from_jax(params),
                               treg.build(family, cfg).partition_rules, {"model": 8})
    assert len(got) == len(jax.tree_util.tree_leaves(params)) == len(want_leaves)
    for path, ns in want_leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        assert got[key] == tuple(ns.spec), key


@pytest.mark.parametrize("n", [2, 4, 8])
def test_each_shard_holds_the_slice_its_spec_names(n):
    model = treg.build("transformer_lm", SMALL)
    params = tlm.params_from_jax(_jparams("transformer_lm", SMALL))
    plan = model.tensor_parallel(_group(n))
    sharded = sharding.shard_params(params, plan.rules, _group(n))
    specs = sharding.param_specs(params, plan.rules, {"model": n})
    for path, leaf in treg.flatten_params(params):
        placed = dict(treg.flatten_params(sharded))[path]
        assert isinstance(placed, sharding.ShardedLeaf) and len(placed.shards) == n
        assert placed.spec == specs[path] and placed.shape == tuple(leaf.shape)
        cut = sharding.sharded_dim(specs[path], {"model": n})
        if cut is None:
            # replicated: the one tensor, on every member of the group
            assert all(s is placed.shards[0] for s in placed.shards)
            assert placed.shards[0].data_ptr() == leaf.data_ptr()
            continue
        dim, parts = cut
        size = leaf.shape[dim] // parts
        for i, s in enumerate(placed.shards):
            assert torch.equal(s, leaf.narrow(dim, i * size, size))
            # a contiguous tensor of its own, the layout the sharded packed
            # transfer lands: the loaded leaf can be freed once it is cut
            assert s.is_contiguous()
            assert s.untyped_storage().data_ptr() != leaf.untyped_storage().data_ptr()
    # P = 8 does not divide the 4 heads: attention replicates, the rest is cut
    assert plan.halves == {"attn": n != 8, "mlp": True, "embed": True}
    assert mr.tree_nbytes(sharded) == mr.tree_nbytes(params)


def test_shard_leaf_refuses_a_dimension_the_group_does_not_divide():
    with pytest.raises(ValueError, match="does not divide into 3 shards"):
        sharding.shard_leaf(torch.zeros(4, 8), (None, "model"), _group(3))


@pytest.mark.parametrize("n_kv,n,want", [(8, 4, (None, None, "model", None, None)),
                                         (6, 4, ()), (8, 1, ())])
def test_kv_arena_spec_is_the_references(n_kv, n, want):
    assert sharding.kv_arena_spec({"model": n}, n_kv) == want
    assert tuple(jsharding.kv_arena_spec(make_mesh({"model": n}), n_kv)) == want


@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_forward_matches_the_jax_single_device_and_sharded_forwards(n):
    """bf16 at SMALL: the port's group of n against the JAX forward on one
    device and its GSPMD forward over ``make_mesh({"model": n})``; each
    shard's attention call sees its own heads (all 4 on the leader at
    P = 8, which does not divide them)."""
    jmodel = jreg.build("transformer_lm", SMALL)
    params = _jparams("transformer_lm", SMALL)
    ids = np.random.default_rng(n).integers(0, 128, (2, 8)).astype(np.int32)
    want_one = np.asarray(jmodel.apply(params, {"input_ids": ids})["logits"])
    mesh = make_mesh({"model": n})
    jsharded = jsharding.shard_params(params, jmodel.partition_rules, mesh)
    want_tp = np.asarray(jax.jit(jmodel.apply)(jsharded, {"input_ids": jnp.asarray(ids)})["logits"])
    _plan, module = _tp_module("transformer_lm", SMALL, tlm.params_from_jax(params), n)
    shapes = []

    def counted(q, k, v, causal):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return tlm.attention(q, k, v, causal)

    got = _forward(module, ids, attention_fn=counted)
    assert got.shape == (2, 8, 128) and got.dtype == np.float32
    heads = 4 // n if n != 8 else 4
    assert shapes == [((2, heads, 8, 16), (2, heads, 8, 16))] * (2 * (n if n != 8 else 1))
    err_one = _hold(got, want_one)
    err_tp = _hold(got, want_tp)
    print(f"P={n}: max|diff| vs JAX one-device {err_one:.4g}, vs JAX sharded {err_tp:.4g}")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_f32_tp_forward_matches_the_ports_single_device_forward(n):
    cfg = dict(SMALL, dtype="float32")
    params = tlm.params_from_jax(_jparams("transformer_lm", cfg))
    ids = np.random.default_rng(10 + n).integers(0, 128, (2, 16)).astype(np.int32)
    want = _forward(treg.build("transformer_lm", cfg).make_module(params), ids)
    _plan, module = _tp_module("transformer_lm", cfg, params, n)
    got = _forward(module, ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    print(f"P={n} f32: max|diff| vs the port's one-device forward "
          f"{float(np.abs(got - want).max()):.3g}")


def test_gqa_and_indivisible_widths_replicate_their_half():
    """WIDE has 2 KV heads: a group of 4 replicates attention, cuts the FFN
    (1024) and the embedding (64); the forward still equals one device's."""
    cfg = dict(WIDE, dtype="float32")
    params = tlm.params_from_jax(_jparams("transformer_lm", cfg))
    ids = np.random.default_rng(3).integers(0, 1024, (1, 8)).astype(np.int32)
    want = _forward(treg.build("transformer_lm", cfg).make_module(params), ids)
    for n, halves in ((2, {"attn": True, "mlp": True, "embed": True}),
                      (4, {"attn": False, "mlp": True, "embed": True})):
        plan, module = _tp_module("transformer_lm", cfg, params, n)
        assert plan.halves == halves
        np.testing.assert_allclose(_forward(module, ids), want, rtol=0, atol=1e-5)
    odd = dict(cfg, d_model=48, n_heads=4, n_kv_heads=4, d_ff=96)
    params = tlm.params_from_jax(_jparams("transformer_lm", odd))
    plan, module = _tp_module("transformer_lm", odd, params, 3)
    assert plan.halves == {"attn": False, "mlp": True, "embed": True}
    want = _forward(treg.build("transformer_lm", odd).make_module(params), ids % 1024)
    np.testing.assert_allclose(_forward(module, ids % 1024), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", BAR)])
def test_moe_lm_on_a_two_device_group_matches_its_one_device_forward(dtype, tol):
    cfg = dict(MOE_TINY, dtype=dtype)
    params = tlm.params_from_jax(_jparams("moe_lm", cfg))
    ids = (np.arange(24, dtype=np.int32).reshape(2, 12) * 7) % MOE_TINY["vocab_size"]
    want = _forward(treg.build("moe_lm", cfg).make_module(params), ids)
    plan, module = _tp_module("moe_lm", cfg, params, 2)
    # the group has no "expert" axis: the experts and the router replicate
    assert plan.halves == {"attn": True, "embed": True}
    moe = module.layers[0].moe
    assert moe.w1.data_ptr() == params["layers"][0]["moe"]["w1"].data_ptr()
    got = _forward(module, ids)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- the runtime ---------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp_store")
    for name, dtype, quantize in (("bf16", "bfloat16", None), ("f32", "float32", None),
                                  ("int8", "bfloat16", "int8")):
        jreg.export_artifact("transformer_lm", str(base), name=name,
                             config=dict(WIDE, dtype=dtype), seed=5, quantize=quantize)
    jreg.export_artifact("moe_lm", str(base), name="moe", config=MOE_TINY, seed=6)
    return base


def _model(store, name: str) -> Model:
    return Model(identifier=ModelId(name, 1), path=str(store / name / "1"))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["bf16", "f32", "int8"])
def test_runtime_serves_a_tp_artifact_as_the_jax_mesh_runtime(store, name, n, monkeypatch):
    """The port's group runtime against ``TPUModelRuntime(mesh=make_mesh(
    {"model": n}))`` on the same artifact (the int8 one dequantized on the
    host before it is cut, in a ``host_dequant`` stage, as the reference's):
    every reply within the bar, the load span naming the halves it cut,
    the resident bytes the tree's logical bytes."""
    dequants = []
    real = mr._dequantize_on_host
    monkeypatch.setattr(mr, "_dequantize_on_host",
                        lambda params: dequants.append(1) or real(params))
    mid = ModelId(name, 1)
    with confined_globals():
        rt = TorchModelRuntime(ServingConfig(), devices=["cpu"] * n)
        one = TorchModelRuntime(ServingConfig(), device="cpu")
        jrt = TPUModelRuntime(JServingConfig(), mesh=make_mesh({"model": n}))
        try:
            assert rt.ensure_loaded(_model(store, name)) == "disk"
            load = next(s for s in TRACER.query(n=8) if s["name"] == "load")
            assert load["attrs"]["tp_attn"] is (n == 2)  # 2 KV heads
            assert load["attrs"]["tp_mlp"] is True and load["attrs"]["tp_embed"] is True
            assert bool(dequants) == (name == "int8")
            stages = [c["name"] for c in load["children"]]
            assert ("host_dequant" in stages) == (name == "int8")
            assert "device_dequant" not in stages
            one.ensure_loaded(_model(store, name))
            jrt.ensure_loaded(JModel(identifier=JModelId(name, 1),
                                     path=str(store / name / "1")))
            loaded = rt._resident.get(mid, touch=False)
            assert loaded.tensor_parallel and loaded.nbytes == one._resident.get(mid).nbytes
            ids = np.random.default_rng(n).integers(0, 1024, (2, 11)).astype(np.int32)
            got = rt.predict(mid, {"input_ids": ids}, output_filter=["logits"])["logits"]
            want = jrt.predict(JModelId(name, 1), {"input_ids": ids},
                               output_filter=["logits"])["logits"]
            assert got.shape == want.shape == (2, 11, 1024)
            _hold(got, np.asarray(want))
            last = rt.predict(mid, {"input_ids": ids})["last_token_logits"]
            np.testing.assert_array_equal(last, got[:, -1])
            if name == "f32":
                mine = one.predict(mid, {"input_ids": ids}, output_filter=["logits"])["logits"]
                np.testing.assert_allclose(got, mine, rtol=0, atol=1e-5)
        finally:
            rt.close()
            one.close()
            jrt.close()


def test_generate_and_the_slot_surface_refuse_a_tp_group(store):
    """A group of two serves the solo ``generate`` of transformer_lm (f32:
    the one-device tokens) and moe_lm, and builds the continuous slot state
    on the group: the paged arena cut over WIDE's 2 KV heads, one
    contiguous shard a device."""
    rt = TorchModelRuntime(ServingConfig(kv_page_tokens=8), devices=["cpu"] * 2)
    one = TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        for name in ("f32", "moe"):
            rt.ensure_loaded(_model(store, name))
        one.ensure_loaded(_model(store, "f32"))
        ids = np.random.default_rng(1).integers(0, 64, (2, 5)).astype(np.int32)
        got = rt.generate(ModelId("f32", 1), ids, max_new_tokens=6)
        np.testing.assert_array_equal(got, one.generate(ModelId("f32", 1), ids,
                                                        max_new_tokens=6))
        moe = rt.generate(ModelId("moe", 1), ids, max_new_tokens=2)
        assert moe.shape == (2, 2) and ((moe >= 0) & (moe < MOE_TINY["vocab_size"])).all()
        st = rt.slot_decode_state(ModelId("f32", 1), 2)
        assert rt._slot_states == {ModelId("f32", 1): st} and st.page_tokens == 8
        assert isinstance(st.k, sharding.KVShards) and len(st.k.shards) == 2
        assert all(s.is_contiguous() and s.shape[2] == 1 for s in st.k.shards + st.v.shards)
    finally:
        rt.close()
        one.close()


def _post(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_a_two_device_node_serves_tp_predict_over_rest_and_refuses_generate(store, tmp_path):
    """A node of two CPU devices answers REST ``:predict`` tensor parallel
    and ``:generate`` on its continuous engine over the group's sharded
    arena, each as one device answers (``:generate`` of the f32 artifact
    token for token)."""
    cfg = config_from_dict({
        "mesh": {"chips_per_group": 2},
        "serving": {"generate_engine": "continuous", "generate_slots": 2,
                    "kv_page_tokens": 8, "kv_arena_pages": 16},
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    })
    with confined_globals():
        got, toks, ids = _serve(build_node(cfg, device="cpu"))
    one = TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        one.ensure_loaded(_model(store, "bf16"))
        one.ensure_loaded(_model(store, "f32"))
        want = one.predict(ModelId("bf16", 1), {"input_ids": ids})["last_token_logits"]
        want_toks = one.generate(ModelId("f32", 1), ids, max_new_tokens=4)
    finally:
        one.close()
    assert got.shape == want.shape == (1, 1024)
    _hold(got, want)
    np.testing.assert_array_equal(toks, want_toks)


def _serve(node) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    try:
        assert node.runtime.group == (torch.device("cpu"),) * 2
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
        ids = np.random.default_rng(4).integers(0, 1024, (1, 9)).astype(np.int32)
        status, body = _post(f"{base}/bf16/versions/1:predict", {"instances": ids.tolist()})
        assert status == 200
        got = np.asarray(body["predictions"], np.float32)
        assert node.runtime._resident.get(ModelId("bf16", 1), touch=False).tensor_parallel
        status, body = _post(f"{base}/f32/versions/1:generate", {"input_ids": ids.tolist(),
                                                                 "max_new_tokens": 4})
        assert status == 200, body
        # the continuous engine admitted it onto the group's sharded arena
        assert node.engine is not None and node.engine.admitted == 1
        st = node.runtime._slot_states[ModelId("f32", 1)]
        assert isinstance(st.k, sharding.KVShards) and len(st.k.shards) == 2
        st.check_page_conservation()
        return got, np.asarray(body["tokens"]), ids
    finally:
        node.close()
