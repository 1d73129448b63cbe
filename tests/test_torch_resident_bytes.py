"""Resident bytes of a loaded model (the port's runtime, on the CPU).

The resident LRU counts ``LoadedModel.nbytes`` = the loaded tree's bytes,
as the reference counts ``tree_nbytes(params)``. The module must then hold
nothing beyond that tree: its parameters and buffers are the tree's leaves
(or views of them), and every cast to the compute dtype happens inside the
forward, as the reference casts inside its jitted apply. The check counts
each distinct storage reachable from the module and from
``LoadedModel.params`` once (by ``untyped_storage().data_ptr()``).

Artifacts: the JAX package's ``save_artifact`` writes f32 artifacts of
bert, resnet, mnist_cnn and t5 served in bf16 (t5's family stores bf16, so
its f32 copy is written with ``store_param_dtype`` None), plus bf16
artifacts of t5 and transformer_lm as controls. Weights: resnet's from the
port's ``init`` on a seeded CPU generator (flax's eager init of a ResNet
takes tens of seconds), the others from the JAX ``init``.

The forward check holds the modules built over the loaded tree against
modules built over the same tree cast to the compute dtype beforehand (the
construction that cast at build time): ``Tensor.to`` is deterministic, so the
outputs are equal bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models.bert import TINY_CONFIG as BERT_TINY
from tfservingcache_tpu.models.resnet import TINY_CONFIG as RESNET_TINY
from tfservingcache_tpu.models.t5 import TINY_CONFIG as T5_TINY
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.types import Model, ModelId

LM_TINY = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
           "d_ff": 128, "max_seq": 64, "dtype": "bfloat16"}
# name -> (family, config, artifact dtype)
ARTIFACTS = {
    "bert_f32": ("bert", BERT_TINY, "float32"),
    "resnet_f32": ("resnet", RESNET_TINY, "float32"),
    "mnist_f32": ("mnist_cnn", None, "float32"),
    "t5_f32": ("t5", T5_TINY, "float32"),
    "t5_bf16": ("t5", T5_TINY, "bfloat16"),
    "lm_bf16": ("transformer_lm", LM_TINY, "bfloat16"),
}
F32_FAMILIES = ["bert_f32", "resnet_f32", "mnist_f32", "t5_f32"]


def _init(family: str, config) -> dict:
    if family == "resnet":
        gen = torch.Generator().manual_seed(0)
        tree = treg.build(family, config).init(gen)
        return jax.tree_util.tree_map(lambda t: t.numpy(), tree)
    return jax.device_get(jreg.build(family, config).init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("resident_store")
    for name, (family, config, dtype) in ARTIFACTS.items():
        model = jreg.build(family, config)
        if dtype == "float32":
            model = dataclasses.replace(model, store_param_dtype=None)
        else:
            assert model.store_param_dtype == dtype
        jreg.save_artifact(str(base / name / "1"), model, _init(family, config))
    return base


def _inputs(family: str, config) -> dict:
    rng = np.random.default_rng(7)
    if family == "bert":
        ids = rng.integers(0, config["vocab_size"], (2, 16)).astype(np.int32)
        mask = np.ones((2, 16), np.int32)
        mask[1, 11:] = 0
        return {"input_ids": ids, "attention_mask": mask}
    if family == "resnet":
        size = config["image_size"]
        return {"image": rng.standard_normal((2, size, size, 3)).astype(np.float32)}
    if family == "mnist_cnn":
        return {"image": rng.random((2, 28, 28, 1), dtype=np.float32)}
    if family == "t5":
        return {"input_ids": rng.integers(1, config["vocab_size"], (2, 12)).astype(np.int32),
                "decoder_input_ids": rng.integers(0, config["vocab_size"], (2, 8))
                .astype(np.int32)}
    return {"input_ids": rng.integers(0, config["vocab_size"], (2, 16)).astype(np.int32)}


def _storage_bytes(loaded) -> int:
    tensors = [*loaded.module.parameters(), *loaded.module.buffers(),
               *(leaf for _path, leaf in treg.flatten_params(loaded.params))]
    storages = {}
    for t in tensors:
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values())


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "serialized"])
@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_the_module_holds_no_bytes_beyond_the_counted_tree(store, name, pipelined):
    family, _config, dtype = ARTIFACTS[name]
    rt = TorchModelRuntime(ServingConfig(cold_load_pipeline=pipelined), device="cpu")
    try:
        mid = ModelId(name, 1)
        rt.ensure_loaded(Model(identifier=mid, path=str(store / name / "1")))
        loaded = rt._resident.get(mid, touch=False)
        leaves = [leaf for _path, leaf in treg.flatten_params(loaded.params)]
        assert {str(leaf.dtype) for leaf in leaves if leaf.is_floating_point()} == {
            f"torch.{dtype}"}
        assert loaded.nbytes == sum(leaf.numel() * leaf.element_size() for leaf in leaves)
        # the pipelined copy packs the leaves back to back; on the CPU the
        # serialized path's leaves stay views into the artifact's buffer,
        # whose leaves sit at 16-byte aligned offsets
        held = loaded.nbytes if pipelined else (store / name / "1" / "params.bin").stat().st_size
        assert _storage_bytes(loaded) == held, (
            f"{family}: the module holds {_storage_bytes(loaded) - held} bytes beyond the "
            "tree the LRU counts")
    finally:
        rt.close()


def _cast_tree(tree, dtype: torch.dtype):
    """The tree with every float leaf cast to ``dtype`` (int leaves kept)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _precast(family: str, config, params):
    """The tree as the modules used to hold it: each weight already in the
    compute dtype (bf16 for all four families at these configs), the
    leaves the forward reads in f32 (norm statistics' gains and biases,
    bias tables, the f32 heads) left as they are."""
    bf16 = torch.bfloat16
    if family == "bert":
        out = dict(params)
        out["layers"] = [{k: (v if k.startswith("ln") else v.to(bf16)) for k, v in p.items()}
                         for p in params["layers"]]
        out["pool_w"], out["cls_w"] = params["pool_w"].to(bf16), params["cls_w"].to(bf16)
        return out
    if family == "t5":
        out = _cast_tree(params, bf16)
        out["enc_rel"], out["dec_rel"] = params["enc_rel"], params["dec_rel"]
        return out
    if family == "mnist_cnn":
        out = _cast_tree(params, bf16)
        out["Dense_1"] = params["Dense_1"]
        return out
    # resnet: the conv kernels in bf16; GroupNorm and the dense head in f32
    def walk(tree):
        if isinstance(tree, dict):
            return {k: (v.to(bf16) if k == "kernel" and v.ndim == 4 else walk(v))
                    for k, v in tree.items()}
        return tree
    return walk(params)


@pytest.mark.parametrize("name", F32_FAMILIES)
def test_cast_at_use_answers_bit_for_bit_as_the_precast_module(store, name):
    family, config, _dtype = ARTIFACTS[name]
    model_def, params = treg.load_artifact(str(store / name / "1"))
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(family, config).items()}
    with torch.inference_mode():
        got = model_def.make_module(params)(inputs)
        want = model_def.make_module(_precast(family, config, params))(inputs)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert torch.equal(got[key], want[key]), key
