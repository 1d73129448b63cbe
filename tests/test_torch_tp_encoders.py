"""Tensor parallelism for bert and t5 in the port (``TensorParallelBert`` in
tfservingcache_tpu_torch/models/bert.py, ``TensorParallelT5`` in
models/t5.py, their ``tensor_parallel`` plans over the reference's Megatron
rules) against the JAX package on the virtual 8-device CPU mesh
(tests/conftest.py), as tests/test_torch_sharding.py holds
``TensorParallelLM``: the port's module over ``sharding.shard_params`` on
``["cpu"] * n`` against the JAX ``apply`` over ``jsharding.shard_params``
on ``make_mesh({"model": n})``, and the group runtime against
``TPUModelRuntime(mesh=...)`` on the same artifact.

Configs: each family's TINY_CONFIG (4 heads, d_ff 128, width 64), cut at n
= 2 and 4, and ODD (6 heads over width 96, d_ff 128) at n = 4, which does
not divide its 6 heads: attention replicates on the leader while the FFN
and the embedding are cut. Weights are the port's ``init`` on a seeded CPU
generator, fed to both packages as numpy; inputs come from
``numpy.random.default_rng``.

Bars: f32 within 1e-5 of the port's one-device forward (the partial sums add
in another order; measured 6.0e-7 to 2.3e-6, ``-s`` prints them); bf16 within the
family's bar against the JAX mesh forward: bert 2**-5 and t5 2**-4 with the
argmax rule of tests/test_torch_t5.py (tests/test_torch_bert.py,
tests/test_torch_t5.py; measured 0.014 to 0.029). Every runtime is closed in a ``finally``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import bert as jbert
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models import t5 as jt5
from tfservingcache_tpu.parallel import sharding as jsharding
from tfservingcache_tpu.parallel.mesh import make_mesh
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.parallel import sharding
from tfservingcache_tpu_torch.parallel.mesh import group_mesh
from tfservingcache_tpu_torch.runtime import model_runtime as mr
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.types import Model, ModelId

from torch_obs_globals import confined_globals

TINY = {"bert": jbert.TINY_CONFIG, "t5": jt5.TINY_CONFIG}
ODD = {"bert": dict(jbert.TINY_CONFIG, hidden=96, n_heads=6),
       "t5": dict(jt5.TINY_CONFIG, d_model=96, n_heads=6)}
BF16_BAR = {"bert": 2.0**-5, "t5": 2.0**-4}
F32_TOL = 1e-5


def _group(n: int) -> tuple:
    return group_mesh(["cpu"] * n, n, 0)


def _params(family: str, cfg: dict, seed: int) -> dict:
    tree = treg.build(family, cfg).init(torch.Generator().manual_seed(seed))
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


def _inputs(family: str, cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    if family == "bert":
        ids = rng.integers(0, cfg["vocab_size"], size=(3, 20)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[1, 13:] = 0
        mask[2, 5:] = 0
        return {"input_ids": ids, "attention_mask": mask}
    ids = rng.integers(1, cfg["vocab_size"], size=(3, 18)).astype(np.int32)
    ids[1, 11:] = 0
    dec = rng.integers(0, cfg["vocab_size"], size=(3, 9)).astype(np.int32)
    return {"input_ids": ids, "decoder_input_ids": dec}


def _port(module, inputs: dict) -> dict:
    with torch.inference_mode():
        out = module({k: torch.from_numpy(v) for k, v in inputs.items()})
    return {k: v.numpy() for k, v in out.items()}


def _tp_module(family: str, cfg: dict, params: dict, n: int):
    plan = treg.build(family, cfg).tensor_parallel(_group(n))
    tree = treg.params_from_jax(params)
    return plan, plan.make_module(sharding.shard_params(tree, plan.rules, _group(n)))


def _jax_mesh(family: str, cfg: dict, params: dict, inputs: dict, n: int) -> dict:
    model = jreg.build(family, cfg)
    placed = jsharding.shard_params(params, model.partition_rules, make_mesh({"model": n}))
    out = jax.jit(model.apply)(placed, {k: jnp.asarray(v) for k, v in inputs.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _hold(family: str, got: dict, want: dict) -> float:
    """Every output within the family's bf16 bar; t5's argmax equal wherever
    the reference's top-2 margin exceeds twice that position's |diff|."""
    worst = 0.0
    for k in want:
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= BF16_BAR[family], (k, float(diff.max()))
        worst = max(worst, float(diff.max()))
    if family == "t5":
        logits, ref = got["logits"], want["logits"]
        top2 = np.sort(ref, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > 2 * np.abs(logits - ref).max(axis=-1)
        assert (logits.argmax(-1) == ref.argmax(-1))[decided].all()
    return worst


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("family", ["bert", "t5"])
def test_the_plan_cuts_every_half_of_tiny(family, n):
    """At TINY the group's size divides the 4 heads, d_ff and the width:
    every half is cut, each cut leaf's shards the slices its spec names,
    and the sharded tree's bytes the tree's."""
    cfg = TINY[family]
    params = treg.params_from_jax(_params(family, cfg, 0))
    plan = treg.build(family, cfg).tensor_parallel(_group(n))
    assert plan.halves == {"attn": True, "mlp": True, "embed": True}
    placed = dict(treg.flatten_params(sharding.shard_params(params, plan.rules, _group(n))))
    jrules = jreg.build(family, cfg).partition_rules
    for path, leaf in treg.flatten_params(params):
        spec = sharding.spec_for(path, plan.rules, {"model": n})
        assert spec == sharding.spec_for(path, jrules, {"model": n}), path
        assert placed[path].spec == spec and placed[path].shape == tuple(leaf.shape)
    assert mr.tree_nbytes(placed) == mr.tree_nbytes(params)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("family", ["bert", "t5"])
def test_bf16_tp_forward_matches_the_jax_mesh_forward(family, n):
    cfg = TINY[family]
    params = _params(family, cfg, 1)
    inputs = _inputs(family, cfg, n)
    want = _jax_mesh(family, cfg, params, inputs, n)
    _plan, module = _tp_module(family, cfg, params, n)
    err = _hold(family, _port(module, inputs), want)
    print(f"{family} P={n} bf16: max|diff| vs the JAX mesh forward {err:.4g}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("family", ["bert", "t5"])
def test_f32_tp_forward_matches_the_ports_single_device_forward(family, n):
    cfg = dict(TINY[family], dtype="float32")
    params = _params(family, cfg, 2)
    inputs = _inputs(family, cfg, 10 + n)
    want = _port(treg.build(family, cfg).make_module(treg.params_from_jax(params)), inputs)
    _plan, module = _tp_module(family, cfg, params, n)
    got = _port(module, inputs)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=F32_TOL)
    print(f"{family} P={n} f32: max|diff| vs one device "
          f"{max(float(np.abs(got[k] - want[k]).max()) for k in want):.3g}")


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_an_indivisible_width_replicates_its_half(family):
    """ODD has 6 heads: a group of 4 replicates attention on the leader and
    cuts the FFN and the embedding. f32 equals one device's forward, and
    bf16 sits within the bar of the JAX mesh forward (GSPMD cuts the same
    weights by the family's rules, whatever the heads)."""
    cfg = dict(ODD[family], dtype="float32")
    params = _params(family, cfg, 3)
    inputs = _inputs(family, cfg, 4)
    plan, module = _tp_module(family, cfg, params, 4)
    assert plan.halves == {"attn": False, "mlp": True, "embed": True}
    attn = module.layers[0] if family == "bert" else module.enc_layers[0].attn
    devices = attn.attn_devices if family == "bert" else attn.devices
    assert devices == (torch.device("cpu"),)
    want = _port(treg.build(family, cfg).make_module(treg.params_from_jax(params)), inputs)
    got = _port(module, inputs)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=F32_TOL)
    bf16 = ODD[family]
    params = _params(family, bf16, 3)
    _plan, module = _tp_module(family, bf16, params, 4)
    _hold(family, _port(module, inputs), _jax_mesh(family, bf16, params, inputs, 4))


def test_t5_shards_add_their_own_heads_rows_of_the_bias_tables():
    """The relative bias tables are replicated but indexed by head: with
    every head's bias row set apart (a large value on one head), the group
    of 2 still equals one device in f32, and shard i's attention call sees
    only its heads' rows."""
    cfg = dict(TINY["t5"], dtype="float32")
    params = _params("t5", cfg, 5)
    params["enc_rel"][:, 3] += 4.0
    params["dec_rel"][:, 0] -= 4.0
    inputs = _inputs("t5", cfg, 6)
    want = _port(treg.build("t5", cfg).make_module(treg.params_from_jax(params)), inputs)
    _plan, module = _tp_module("t5", cfg, params, 2)
    np.testing.assert_allclose(_port(module, inputs)["logits"], want["logits"], rtol=0,
                               atol=F32_TOL)
    assert module.enc_layers[0].attn.n_heads == 2


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp_enc_store")
    for family in ("bert", "t5"):
        jreg.export_artifact(family, str(base), name=family, version=1, config=TINY[family],
                             seed=7)
    return base


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serialized"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("family", ["bert", "t5"])
def test_runtime_serves_the_family_as_the_jax_mesh_runtime(store, family, n, pipeline):
    """The port's group runtime (pipelined sharded or serialized load)
    against ``TPUModelRuntime(mesh=make_mesh({"model": n}))`` on the same
    bf16 artifact: the load span names the halves it cut, the resident
    bytes are one device's, the reply within the family's bar."""
    mid, jmid = ModelId(family, 1), JModelId(family, 1)
    path = str(store / family / "1")
    inputs = _inputs(family, TINY[family], 20 + n)
    with confined_globals():
        rt = TorchModelRuntime(ServingConfig(cold_load_pipeline=pipeline),
                               devices=["cpu"] * n)
        one = TorchModelRuntime(ServingConfig(), device="cpu")
        jrt = TPUModelRuntime(JServingConfig(platform="cpu"), mesh=make_mesh({"model": n}))
        try:
            assert rt.ensure_loaded(Model(identifier=mid, path=path)) == "disk"
            loaded = rt._resident.get(mid, touch=False)
            assert loaded.tensor_parallel
            one.ensure_loaded(Model(identifier=mid, path=path))
            assert loaded.nbytes == one._resident.get(mid, touch=False).nbytes
            jrt.ensure_loaded(JModel(identifier=jmid, path=path))
            got = rt.predict(mid, inputs)
            _hold(family, got, {k: np.asarray(v) for k, v in jrt.predict(jmid, inputs).items()})
        finally:
            rt.close()
            one.close()
            jrt.close()
