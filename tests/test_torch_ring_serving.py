"""Context-parallel serving in the port: a ``"attention": "ring"``
transformer_lm bound to a device group (``TorchModelRuntime(devices=...)``,
``build_node`` with ``mesh.chips_per_group``) against the JAX package's
group runtime on the same artifact.

On the CPU a group is copies of the CPU device: the ring's full hop
schedule runs, one shard after another, through the carry step's plain
version. The JAX side runs on the 8-device virtual CPU mesh
(tests/conftest.py). Small config: 2 layers, d_model 128, 4 = 4 heads (the
ring needs n_heads == n_kv_heads), vocab 512.

Tolerances: f32 logits 1e-4 (same math, other summation order); bf16 logits
2**-4 with argmax equal wherever the top-2 margin exceeds twice the
position's max |diff| (the rule of tests/test_torch_transformer_lm.py);
against the JAX group runtime, whose ring shards run the bf16 projections
on every chip, 5e-2 as the reference's own ring serving test
(tests/test_parallel.py:275).
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models import transformer_lm as jlm
from tfservingcache_tpu.parallel.mesh import group_mesh as jgroup_mesh
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import transformer_lm as tlm
from tfservingcache_tpu_torch.parallel import mesh as tmesh
from tfservingcache_tpu_torch.parallel import ring_attention as tring
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId

RING = {"vocab_size": 512, "d_model": 128, "n_layers": 2, "n_heads": 4, "n_kv_heads": 4,
        "d_ff": 256, "max_seq": 256, "attention": "ring"}


def _cfg(dtype: str) -> dict:
    return dict(RING, dtype=dtype)


@pytest.fixture()
def counted_hops(monkeypatch):
    """Counts the ring's carry steps (on the CPU the kernel counter stays 0)."""
    calls = []
    real = tring.attention_carry

    def count(*a, **k):
        calls.append(a[6])
        return real(*a, **k)

    monkeypatch.setattr(tring, "attention_carry", count)
    return calls


def _bf16_rule(got: np.ndarray, want: np.ndarray, min_decided: float = 0.75) -> None:
    diff = np.abs(got - want)
    assert diff.max() <= 2.0**-4
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * diff.max(axis=-1)
    assert decided.mean() >= min_decided
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()


def test_build_accepts_ring_and_rejects_unequal_heads():
    model = treg.build("transformer_lm", _cfg("bfloat16"))
    assert model.bind_group is not None and model.partition_rules == {r".*": ()}
    auto = dict(RING, attention="auto")
    assert treg.build("transformer_lm", auto).bind_group is None
    assert (treg.build("transformer_lm", auto).partition_rules
            == jreg.build("transformer_lm", auto).partition_rules)
    bad = dict(_cfg("bfloat16"), n_kv_heads=2)
    with pytest.raises(ValueError) as want:
        jreg.build("transformer_lm", bad)
    with pytest.raises(ValueError) as got:
        treg.build("transformer_lm", bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not ported"):
        treg.build("transformer_lm", dict(RING, attention="sparse"))


@pytest.mark.parametrize("seq", [128, 100], ids=["ring", "falls-through"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_bound_module_matches_jax_forward_on_a_group_mesh(dtype, seq, counted_hops):
    """The module bound to an 8-device group against the reference's
    ``_forward(mesh=...)`` on an 8-chip group mesh: seq 128 rings (16 rows a
    shard), seq 100 does not divide by 8 and takes plain attention on both
    sides."""
    cfg = _cfg(dtype)
    params = jax.device_get(jreg.build("transformer_lm", cfg).init(jax.random.PRNGKey(3)))
    ids = np.random.default_rng(seq).integers(0, 512, size=(2, seq)).astype(np.int32)
    mesh = jgroup_mesh(jax.devices()[:8], 8, 0)
    want = np.asarray(jlm._forward(jax.tree_util.tree_map(jnp.asarray, params),
                                   jnp.asarray(ids), jreg.build("transformer_lm", cfg).config,
                                   mesh))
    group = tmesh.group_mesh(["cpu"] * 8, 8, 0)
    module = treg.build("transformer_lm", cfg).bind_group(group)(tlm.params_from_jax(params))
    with torch.inference_mode():
        got = module({"input_ids": torch.from_numpy(ids)})["logits"].numpy()
    assert len(counted_hops) == (2 * 64 if seq % 8 == 0 else 0)  # n_layers x P^2 hops
    assert got.shape == want.shape == (2, seq, 512)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        _bf16_rule(got, want)


@pytest.fixture()
def ring_store(tmp_path):
    base = tmp_path / "store"
    jreg.export_artifact("transformer_lm", str(base), name="ringlm", config=_cfg("bfloat16"),
                         seed=1)
    jreg.export_artifact("transformer_lm", str(base), name="ringf", config=_cfg("float32"),
                         seed=2)
    return base


def test_group_runtime_matches_jax_group_runtime_and_one_device(ring_store, counted_hops):
    """A JAX-exported ring artifact served by a port runtime on an 8-copy
    CPU group, by the JAX runtime on an 8-chip group mesh and by a
    one-device port runtime, including a request whose bucket (4) is
    shorter than the ring and falls through (the reference's
    tests/test_parallel.py:238-287)."""
    path = str(ring_store / "ringlm" / "1")
    mid = ModelId("ringlm", 1)
    rt_ring = TorchModelRuntime(device="cpu", devices=["cpu"] * 8)
    rt_one = TorchModelRuntime(device="cpu")
    jrt = TPUModelRuntime(JServingConfig(), mesh=jgroup_mesh(jax.devices()[:8], 8, 0))
    try:
        rt_ring.ensure_loaded(Model(identifier=mid, path=path))
        rt_one.ensure_loaded(Model(identifier=mid, path=path))
        jrt.ensure_loaded(JModel(identifier=JModelId("ringlm", 1), path=path))
        assert rt_ring.device == torch.device("cpu") and len(rt_ring.group) == 8
        ids = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
        for batch in (ids, ids[:, :3]):
            counted_hops.clear()
            got = rt_ring.predict(mid, {"input_ids": batch}, output_filter=["logits"])["logits"]
            one = rt_one.predict(mid, {"input_ids": batch}, output_filter=["logits"])["logits"]
            want = jrt.predict(JModelId("ringlm", 1), {"input_ids": batch},
                               output_filter=["logits"])["logits"]
            assert got.shape == want.shape == (2, batch.shape[1], 512)
            # bucket 16 rings (2 layers x 8^2 hops); bucket 4 < 8 falls through
            assert len(counted_hops) == (128 if batch.shape[1] == 16 else 0)
            np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
            # 16 positions a row: bf16 ties leave fewer of them decided
            _bf16_rule(got, one, min_decided=0.5)
    finally:
        rt_ring.close()
        rt_one.close()
        jrt.close()


def test_generate_on_a_group_runtime_gives_the_one_device_tokens(ring_store, counted_hops):
    """:generate runs on the leader (the reference's generation never
    rings): greedy tokens equal a one-device runtime's, and no hop runs."""
    path = str(ring_store / "ringf" / "1")
    mid = ModelId("ringf", 1)
    rt_ring = TorchModelRuntime(device="cpu", devices=["cpu"] * 4)
    rt_one = TorchModelRuntime(device="cpu")
    try:
        for rt in (rt_ring, rt_one):
            rt.ensure_loaded(Model(identifier=mid, path=path))
        counted_hops.clear()
        ids = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)
        got = rt_ring.generate(mid, ids, max_new_tokens=8)
        want = rt_one.generate(mid, ids, max_new_tokens=8)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (2, 8) and counted_hops == []
    finally:
        rt_ring.close()
        rt_one.close()


def test_tensor_parallel_model_on_a_group_raises(tmp_path):
    """A non-ring transformer_lm declares the reference's Megatron rules:
    a group of more than one device refuses it; a group of one serves it."""
    jreg.export_artifact("transformer_lm", str(tmp_path), name="tp",
                         config=dict(RING, attention="auto", dtype="float32"))
    model = Model(identifier=ModelId("tp", 1), path=str(tmp_path / "tp" / "1"))
    rt = TorchModelRuntime(device="cpu", devices=["cpu"] * 2)
    try:
        with pytest.raises(RuntimeError_, match="tensor parallelism over a group: later slice"):
            rt.ensure_loaded(model)
        assert not rt.is_loaded(model.identifier)
    finally:
        rt.close()
    rt1 = TorchModelRuntime(device="cpu", devices=["cpu"])
    try:
        assert rt1.ensure_loaded(model) == "disk"
    finally:
        rt1.close()


def test_group_runtime_rejects_a_leader_that_is_not_devices_0(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # no card is touched
    with pytest.raises(RuntimeError_, match="leader"):
        TorchModelRuntime(device="cuda:0", devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError_, match="at least one device"):
        TorchModelRuntime(device="cpu", devices=[])


def test_build_node_with_chips_per_group_serves_rest_predict_on_cpu(tmp_path, ring_store,
                                                                    counted_hops):
    cfg = config_from_dict({
        "mesh": {"chips_per_group": 4},
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(ring_store)},
        "cache_node": {"rest_port": 0},
    })
    node = build_node(cfg, device="cpu")
    try:
        assert node.runtime.group == (torch.device("cpu"),) * 4
        port = node.start("127.0.0.1")
        ids = np.random.default_rng(2).integers(0, 512, (1, 30)).astype(np.int32)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/ringf/versions/1:predict",
            data=json.dumps({"instances": ids.tolist()}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            got = np.asarray(json.loads(resp.read())["predictions"], np.float32)
        assert len(counted_hops) == 2 * 16  # bucket 32 over 4 shards, 2 layers
    finally:
        node.close()
    one = TorchModelRuntime(device="cpu")
    try:
        mid = ModelId("ringf", 1)
        one.ensure_loaded(Model(identifier=mid, path=str(ring_store / "ringf" / "1")))
        want = one.predict(mid, {"input_ids": ids})["last_token_logits"]
    finally:
        one.close()
    assert got.shape == want.shape == (1, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_build_node_group_on_cuda_needs_exactly_one_group_of_cards(monkeypatch):
    cfg = config_from_dict({"mesh": {"chips_per_group": 4}, "cache_node": {"rest_port": 0}})
    with pytest.raises(RuntimeError_, match="CUDA is not available"):
        build_node(cfg, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError_, match="needs 4 CUDA devices, this host has 2"):
        build_node(cfg, device="cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(RuntimeError_, match=r"multi-group nodes: later slice \(router\)"):
        build_node(cfg, device="cuda")


def test_mesh_config_section_keeps_chips_per_group_only(caplog):
    with caplog.at_level("WARNING"):
        cfg = config_from_dict({"mesh": {"chips_per_group": 4, "coordinator": "host0:8476",
                                         "num_processes": 2}})
    assert cfg.mesh.chips_per_group == 4
    assert "coordinator" in caplog.text and "num_processes" in caplog.text
    assert config_from_dict({}).mesh.chips_per_group == 1
