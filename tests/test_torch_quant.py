"""int8 artifacts in the port (tfservingcache_tpu_torch/models/registry.py
``quantize="int8"``, ``QuantLeaf``, ``raw_quant``; the runtime's on-device
dequant on the serialized load, the pipelined load and a host-tier
promotion) against the JAX package's (tests/test_quant.py).

- The writer: from the same seeded numpy weights (f32 and bf16, one output
  channel all zeros for the 1e-12 scale floor, one that rounds halves to
  even) the port's ``params.bin`` and ``model.json`` are the reference's
  byte for byte. Each package loads the other's int8 artifact: ``raw_quant``
  gives the reference's int8 ``q`` and f32 ``scale``, and ``dequant_host``
  is bit for bit the reference's. A re-save of a ``raw_quant`` tree carries
  the leaves through without quantizing again, and writes the reference's
  re-save byte for byte.
- The runtime (CPU): the three load paths give ``torch.equal`` params, the
  host dequant's, and each ran ``_dequantize_on_device``. ``:predict``
  agrees with the JAX runtime on the same artifact within bf16's 2**-4
  (tests/test_torch_transformer_lm.py), argmax equal off near-ties; greedy
  tokens are identical up to a first divergence whose two tokens lie
  within 2**-3 of the JAX model's maximum there (tests/test_torch_generation.py).
  A runtime bound to a device group ships raw int8 and dequantizes on the
  device.
- The per-tenant families (the classifiers bert and resnet, and t5): plain
  and int8 artifacts from the same weights are the reference's bytes; the
  port's runtime serves the reference's int8 artifact exactly as its module
  on the host-dequantized weights, and as the JAX runtime within each
  family's bf16 bound.

Every directory comes from ``tmp_path``; every runtime is closed in a
``finally``; no result waits on the clock.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime import model_runtime as jmr
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.runtime import model_runtime as mr
from tfservingcache_tpu_torch.types import Model, ModelId
from tfservingcache_tpu_torch.utils.tracing import TRACER

from torch_obs_globals import confined_globals

# the reference's tests/test_quant.py config: most bytes in >= 65536-element weights
LM_CFG = {"vocab_size": 1024, "d_model": 256, "n_layers": 2, "n_heads": 4,
          "n_kv_heads": 2, "d_ff": 1024, "max_seq": 128, "rope_theta": 10000.0}
# the served config: embed, wq, wo and the MLP quantized, wk / wv and the norms not
QCFG = {"vocab_size": 512, "d_model": 256, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 512, "max_seq": 64, "dtype": "bfloat16"}
DTYPES = ["float32", "bfloat16"]
BF16_TOL = 2.0**-4
TIE_TOL = 2.0**-3
SMALL_CHUNK = 1 << 18   # several pack chunks a dtype group


def _numpy_params(cfg: dict, seed: int):
    """Seeded numpy weights in the family's tree (its shapes from
    ``jax.eval_shape``: nothing is initialized). Embed column 0 is all zeros
    (the scale floor) and column 1 holds 127 and signed halves (scale 1.0:
    round half to even)."""
    shapes = jax.eval_shape(jreg.build("transformer_lm", cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    dt = jnp.bfloat16 if cfg["dtype"] == "bfloat16" else np.float32
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32), shapes)
    embed = params["embed"]
    embed[:, 0] = 0.0
    embed[:, 1] = 0.0
    embed[:7, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    return jax.tree_util.tree_map(lambda a: np.asarray(a).astype(dt), params)


def _write_both(tmp_path, dtype: str, seed: int = 0) -> tuple[str, str, dict]:
    cfg = dict(LM_CFG, dtype=dtype)
    params = _numpy_params(cfg, seed)
    jpath = jreg.save_artifact(str(tmp_path / f"j_{dtype}"), jreg.build("transformer_lm", cfg),
                               params, quantize="int8")
    tpath = treg.save_artifact(str(tmp_path / f"t_{dtype}"), treg.build("transformer_lm", cfg),
                               treg.params_from_jax(params), quantize="int8")
    return jpath, tpath, cfg


def _read(path: str, name: str) -> bytes:
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


def _u8(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8).tobytes()


def _quant_leaves(tree, cls) -> dict:
    return {p: v for p, v in treg.flatten_params(tree) if isinstance(v, cls)}


# -- the artifact -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_writer_is_the_references(tmp_path, dtype):
    jpath, tpath, _cfg = _write_both(tmp_path, dtype)
    assert _read(tpath, "params.bin") == _read(jpath, "params.bin")
    assert _read(tpath, "model.json") == _read(jpath, "model.json")
    with open(os.path.join(tpath, "model.json")) as f:
        meta = json.load(f)
    assert meta["quantize"] == "int8"
    quant = [e for e in meta["params"]["manifest"] if "quant" in e]
    assert len(quant) == 1 + 2 * 5  # embed + wq, wo, w1, w2, w3 of each layer
    assert all(e["quant"]["orig_dtype"] == dtype for e in quant)
    plain = jreg.save_artifact(str(tmp_path / "plain"),
                               jreg.build("transformer_lm", dict(LM_CFG, dtype=dtype)),
                               _numpy_params(dict(LM_CFG, dtype=dtype), 0))
    ratio = len(_read(tpath, "params.bin")) / len(_read(plain, "params.bin"))
    assert ratio < (0.67 if dtype == "bfloat16" else 0.34), ratio


@pytest.mark.parametrize("dtype", DTYPES)
def test_each_package_loads_the_others_int8_artifact(tmp_path, dtype):
    jpath, tpath, _cfg = _write_both(tmp_path, dtype)
    for path in (jpath, tpath):
        _jm, jraw = jreg.load_artifact(path, raw_quant=True)
        _tm, traw = treg.load_artifact(path, raw_quant=True)
        want = _quant_leaves(jraw, jreg.QuantLeaf)
        got = _quant_leaves(traw, treg.QuantLeaf)
        assert sorted(got) == sorted(want) and len(got) == 11
        for name, ql in got.items():
            assert ql.q.dtype == torch.int8 and ql.scale.dtype == torch.float32, name
            assert ql.orig_dtype == want[name].orig_dtype == dtype
            assert tuple(ql.scale.shape) == (1, ql.q.shape[-1]), name
            assert _u8(ql.q) == _u8(want[name].q) and _u8(ql.scale) == _u8(want[name].scale)
            host = ql.dequant_host()
            assert host.dtype == treg.torch_dtype(dtype)
            assert _u8(host) == _u8(want[name].dequant_host()), name
        # the default load dequantizes on the host, the reference's leaves bit for bit
        jflat = dict(treg.flatten_params(jreg.load_artifact(path)[1]))
        tflat = dict(treg.flatten_params(treg.load_artifact(path)[1]))
        assert sorted(jflat) == sorted(tflat)
        for name, leaf in tflat.items():
            assert _u8(leaf) == _u8(jflat[name]), name
    # the pinned-out edges: the zero channel's floor and the halves to even
    _tm, traw = treg.load_artifact(tpath, raw_quant=True)
    embed = traw["embed"]
    assert float(embed.scale[0, 0]) == np.float32(1e-12) and not embed.q[:, 0].any()
    assert embed.q[:7, 1].tolist() == [127, 0, 2, 2, 0, -2, -2]
    assert float(embed.scale[0, 1]) == 1.0


def test_port_export_of_an_int8_artifact_loads_in_the_reference(tmp_path):
    path = treg.export_artifact("transformer_lm", str(tmp_path), name="m", seed=3,
                                config=dict(LM_CFG, dtype="bfloat16"), device="cpu",
                                quantize="int8")
    _jm, jparams = jreg.load_artifact(path)
    _tm, tparams = treg.load_artifact(path)
    jflat = dict(treg.flatten_params(jparams))
    for name, leaf in treg.flatten_params(tparams):
        assert _u8(leaf) == _u8(jflat[name]), name
    assert jreg.load_artifact_meta(path)["quantize"] == "int8"


# the per-tenant families at sizes where some leaves reach the int8 floor:
# bert's word_emb, w1 and w2 (65536 elements); resnet's 3x3 convs of the
# last two stages (HWIO kernels, one scale per output channel); t5's embed
# and every feed-forward weight (bf16 storage, as the family writes it)
CLASSIFIERS = {
    "bert": {"vocab_size": 1024, "hidden": 64, "n_layers": 2, "n_heads": 4, "d_ff": 1024,
             "max_seq": 64, "type_vocab": 2, "num_labels": 3, "dtype": "bfloat16"},
    "resnet": {"depth": 18, "num_classes": 10, "width": 16, "image_size": 32},
    "t5": {"vocab_size": 1024, "d_model": 64, "n_layers": 2, "n_heads": 4, "d_ff": 1024,
           "rel_buckets": 8, "rel_max_dist": 32, "dtype": "bfloat16"},
}


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", sorted(CLASSIFIERS))
def test_classifier_artifacts_are_the_references(tmp_path, family, dtype, quantize):
    """bert and resnet, from the same seeded weights (f32, or each leaf
    rounded to bf16): the port's ``params.bin`` and ``model.json`` are the
    reference's byte for byte, plain and int8, and the port's raw load
    gives the reference's int8 leaves."""
    cfg = CLASSIFIERS[family]
    tree = treg.build(family, cfg).init(torch.Generator().manual_seed(4))
    if dtype == "bfloat16":
        tree = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), tree)
    params = jax.tree_util.tree_map(
        lambda t: t.numpy() if t.dtype == torch.float32 else
        t.view(torch.uint16).numpy().view(jnp.bfloat16), tree)
    jpath = jreg.save_artifact(str(tmp_path / "j"), jreg.build(family, cfg), params,
                               quantize=quantize)
    tpath = treg.save_artifact(str(tmp_path / "t"), treg.build(family, cfg),
                               treg.params_from_jax(params), quantize=quantize)
    for name in ("params.bin", "model.json"):
        assert _read(tpath, name) == _read(jpath, name), name
    _jm, jraw = jreg.load_artifact(jpath, raw_quant=True)
    _tm, traw = treg.load_artifact(tpath, raw_quant=True)
    want = _quant_leaves(jraw, jreg.QuantLeaf)
    got = _quant_leaves(traw, treg.QuantLeaf)
    assert sorted(got) == sorted(want) and (len(got) > 0) == (quantize == "int8")
    for path, leaf in got.items():
        assert _u8(leaf.q) == _u8(want[path].q) and _u8(leaf.scale) == _u8(want[path].scale)
        assert tuple(leaf.scale.shape)[-1] == tuple(leaf.q.shape)[-1]  # the output axis


@pytest.mark.parametrize("dtype", DTYPES)
def test_resave_of_a_raw_quant_tree_carries_the_leaves(tmp_path, dtype):
    """A re-save (the reference's ``cli repack``) writes every ``QuantLeaf``
    as it is: the same q, scale and orig dtype, nothing quantized again.
    Carried leaves sort as "int8" where the source's quantized-on-the-fly
    leaves sorted by their float dtype, so the file order differs from the
    source's and is the reference's re-save's byte for byte; a second
    re-save writes the first one's bytes."""
    jpath, tpath, cfg = _write_both(tmp_path, dtype)
    _tm, traw = treg.load_artifact(tpath, raw_quant=True)
    out = treg.save_artifact(str(tmp_path / "resave"), treg.build("transformer_lm", cfg), traw)
    _jm, jraw = jreg.load_artifact(jpath, raw_quant=True)
    jout = jreg.save_artifact(str(tmp_path / "jresave"), jreg.build("transformer_lm", cfg), jraw)
    assert _read(out, "params.bin") == _read(jout, "params.bin")
    assert _read(out, "model.json") == _read(jout, "model.json")
    _tm, again = treg.load_artifact(out, raw_quant=True)
    src, got = _quant_leaves(traw, treg.QuantLeaf), _quant_leaves(again, treg.QuantLeaf)
    assert sorted(got) == sorted(src)
    for name, ql in got.items():
        assert torch.equal(ql.q, src[name].q) and torch.equal(ql.scale, src[name].scale)
        assert ql.orig_dtype == src[name].orig_dtype
    twice = treg.save_artifact(str(tmp_path / "twice"), treg.build("transformer_lm", cfg), again)
    assert _read(twice, "params.bin") == _read(out, "params.bin")
    assert _read(twice, "model.json") == _read(out, "model.json")
    with open(os.path.join(tpath, "model.json")) as a, open(os.path.join(out, "model.json")) as b:
        src_ents = {e["path"]: e for e in json.load(a)["params"]["manifest"]}
        out_ents = {e["path"]: e for e in json.load(b)["params"]["manifest"]}
    drop = lambda e: {k: v for k, v in e.items() if k not in ("offset", "quant")}  # noqa: E731
    assert {p: drop(e) for p, e in src_ents.items()} == {p: drop(e) for p, e in out_ents.items()}


def test_resident_estimate_exceeds_the_int8_file(tmp_path):
    jpath, tpath, cfg = _write_both(tmp_path, "bfloat16")
    plain = treg.save_artifact(str(tmp_path / "plain"), treg.build("transformer_lm", cfg),
                               treg.params_from_jax(_numpy_params(cfg, 0)))
    est = treg.resident_bytes_estimate(tpath)
    assert est == treg.resident_bytes_estimate(plain) == jreg.resident_bytes_estimate(jpath)
    assert est > 1.4 * len(_read(tpath, "params.bin"))


# -- the runtime --------------------------------------------------------------

@pytest.fixture(scope="module")
def qstore(tmp_path_factory):
    base = tmp_path_factory.mktemp("qstore")
    jreg.export_artifact("transformer_lm", str(base), name="q", version=1, config=QCFG,
                         seed=0, quantize="int8")
    return base


def _qmodel(qstore) -> Model:
    return Model(ModelId("q", 1), os.path.join(str(qstore), "q", "1"), 0)


@pytest.fixture()
def dequant_calls(monkeypatch):
    calls = []
    real = mr._dequantize_on_device

    def spy(params):
        calls.append(sum(isinstance(v, treg.QuantLeaf) for _p, v in treg.flatten_params(params)))
        return real(params)

    monkeypatch.setattr(mr, "_dequantize_on_device", spy)
    return calls


def _params(rt, mid) -> dict:
    return dict(treg.flatten_params(rt._resident.get(mid, touch=False).params))


def _stages(tier: str) -> list[str]:
    (load,) = [t for t in TRACER.query(n=16) if t["name"] == "load"
               and t["attrs"]["tier"] == tier]
    return [c["name"] for c in load["children"]]


def test_three_load_paths_give_the_same_params(qstore, monkeypatch, tmp_path, dequant_calls):
    """Serialized, pipelined (several chunks a dtype) and a promotion of the
    pipelined load's retained int8 entry: ``torch.equal`` params, the host
    dequant's, each through ``_dequantize_on_device`` (11 quantized leaves),
    each with its ``device_dequant`` stage."""
    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", SMALL_CHUNK)
    m = _qmodel(qstore)
    want = dict(treg.flatten_params(treg.load_artifact(m.path)[1]))
    got = {}
    with confined_globals(tmp_path / "flight"):
        for arm, cfg in (("serialized", ServingConfig(cold_load_pipeline=False)),
                         ("pipelined", ServingConfig())):
            rt = mr.TorchModelRuntime(cfg, device="cpu", host_tier_bytes=1 << 26)
            try:
                TRACER.clear()
                dequant_calls.clear()
                assert rt.ensure_loaded(m) == "disk"
                assert sum(dequant_calls) == 11
                assert _stages("disk")[:3] == ["artifact_read", "device_transfer",
                                               "device_dequant"]
                got[arm] = _params(rt, m.identifier)
                entry = rt._host_tier.get(m.identifier)
                assert len(entry.quant_dtypes) == 11
                if arm == "pipelined":
                    assert len(entry.chunks) > 3  # the int8 group cut into chunks
                    rt.unload(m.identifier)
                    rt.drain_demotions()
                    dequant_calls.clear()
                    assert rt.ensure_loaded(m) == "host"
                    assert sum(dequant_calls) == 11
                    assert "device_dequant" in _stages("host")
                    got["promoted"] = _params(rt, m.identifier)
            finally:
                rt.close()
    for arm, params in got.items():
        assert sorted(params) == sorted(want), arm
        for name, leaf in params.items():
            assert leaf.dtype == want[name].dtype and torch.equal(leaf, want[name]), (arm, name)


def test_a_bf16_artifact_has_no_dequant_stage(tmp_path, dequant_calls):
    jreg.export_artifact("transformer_lm", str(tmp_path), name="p", version=1, config=QCFG,
                         seed=0)
    with confined_globals(tmp_path / "flight"):
        rt = mr.TorchModelRuntime(ServingConfig(cold_load_pipeline=False), device="cpu")
        try:
            rt.ensure_loaded(Model(ModelId("p", 1), str(tmp_path / "p" / "1"), 0))
            assert "device_dequant" not in _stages("disk")
        finally:
            rt.close()
    assert sum(dequant_calls) == 0


def _jax_reference(path: str, ids: np.ndarray, n_new: int):
    jrt = jmr.TPUModelRuntime(JServingConfig(platform="cpu"))
    jmid = JModelId("q", 1)
    try:
        jrt.ensure_loaded(JModel(jmid, path, 0))
        logits = np.asarray(jrt.predict(jmid, {"input_ids": ids}, output_filter=["logits"])
                            ["logits"], np.float32)
        tokens = np.asarray(jrt.generate(jmid, ids, max_new_tokens=n_new))
    finally:
        jrt.close()
    return logits, tokens


def test_predict_and_greedy_tokens_agree_with_the_jax_runtime(qstore):
    m = _qmodel(qstore)
    ids = np.random.default_rng(1).integers(1, QCFG["vocab_size"], (2, 16)).astype(np.int32)
    n_new = 8
    want, want_tok = _jax_reference(m.path, ids, n_new)
    rt = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        rt.ensure_loaded(m)
        got = np.asarray(rt.predict(m.identifier, {"input_ids": ids}, output_filter=["logits"])
                         ["logits"], np.float32)
        got_tok = np.asarray(rt.generate(m.identifier, ids, max_new_tokens=n_new))
    finally:
        rt.close()
    assert got.shape == want.shape == (2, 16, QCFG["vocab_size"])
    diff = np.abs(got - want)
    assert diff.max() <= BF16_TOL
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * diff.max(axis=-1)
    assert decided.mean() > 0.5
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()
    # greedy: identical up to a first divergence at a near-tie of the JAX model
    jdef, jparams = jreg.load_artifact(m.path)
    assert got_tok.shape == want_tok.shape == (2, n_new)
    for b in range(2):
        diverge = np.nonzero(got_tok[b] != want_tok[b])[0]
        if not diverge.size:
            continue
        i = int(diverge[0])
        seq = np.concatenate([ids[b], want_tok[b, :i]])[None]
        logits = np.asarray(jdef.apply(jparams, {"input_ids": jnp.asarray(seq)})["logits"],
                            np.float32)[0, -1]
        top = logits.max()
        assert top - logits[got_tok[b, i]] <= TIE_TOL and top - logits[want_tok[b, i]] <= TIE_TOL, (
            f"row {b} diverges at token {i} off a near-tie")


RING_Q = {"vocab_size": 512, "d_model": 128, "n_layers": 1, "n_heads": 4, "n_kv_heads": 4,
          "d_ff": 256, "max_seq": 64, "attention": "ring", "dtype": "bfloat16"}


@pytest.mark.parametrize("name,config,devices", [
    ("q", QCFG, ["cpu"]),
    ("ringq", RING_Q, ["cpu"] * 2),
])
def test_a_group_runtime_ships_raw_int8(qstore, tmp_path, dequant_calls, name, config, devices):
    """A runtime bound to a device group whose rules cut nothing (a group of
    one, a ring model) pipelines its load onto the leader as one device
    does: it ships the raw int8 bytes and dequantizes on the device, as the
    reference's rule-less mesh runtime does (tests/test_quant.py): the
    params are the one-device pipelined load's, and so are the logits."""
    path = (jreg.export_artifact("transformer_lm", str(tmp_path), name=name, version=1,
                                 config=config, seed=4, quantize="int8")
            if name != "q" else _qmodel(qstore).path)
    m = Model(ModelId(name, 1), path, 0)
    ids = np.random.default_rng(2).integers(1, config["vocab_size"], (1, 8)).astype(np.int32)
    group = mr.TorchModelRuntime(ServingConfig(), device="cpu", devices=devices)
    one = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        assert group.cold_pipeline_enabled
        group.ensure_loaded(m)
        assert sum(dequant_calls) >= 1
        one.ensure_loaded(m)
        gp, op = _params(group, m.identifier), _params(one, m.identifier)
        assert all(torch.equal(gp[k], op[k]) for k in op)
        got = group.predict(m.identifier, {"input_ids": ids}, output_filter=["logits"])["logits"]
        want = one.predict(m.identifier, {"input_ids": ids}, output_filter=["logits"])["logits"]
        np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                                   rtol=0, atol=BF16_TOL)
    finally:
        group.close()
        one.close()


@pytest.mark.parametrize("family", sorted(CLASSIFIERS))
def test_the_port_serves_the_references_int8_classifiers(tmp_path, family):
    """The reference's int8 bert / resnet / t5 artifact, loaded raw by the
    port's runtime and dequantized on the device (here the CPU), answers
    exactly as the port's module on the host-dequantized weights (the same
    f32 products ``q * scale``), and as the JAX runtime does within the
    family's bf16 bound (tests/test_torch_{bert,resnet,t5}.py)."""
    cfg = CLASSIFIERS[family]
    params = jax.tree_util.tree_map(
        lambda t: t.numpy(), treg.build(family, cfg).init(torch.Generator().manual_seed(6)))
    path = jreg.save_artifact(str(tmp_path / "q" / "1"), jreg.build(family, cfg), params,
                              quantize="int8")
    rng = np.random.default_rng(6)
    if family == "bert":
        inputs = {"input_ids": rng.integers(0, cfg["vocab_size"], (3, 20)).astype(np.int32),
                  "attention_mask": np.ones((3, 20), np.int32)}
        inputs["attention_mask"][1:, 12:] = 0
        tol = 2.0**-5  # measured ~0.005
    elif family == "t5":
        inputs = {"input_ids": rng.integers(1, cfg["vocab_size"], (3, 20)).astype(np.int32),
                  "decoder_input_ids": rng.integers(0, cfg["vocab_size"], (3, 7))
                  .astype(np.int32)}
        inputs["input_ids"][1:, 12:] = 0
        tol = 2.0**-4  # tests/test_torch_t5.py's bf16 bound
    else:
        inputs = {"image": rng.standard_normal((3, 32, 32, 3)).astype(np.float32)}
        tol = 2.0**-3  # a random-weight depth-18 net's bf16 noise: measured ~0.06
    port = mr.TorchModelRuntime(ServingConfig(), device="cpu")
    ref = jmr.TPUModelRuntime(JServingConfig(platform="cpu"))
    try:
        port.ensure_loaded(Model(identifier=ModelId("q", 1), path=path))
        ref.ensure_loaded(JModel(identifier=JModelId("q", 1), path=path))
        got = port.predict(ModelId("q", 1), inputs)
        model_def, host = treg.load_artifact(path)
        with torch.inference_mode():
            plain = model_def.make_module(host)({k: torch.from_numpy(v)
                                                 for k, v in inputs.items()})
        np.testing.assert_array_equal(got["logits"], plain["logits"].numpy())
        want = ref.predict(JModelId("q", 1), inputs)
        assert np.abs(got["logits"] - np.asarray(want["logits"])).max() <= tol
    finally:
        port.close()
        ref.close()
