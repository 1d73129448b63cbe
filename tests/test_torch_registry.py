"""``tpusc.v2`` artifacts cross between the packages: JAX-written artifacts
load in the port leaf-for-leaf byte-identical, port-written artifacts load in
the JAX package, and both writers produce the same bytes for the same
params. Small config: 2 layers, d_model 128, 4 heads / 2 KV heads, vocab 512.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models.transformer_lm import params_from_jax

SMALL = {"vocab_size": 512, "d_model": 128, "n_layers": 2, "n_heads": 4,
         "n_kv_heads": 2, "d_ff": 256}
DTYPES = ["float32", "bfloat16"]


def _leaf_bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def _flat(tree) -> dict[str, object]:
    return dict(treg.flatten_params(tree))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_artifact_loads_in_the_port_byte_identical(tmp_path, dtype):
    path = jreg.export_artifact(
        "transformer_lm", str(tmp_path), name="lm", config=dict(SMALL, dtype=dtype), seed=3
    )
    _jm, jparams = jreg.load_artifact(path)
    tm, tparams = treg.load_artifact(path)
    assert tm.family == "transformer_lm" and tm.config == _jm.config
    jflat, tflat = _flat(jparams), _flat(tparams)
    assert sorted(jflat) == sorted(tflat)
    for name, jleaf in jflat.items():
        tleaf = tflat[name]
        assert tuple(tleaf.shape) == tuple(np.shape(jleaf)), name
        assert treg.dtype_name(tleaf.dtype) == np.asarray(jleaf).dtype.name, name
        assert _leaf_bytes(tleaf) == _leaf_bytes(jleaf), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_artifact_loads_in_jax(tmp_path, dtype):
    path = treg.export_artifact(
        "transformer_lm", str(tmp_path), name="lm", config=dict(SMALL, dtype=dtype), seed=4,
        device="cpu",
    )
    jm, jparams = jreg.load_artifact(path)
    _tm, tparams = treg.load_artifact(path)
    assert jm.family == "transformer_lm"
    assert jm.config == jreg.build("transformer_lm", dict(SMALL, dtype=dtype)).config
    jflat, tflat = _flat(jparams), _flat(tparams)
    assert sorted(jflat) == sorted(tflat)
    for name, tleaf in tflat.items():
        assert _leaf_bytes(jflat[name]) == _leaf_bytes(tleaf), name
    with open(os.path.join(path, "model.json")) as f:
        meta = json.load(f)
    assert meta["format"] == "tpusc.v2" and meta["param_dtype"] == dtype
    assert {e["dtype"] for e in meta["params"]["manifest"]} == {dtype}


@pytest.mark.parametrize("dtype", DTYPES)
def test_both_writers_write_the_same_bytes(tmp_path, dtype):
    cfg = dict(SMALL, dtype=dtype)
    params = jax.device_get(jreg.build("transformer_lm", cfg).init(jax.random.PRNGKey(5)))
    jpath = jreg.save_artifact(str(tmp_path / "j"), jreg.build("transformer_lm", cfg), params)
    tpath = treg.save_artifact(
        str(tmp_path / "t"), treg.build("transformer_lm", cfg), params_from_jax(params)
    )
    with open(os.path.join(jpath, "params.bin"), "rb") as a, \
            open(os.path.join(tpath, "params.bin"), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(jpath, "model.json")) as a, open(os.path.join(tpath, "model.json")) as b:
        jmeta, tmeta = json.load(a), json.load(b)
    assert jmeta["params"]["manifest"] == tmeta["params"]["manifest"]
    assert jmeta["signature"] == tmeta["signature"]
    assert jmeta["config"] == tmeta["config"]


def test_int8_artifact_is_refused_clearly(tmp_path):
    path = jreg.export_artifact(
        "transformer_lm", str(tmp_path), name="lm",
        config=dict(SMALL, d_model=256, d_ff=512, dtype="float32"), seed=0, quantize="int8",
    )
    with pytest.raises(treg.ArtifactError, match="int8 artifacts: later slice"):
        treg.load_artifact(path)
    with pytest.raises(treg.ArtifactError, match="int8"):
        treg.save_artifact(str(tmp_path / "q"), treg.build("transformer_lm", SMALL), {},
                           quantize="int8")


def test_corrupt_manifest_and_missing_files_raise(tmp_path):
    path = treg.export_artifact("transformer_lm", str(tmp_path), name="lm",
                                config=dict(SMALL, dtype="float32"), device="cpu")
    meta_path = os.path.join(path, "model.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["params"]["manifest"][0]["nbytes"] += 4
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(treg.ArtifactError, match="corrupt manifest"):
        treg.load_artifact(path)
    with pytest.raises(treg.ArtifactError, match="no model.json"):
        treg.load_artifact(str(tmp_path / "nothing"))


def test_params_from_manifest_takes_numpy_bytes(tmp_path):
    path = treg.export_artifact("transformer_lm", str(tmp_path), name="lm",
                                config=dict(SMALL, dtype="bfloat16"), seed=6, device="cpu")
    with open(os.path.join(path, "model.json")) as f:
        meta = json.load(f)
    blob = np.fromfile(os.path.join(path, "params.bin"), dtype=np.uint8)
    from_np = _flat(treg.params_from_manifest(meta, blob))
    _m, loaded = treg.load_artifact(path)
    for name, leaf in _flat(loaded).items():
        assert torch.equal(from_np[name], leaf), name


def test_export_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    asked = []
    real_generator = torch.Generator

    def recording_generator(device="cpu"):
        asked.append(str(device))
        return real_generator(device="cpu")  # this machine may have no card

    monkeypatch.setattr(torch, "Generator", recording_generator)
    treg.export_artifact("transformer_lm", str(tmp_path), name="a",
                         config=dict(SMALL, dtype="float32"))
    treg.export_artifact("transformer_lm", str(tmp_path), name="b",
                         config=dict(SMALL, dtype="float32"), device="cpu")
    assert asked == ["cuda", "cpu"]
