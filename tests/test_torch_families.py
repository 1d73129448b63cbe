"""The port's half_plus_two and mnist_cnn families
(tfservingcache_tpu_torch/models/{half_plus_two,mnist_cnn}.py) against the
JAX package's, on the same params and inputs, and on artifacts the JAX
package wrote; the artifacts of bert, resnet and t5 too, at their
TINY_CONFIG (tests/test_torch_{bert,resnet,t5}.py hold their forwards).

Tolerances: half_plus_two is exact (y = 0.5 x + 2 in f32). mnist_cnn
computes in bf16 to f32 logits in both frameworks, which round at the same
points but fuse differently: logits within 2**-7 (a few bf16 ulps at the
logits' |x| < 1; measured ~2e-3 at width 32), and ``classes`` equal on every
row whose top-2 logit margin exceeds twice that row's max |diff| (the rule of
tests/test_torch_transformer_lm.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models.bert import TINY_CONFIG as BERT_TINY
from tfservingcache_tpu.models.resnet import TINY_CONFIG as RESNET_TINY
from tfservingcache_tpu.models.t5 import TINY_CONFIG as T5_TINY
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models.half_plus_two import reference_output

MNIST_TOL = 2.0**-7
# the artifact tests' config of each family (None: its default)
ARTIFACT_CONFIGS = {"bert": BERT_TINY, "resnet": RESNET_TINY, "t5": T5_TINY}
ARTIFACT_FAMILIES = ["half_plus_two", "mnist_cnn", "bert", "resnet", "t5"]


def _same_leaf(leaf: torch.Tensor, want) -> None:
    """Bit for bit, dtype included; a bf16 leaf (t5 stores bf16) compares
    its bit patterns (numpy has no bf16 of its own)."""
    want = np.asarray(want)
    assert str(leaf.dtype).removeprefix("torch.") == want.dtype.name
    if leaf.dtype == torch.bfloat16:
        np.testing.assert_array_equal(leaf.view(torch.uint16).numpy(), want.view(np.uint16))
    else:
        np.testing.assert_array_equal(leaf.numpy(), want)


def _jax_params(family: str, seed: int, config=None):
    return jax.device_get(jreg.build(family, config).init(jax.random.PRNGKey(seed)))


def _torch_forward(family: str, params, inputs: dict, config=None) -> dict:
    module = treg.build(family, config).make_module(treg.params_from_jax(params))
    with torch.inference_mode():
        out = module({k: torch.from_numpy(v) for k, v in inputs.items()})
    return {k: v.numpy() for k, v in out.items()}


def _mnist_images(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 28, 28, 1), dtype=np.float32)


def _hold_mnist(got: dict, want: dict) -> None:
    wl = np.asarray(want["logits"])
    gl = got["logits"]
    assert gl.dtype == np.float32 and gl.shape == wl.shape
    assert got["classes"].dtype == np.int32
    diff = np.abs(gl - wl)
    assert diff.max() <= MNIST_TOL, diff.max()
    top2 = np.sort(wl, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * diff.max(axis=-1)
    assert decided.mean() >= 0.5
    assert (got["classes"] == np.asarray(want["classes"]))[decided].all()


@pytest.mark.parametrize("x", [[0.0], [1.0, 2.0, 3.0], [-7.5, 1e-3, 3.25e5, -0.0]])
def test_half_plus_two_is_exact(x):
    x = np.asarray(x, np.float32)
    params = _jax_params("half_plus_two", 0)
    want = np.asarray(jreg.build("half_plus_two").apply(params, {"x": jnp.asarray(x)})["y"])
    got = _torch_forward("half_plus_two", params, {"x": x})["y"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, reference_output(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mnist_logits_and_classes_match_flax(seed):
    params = _jax_params("mnist_cnn", seed)
    images = _mnist_images(seed, 16)
    want = jreg.build("mnist_cnn").apply(params, {"image": jnp.asarray(images)})
    _hold_mnist(_torch_forward("mnist_cnn", params, {"image": images}), want)


def test_mnist_flattens_in_nhwc_order():
    """The first dense kernel's rows are flax's NHWC feature order: a module
    that flattened NCHW features would still run, and only this comparison
    shows it. Permuting the rows to NCHW order must break the parity."""
    params = _jax_params("mnist_cnn", 3)
    images = _mnist_images(3, 8)
    want = np.asarray(jreg.build("mnist_cnn").apply(params, {"image": jnp.asarray(images)})["logits"])
    got = _torch_forward("mnist_cnn", params, {"image": images})["logits"]
    assert np.abs(got - want).max() <= MNIST_TOL
    # the same kernel read as if its rows were (C, H, W) ordered
    k = np.asarray(params["Dense_0"]["kernel"])
    nchw = k.reshape(7, 7, 64, 128).transpose(2, 0, 1, 3).reshape(-1, 128)
    wrong = dict(params, Dense_0={"kernel": nchw, "bias": params["Dense_0"]["bias"]})
    bad = _torch_forward("mnist_cnn", wrong, {"image": images})["logits"]
    assert np.abs(bad - want).max() > 10 * MNIST_TOL


def test_mnist_width_and_classes_follow_the_config():
    cfg = {"num_classes": 7, "width": 8}
    params = _jax_params("mnist_cnn", 4, cfg)
    images = _mnist_images(4, 4)
    want = jreg.build("mnist_cnn", cfg).apply(params, {"image": jnp.asarray(images)})
    got = _torch_forward("mnist_cnn", params, {"image": images}, cfg)
    assert got["logits"].shape == (4, 7)
    _hold_mnist(got, want)


@pytest.mark.parametrize("family", ARTIFACT_FAMILIES)
def test_reference_artifacts_load_in_the_port(tmp_path, family):
    """A ``tpusc.v2`` artifact the JAX package wrote loads in the port: the
    same params tree, leaf for leaf and bit for bit, and the same
    signature."""
    path = jreg.export_artifact(family, str(tmp_path), name="m", version=1, seed=5,
                                config=ARTIFACT_CONFIGS.get(family))
    jmodel, jparams = jreg.load_artifact(path)
    tmodel, tparams = treg.load_artifact(path)
    assert tmodel.family == family
    jflat = dict(treg.flatten_params(jparams))  # the reference's pytree order
    tflat = dict(treg.flatten_params(tparams))
    assert sorted(jflat) == sorted(tflat)
    for path_, leaf in tflat.items():
        _same_leaf(leaf, jflat[path_])
    for spec in ("input_spec", "output_spec"):
        assert {k: (v.dtype, tuple(v.shape)) for k, v in getattr(tmodel, spec).items()} == {
            k: (v.dtype, tuple(v.shape)) for k, v in getattr(jmodel, spec).items()}


def test_reference_mnist_artifact_serves_like_flax(tmp_path):
    path = jreg.export_artifact("mnist_cnn", str(tmp_path), name="m", version=1, seed=6)
    jmodel, jparams = jreg.load_artifact(path)
    tmodel, tparams = treg.load_artifact(path)
    images = _mnist_images(6, 8)
    want = jmodel.apply(jparams, {"image": jnp.asarray(images)})
    with torch.inference_mode():
        out = tmodel.make_module(tparams)({"image": torch.from_numpy(images)})
    _hold_mnist({k: v.numpy() for k, v in out.items()}, want)


@pytest.mark.parametrize("family", ARTIFACT_FAMILIES)
def test_port_artifacts_load_in_the_reference(tmp_path, family):
    """An artifact the port writes (random params from a seeded CPU
    generator) loads in the JAX package with the same leaves."""
    path = treg.export_artifact(family, str(tmp_path), name="m", version=1, seed=2,
                                config=ARTIFACT_CONFIGS.get(family), device="cpu")
    _tmodel, tparams = treg.load_artifact(path)
    jmodel, jparams = jreg.load_artifact(path)
    assert jmodel.family == family
    tflat = dict(treg.flatten_params(tparams))
    jflat = dict(treg.flatten_params(jparams))
    assert sorted(tflat) == sorted(jflat)
    for path_, leaf in tflat.items():
        _same_leaf(leaf, jflat[path_])
