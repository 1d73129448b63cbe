"""The port's resnet (tfservingcache_tpu_torch/models/resnet.py) against the
JAX package's flax modules, on the CPU.

Configs: the reference's TINY_CONFIG (depth 18, basic blocks, width 8, image
32, 10 classes) and the bottleneck path at depth 50, width 32 (GroupNorm(32)
needs 32 channels), image 32, 10 classes (5.9 M params). Weights are the
port's ``init`` on a seeded CPU generator, fed to both packages as numpy
(flax's own init of a depth-50 tree runs eagerly for tens of seconds); the
single-block and stem checks draw GroupNorm scales and biases at random too,
so that both are exercised. Inputs come from ``numpy.random.default_rng``.
Tolerances:
  - f32 (a block at stride 1 and 2 on even and odd sizes, the stem and max
    pool, the whole model): 1e-4, the same math in another summation order
    (measured <= 5e-5 on the depth-50 logits, |x| <= ~5). These checks pin
    XLA's asymmetric SAME padding and flax's GroupNorm;
  - bf16 (the served model): logits within twice the reference's own bf16
    error against its f32 forward, plus 2**-5. Random weights carry no
    normalizing training, so a bf16 ulp flipped early grows through the
    blocks: the reference's bf16 logits sit 0.06 (depth 18) to 0.25 (depth
    50) from its f32 ones, and the port's bf16 logits as far from the
    reference's; ``classes`` equal on every row whose top-2 margin exceeds
    twice that row's max |diff| (the rule of tests/test_torch_families.py).
"""

import json
import urllib.error
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models import resnet as jres
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import resnet as tres
from tfservingcache_tpu_torch.server import build_node

TINY = jres.TINY_CONFIG
D50 = {"depth": 50, "num_classes": 10, "width": 32, "image_size": 32}
F32_TOL = 1e-4


def _randomize(tree, seed: int):
    """The abstract tree ``jax.eval_shape`` gives, filled with seeded numpy
    values: kernels N(0, 1/fan_in), GroupNorm scales around 1, biases around
    0 (all f32)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# -- one block, the stem, the padding (f32) ---------------------------------------

BLOCKS = [
    # (flax class, filters, input channels, stride): identity and projection
    # shortcuts, the stride on the 3x3 conv (bottleneck) or the first (basic)
    ("bottleneck", 32, 128, 1),
    ("bottleneck", 32, 64, 1),
    ("bottleneck", 32, 64, 2),
    ("basic", 16, 16, 1),
    ("basic", 16, 8, 2),
]


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("kind,filters,cin,stride", BLOCKS,
                         ids=[f"{k}-c{c}-s{s}" for k, _f, c, s in BLOCKS])
def test_block_matches_flax_f32(kind, filters, cin, stride, size):
    cls = jres._BottleneckBlock if kind == "bottleneck" else jres._BasicBlock
    block = cls(filters, strides=stride, dtype=jnp.float32)
    x = np.random.default_rng(size + stride).standard_normal((2, size, size, cin)).astype(
        np.float32)
    params = _randomize(jax.eval_shape(block.init, jax.random.PRNGKey(0), x)["params"],
                        size * 10 + cin)
    want = np.asarray(jax.jit(lambda p, a: block.apply({"params": p}, a))(params, x))
    port = tres.Block(treg.params_from_jax(params), kind == "bottleneck", stride, torch.float32)
    proj = "Conv_3" if kind == "bottleneck" else "Conv_2"
    assert (port.proj is not None) == (proj in params) == (cin != filters * (
        4 if kind == "bottleneck" else 1) or stride != 1)
    with torch.inference_mode():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL


class _FlaxStem(fnn.Module):
    """The reference's stem, _ResNet.__call__'s first lines
    (tfservingcache_tpu/models/resnet.py:91-93), in f32."""

    width: int

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(self.width, (7, 7), strides=(2, 2), use_bias=False, dtype=jnp.float32)(x)
        x = fnn.relu(fnn.GroupNorm(num_groups=min(32, self.width), dtype=jnp.float32)(x))
        return fnn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")


@pytest.mark.parametrize("size,width", [(8, 8), (7, 8), (32, 64), (224, 8)])
def test_stem_and_max_pool_match_flax_f32(size, width):
    """The 7x7/2 conv pads (2, 3) at 224 and 32, the -inf max pool (0, 1) at
    even sizes; odd sizes pad symmetrically."""
    stem = _FlaxStem(width)
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    params = _randomize(jax.eval_shape(stem.init, jax.random.PRNGKey(0), x)["params"], size)
    want = np.asarray(jax.jit(lambda p, a: stem.apply({"params": p}, a))(params, x))
    port = tres.Stem(treg.params_from_jax(params), width, torch.float32)
    with torch.inference_mode():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("n", [1, 7, 8, 32, 56, 112, 224])
@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (3, 1), (1, 2), (1, 1)])
def test_same_padding_is_xlas(n, k, stride):
    want = jax.lax.padtype_to_pads((n, n), (k, k), (stride, stride), "SAME")
    got = tres.same_pad(torch.zeros(1, 1, n, n), k, stride)
    lo, hi = want[0]
    assert got.shape[-2:] == (n + lo + hi, n + lo + hi)
    marked = tres.same_pad(torch.ones(1, 1, n, n), k, stride)
    # the ones lie at [lo, lo + n) on both axes
    assert marked[0, 0, lo:lo + n, lo:lo + n].all() and marked.sum() == n * n


# -- the whole model -------------------------------------------------------------

def _flax_resnet(cfg: dict, dtype) -> jres._ResNet:
    return jres._ResNet(stage_sizes=jres._STAGES[cfg["depth"]], num_classes=cfg["num_classes"],
                        width=cfg["width"], bottleneck=cfg["depth"] >= 50, dtype=dtype)


def _both(cfg: dict, seed: int, batch: int = 8):
    params = treg.build("resnet", cfg).init(torch.Generator().manual_seed(seed))
    jparams = jax.tree_util.tree_map(lambda t: t.numpy(), params)
    size = cfg["image_size"]
    images = np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(
        np.float32)
    return params, jparams, images


def _flax_logits(cfg, dtype, jparams, images) -> np.ndarray:
    module = _flax_resnet(cfg, dtype)
    return np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x))(jparams, images))


def _hold_bf16(cfg, jparams, images, got_logits, got_classes, want) -> None:
    """The served bf16 logits against the reference's ``apply``: within twice
    the reference's own bf16 error against its f32 forward plus 2**-5;
    classes equal off near-ties."""
    wl = np.asarray(want["logits"])
    ref_err = np.abs(wl - _flax_logits(cfg, jnp.float32, jparams, images)).max()
    assert got_logits.dtype == np.float32 and got_logits.shape == wl.shape
    diff = np.abs(got_logits - wl)
    assert diff.max() <= 2 * ref_err + 2.0**-5, (diff.max(), ref_err)
    top2 = np.sort(wl, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * diff.max(axis=-1)
    assert decided.mean() >= 0.5
    assert (np.asarray(got_classes) == np.asarray(want["classes"]))[decided].all()


@pytest.mark.parametrize("cfg", [TINY, D50], ids=["tiny", "depth50"])
def test_whole_model_f32_matches_flax(cfg):
    params, jparams, images = _both(cfg, 5)
    want = _flax_logits(cfg, jnp.float32, jparams, images)
    with torch.inference_mode():
        got = tres.ResNet(params, cfg, torch.float32)({"image": torch.from_numpy(images)})
    assert np.abs(got["logits"].numpy() - want).max() <= F32_TOL


@pytest.mark.parametrize("cfg,seed", [(TINY, 0), (TINY, 1), (TINY, 2), (D50, 0)],
                         ids=["tiny-0", "tiny-1", "tiny-2", "depth50-0"])
def test_bf16_model_matches_the_reference(cfg, seed):
    """The served model (``make_module``, bf16) against the reference's
    ``apply``, within the tolerance the module docstring states."""
    params, jparams, images = _both(cfg, seed)
    want = jax.jit(jreg.build("resnet", cfg).apply)(jparams, {"image": jnp.asarray(images)})
    with torch.inference_mode():
        got = treg.build("resnet", cfg).make_module(params)({"image": torch.from_numpy(images)})
    assert got["classes"].dtype == torch.int32
    _hold_bf16(cfg, jparams, images, got["logits"].numpy(), got["classes"].numpy(), want)


# -- the family's definition ---------------------------------------------------

def test_unsupported_depth_raises_the_references_error():
    with pytest.raises(ValueError) as want:
        jreg.build("resnet", {"depth": 42})
    with pytest.raises(ValueError) as got:
        treg.build("resnet", {"depth": 42})
    assert str(got.value) == str(want.value)
    assert "unsupported resnet depth 42" in str(got.value)


@pytest.mark.parametrize("cfg", [TINY, D50, jres.DEFAULT_CONFIG],
                         ids=["tiny", "depth50", "default"])
def test_model_def_and_init_tree_are_the_references(cfg):
    """Specs as the reference's; the port's ``init`` gives flax's tree:
    paths (the projection shortcut only where a block changes shape), shapes
    and dtypes (from ``jax.eval_shape`` of the reference's init)."""
    jm, tm = jreg.build("resnet", cfg), treg.build("resnet", cfg)
    assert tm.family == jm.family == "resnet" and tm.config == jm.config
    for spec in ("input_spec", "output_spec"):
        assert {k: (v.dtype, tuple(v.shape)) for k, v in getattr(tm, spec).items()} == {
            k: (v.dtype, tuple(v.shape)) for k, v in getattr(jm, spec).items()}
    assert tm.axis_caps == jm.axis_caps == {} and tm.store_param_dtype is None
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    wflat = [(p, tuple(v.shape), np.dtype(v.dtype)) for p, v in treg.flatten_params(want)]
    got = tm.init(torch.Generator().manual_seed(0))
    gflat = [(p, tuple(v.shape), np.dtype(str(v.dtype).removeprefix("torch.")))
             for p, v in treg.flatten_params(got)]
    assert gflat == wflat


# -- REST -------------------------------------------------------------------------

def test_rest_predict_answers_the_jax_runtimes_outputs(tmp_path):
    """A port-written artifact served by a port node over REST, against the
    JAX runtime on the same artifact."""
    path = treg.export_artifact("resnet", str(tmp_path / "store"), name="rn", config=TINY,
                                seed=3, device="cpu")
    node = build_node(config_from_dict({
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"type": "disk", "base_dir": str(tmp_path / "store")},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    }), device="cpu")
    ref = TPUModelRuntime(JConfig(platform="cpu"))
    try:
        url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/rn/versions/1:predict"
        images = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
        req = urllib.request.Request(url, method="POST", data=json.dumps(
            {"instances": images.tolist()}).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                status, body = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        assert status == 200, body
        ref.ensure_loaded(JModel(identifier=JModelId("rn", 1), path=path))
        want = ref.predict(JModelId("rn", 1), {"image": images})
        rows = body["predictions"]
        _hold_bf16(TINY, jreg.load_artifact(path)[1], images,
                   np.asarray([r["logits"] for r in rows], np.float32),
                   [r["classes"] for r in rows], want)
    finally:
        node.close()
        ref.close()
