"""The port's GPipe schedule (tfservingcache_tpu_torch/parallel/pipeline.py)
against the JAX package's ``pipeline_apply`` on the virtual 8-device CPU
mesh (tests/conftest.py), mirroring tests/test_parallel.py's pipeline tests.

Four stages of ``tanh(x @ w + b)`` at width 16, f32 weights and inputs made
from ``numpy.random.default_rng`` and fed to both packages; the port runs
on a group of four copies of the CPU device. Tolerance 1e-5 (the same f32
math in both frameworks; the reference test's own bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.parallel.mesh import make_mesh
from tfservingcache_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from tfservingcache_tpu.parallel.pipeline import stack_stage_params as jax_stack
from tfservingcache_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

DIM = 16
GROUP = ["cpu"] * 4


def _stages(seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((DIM, DIM)) / 4).astype(np.float32),
             "b": (rng.standard_normal(DIM) / 4).astype(np.float32)} for _ in range(4)]


def _torch_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_matches_the_jax_pipeline_and_the_sequential_chain(n_micro):
    stages = _stages()
    x = np.random.default_rng(1).standard_normal((8, DIM)).astype(np.float32)
    want = np.asarray(jax_pipeline_apply(
        _jax_stage, jax_stack([jax.tree_util.tree_map(jnp.asarray, s) for s in stages]),
        jnp.asarray(x), make_mesh({"stage": 4}), n_microbatches=n_micro))
    stacked = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                                  for s in stages])
    assert stacked["w"].shape == (4, DIM, DIM)
    got = pipeline_apply(_torch_stage, stacked, torch.from_numpy(x), GROUP,
                         n_microbatches=n_micro)
    assert got.dtype == torch.float32 and got.device == torch.device("cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    chain = torch.from_numpy(x)
    for s in stages:
        chain = _torch_stage({k: torch.from_numpy(v) for k, v in s.items()}, chain)
    np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=1e-5, atol=1e-5)


def test_pipeline_runs_each_microbatch_once_a_stage_in_schedule_order():
    """GPipe's lockstep: stage i sees microbatch t - i at tick t, each
    microbatch once, and every stage's input is the previous stage's output."""
    seen = []

    def stage_fn(p, x):
        seen.append((int(p["i"]), int(x[0, 0])))
        return x + 1

    stacked = stack_stage_params([{"i": torch.tensor(i)} for i in range(4)])
    x = torch.arange(6, dtype=torch.float32)[:, None] * torch.tensor([10.0, 1.0])  # row m: 10 m
    out = pipeline_apply(stage_fn, stacked, x, GROUP, n_microbatches=6)
    np.testing.assert_array_equal(out.numpy(), (x + 4).numpy())
    want = [(i, 10 * (t - i) + i) for t in range(6 + 3) for i in range(4) if 0 <= t - i < 6]
    assert seen == want


def test_pipeline_rejects_indivisible_batch():
    stacked = stack_stage_params([{"w": torch.eye(4)} for _ in range(4)])
    with pytest.raises(ValueError, match="not divisible into 4 microbatches"):
        pipeline_apply(lambda p, x: x @ p["w"], stacked, torch.ones(6, 4), GROUP,
                       n_microbatches=4)


def test_pipeline_rejects_stage_count_mismatch():
    stacked = stack_stage_params([{"w": torch.eye(4)} for _ in range(8)])
    with pytest.raises(ValueError, match="mesh stages"):
        pipeline_apply(lambda p, x: x @ p["w"], stacked, torch.ones(8, 4), GROUP,
                       n_microbatches=4)


def test_pipeline_rejects_no_microbatches():
    stacked = stack_stage_params([{"w": torch.eye(4)} for _ in range(4)])
    with pytest.raises(ValueError, match="n_microbatches must be >= 1"):
        pipeline_apply(lambda p, x: x @ p["w"], stacked, torch.ones(8, 4), GROUP,
                       n_microbatches=0)
