"""The port's attention ops (tfservingcache_tpu_torch/ops/attention.py)
against the JAX package's on the same numpy inputs.

Tolerances: f32 1e-5 (the same math, summed in another order); bf16
outputs 2**-6 (one bf16 ulp at |x| in [2, 4), where N(0, 1) attention
outputs live); the Pallas flash kernel (interpret mode) 2**-5, since it
also rounds p to bf16 before p.v where the plain version keeps f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.ops import attention as jattn
from tfservingcache_tpu_torch.ops import attention as tattn

# (GQA group, causal, seq): GQA {1, 2} x causal/full x S {128, 200}
CASES = [(g, c, s) for g in (1, 2) for c in (True, False) for s in (128, 200)]
BATCH, KV_HEADS, HEAD_DIM = 2, 2, 64


def _qkv(group: int, seq: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    hq = KV_HEADS * group
    q = rng.standard_normal((BATCH, hq, seq, HEAD_DIM), dtype=np.float32)
    k = rng.standard_normal((BATCH, KV_HEADS, seq, HEAD_DIM), dtype=np.float32)
    v = rng.standard_normal((BATCH, KV_HEADS, seq, HEAD_DIM), dtype=np.float32)
    return q, k, v


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("group,causal,seq", CASES)
def test_reference_matches_jax_reference_f32(group, causal, seq):
    q, k, v = _qkv(group, seq)
    want = np.asarray(jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    got = tattn.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("group,causal,seq", CASES)
def test_reference_matches_jax_reference_bf16(group, causal, seq):
    q, k, v = _qkv(group, seq, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jattn.attention_reference(jq, jk, jv, causal).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = tattn.attention_reference(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_bf16_np(out), want, rtol=0, atol=2.0**-6)


@pytest.mark.parametrize("group,causal,seq", CASES)
def test_reference_matches_pallas_flash_interpret(group, causal, seq):
    q, k, v = _qkv(group, seq, seed=2)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(
        jattn.flash_attention(jq, jk, jv, causal=causal, interpret=True).astype(jnp.float32)
    )
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = _bf16_np(tattn.attention_reference(tq, tk, tv, causal))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-5)


def test_dispatch_on_cpu_runs_the_plain_version_and_never_the_kernel():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(2, 128, seed=3))
    tattn.FLASH_LAUNCHES.reset()
    got = tattn.attention(q, k, v, causal=True)
    want = tattn.attention_reference(q, k, v, causal=True)
    assert torch.equal(got, want)
    assert tattn.FLASH_LAUNCHES.value == 0


def test_kernel_wrapper_raises_on_cpu_tensors():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, k, v)
    assert tattn.FLASH_LAUNCHES.value == 0


def test_reference_rejects_indivisible_gqa():
    q = torch.zeros(1, 3, 128, 64)
    k = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="multiple"):
        tattn.attention_reference(q, k, k)
