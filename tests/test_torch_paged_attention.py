"""The port's paged decode attention (tfservingcache_tpu_torch/ops/attention.py)
and int8 row quantization (models/generation.py) against the JAX package.

Inputs come from ``numpy.random.default_rng(seed)``: scattered arenas with
ragged positions and table slots past each lane's live pages on the trash
page, as tests/test_paged_kernel.py builds them. Tolerances:
  - f32 arenas: 2e-5 absolute against both the JAX plain version and the
    JAX Pallas kernel in interpret mode (same f32 math, other summation
    order and, for the kernel, an online softmax);
  - int8 arenas: 2e-5 against the JAX plain version on the dequantized
    pages (both sides dequantize to the same f32 values);
  - ``_quantize_kv_rows``: int8 values bit-identical, scales within 1e-7.
On the CPU the dispatch runs the plain version, whatever ``kernel`` says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfservingcache_tpu.models.generation as jgen
from tfservingcache_tpu.ops import attention as jatt
from tfservingcache_tpu_torch.models import generation as tgen
from tfservingcache_tpu_torch.ops import attention as tatt


def _arena(lanes, hq, hkv, d, pps, pt, seed=0):
    rng = np.random.default_rng(seed)
    n_pages = lanes * pps + 1
    tables = rng.permutation(np.arange(1, n_pages)).reshape(lanes, pps).astype(np.int32)
    k_pages = rng.standard_normal((n_pages, hkv, pt, d)).astype(np.float32)
    v_pages = rng.standard_normal((n_pages, hkv, pt, d)).astype(np.float32)
    q = rng.standard_normal((lanes, hq, 1, d)).astype(np.float32)
    pos = rng.integers(0, pps * pt, lanes).astype(np.int32)
    for s in range(lanes):
        tables[s, -(-(int(pos[s]) + 1) // pt):] = 0
    return q, k_pages, v_pages, tables, pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("pt", [8, 16])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_plain_matches_jax_plain_and_interpret_kernel(pt, g):
    hkv = 2
    arrays = _arena(lanes=5, hq=hkv * g, hkv=hkv, d=16, pps=4, pt=pt, seed=g * 7 + pt)
    got = tatt.paged_decode_attention(*_t(*arrays), pt).numpy()
    want_plain = np.asarray(jatt.paged_decode_attention(*_j(*arrays), pt))
    want_kernel = np.asarray(jatt.paged_decode_attention_kernel(
        *_j(*arrays), page_tokens=pt, interpret=True))
    assert got.dtype == np.float32 and got.shape == (5, hkv * g, 1, 16)
    np.testing.assert_allclose(got, want_plain, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=2e-5)


@pytest.mark.parametrize("g", [1, 4])
def test_paged_int8_matches_jax_on_dequantized_pages(g):
    q, kp, vp, tables, pos = _arena(lanes=4, hq=2 * g, hkv=2, d=16, pps=4, pt=8, seed=3 + g)
    kq, ks = tgen._quantize_kv_rows(torch.from_numpy(kp))
    vq, vs = tgen._quantize_kv_rows(torch.from_numpy(vp))
    tq, ttab, tpos = _t(q, tables, pos)
    got = tatt.paged_attention(tq, kq, vq, ttab, tpos, 8, ks, vs).numpy()
    jkq, jks = jgen._quantize_kv_rows(jnp.asarray(kp))
    jvq, jvs = jgen._quantize_kv_rows(jnp.asarray(vp))
    want = np.asarray(jatt.paged_decode_attention(
        jnp.asarray(q), jatt.dequantize_pages(jkq, jks), jatt.dequantize_pages(jvq, jvs),
        jnp.asarray(tables), jnp.asarray(pos), 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    want_kernel = np.asarray(jatt.paged_decode_attention_kernel(
        jnp.asarray(q), jkq, jvq, jnp.asarray(tables), jnp.asarray(pos), jks, jvs,
        page_tokens=8, interpret=True))
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=2e-5)


def test_paged_bf16_arena_matches_jax_plain():
    """bf16 pages and q: products exact in f32 on both sides, p rounded to
    bf16 before the value product on both sides: 2e-5 absolute."""
    q, kp, vp, tables, pos = _arena(lanes=3, hq=4, hkv=2, d=16, pps=4, pt=8, seed=11)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, kp, vp))
    got = tatt.paged_decode_attention(tq, tk, tv, *_t(tables, pos), 8).numpy()
    want = np.asarray(jatt.paged_decode_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(pos), 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_kernel_false_is_bitwise_the_plain_path():
    arrays = _t(*_arena(lanes=3, hq=4, hkv=2, d=64, pps=4, pt=8, seed=5))
    plain = tatt.paged_decode_attention(*arrays, 8)
    before = tatt.PAGED_LAUNCHES.value
    assert torch.equal(tatt.paged_attention(*arrays, 8, kernel=False), plain)
    # on a CPU tensor the gate's answer is the plain path as well
    assert torch.equal(tatt.paged_attention(*arrays, 8, kernel=True), plain)
    assert tatt.PAGED_LAUNCHES.value == before


def test_paged_gather_matches_jax():
    _q, kp, _vp, tables, _pos = _arena(lanes=3, hq=2, hkv=2, d=8, pps=3, pt=4, seed=2)
    got = tatt.paged_gather_kv(*_t(kp, tables), 4).numpy()
    want = np.asarray(jatt.paged_gather_kv(*_j(kp, tables), 4))
    np.testing.assert_array_equal(got, want)


def test_kernel_wrapper_refuses_cpu_tensors():
    arrays = _t(*_arena(lanes=2, hq=2, hkv=2, d=64, pps=2, pt=8, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        tatt.paged_decode_attention_kernel(*arrays, page_tokens=8)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_kv_rows_bit_identical_to_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 4, 32)).astype(np.float32) * rng.uniform(0.1, 10, (3, 5, 4, 1))
    x = x.astype(np.float32)
    # exact .5 ties: a row whose absmax is 127 * 0.5 puts the other
    # elements at x / 0.5 = k + 0.5 after scaling
    x[0, 0, 0, :] = np.arange(32, dtype=np.float32) * 0.5 - 8.25
    x[0, 0, 0, 0] = 63.5
    x[1, 1, 1, :5] = np.array([2.5, -2.5, 0.5, -0.5, 127.0 / 2], np.float32)
    x[2, 2, 2, :] = 0.0  # all-zero row: the 1e-8 floor
    got_q, got_s = tgen._quantize_kv_rows(torch.from_numpy(x))
    want_q, want_s = jgen._quantize_kv_rows(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-7)
    scaled = x[0, 0, 0] / np.asarray(want_s)[0, 0, 0]
    assert (np.abs(scaled[1:] % 1 - 0.5) < 1e-6).all()  # the ties are really there
