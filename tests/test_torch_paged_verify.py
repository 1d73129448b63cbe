"""The port's paged verify attention (tfservingcache_tpu_torch/ops/attention.py)
and verify step (models/generation.py ``_paged_verify_step``) against the JAX
package.

Inputs come from ``numpy.random.default_rng(seed)``: scattered arenas with
ragged positions, each lane's T query positions at ``pos .. pos + T - 1``,
table slots past each lane's deepest frontier on the trash page, and one lane
whose positions run past the end of its table. Tolerances:
  - f32 arenas: 1e-5 absolute against the JAX plain version and the JAX
    Pallas kernel in interpret mode (same f32 math, other summation order
    and, for the kernel, an online softmax);
  - int8 arenas: 1e-5 against the JAX plain version on the dequantized pages
    (both sides dequantize to the same f32 values);
  - bf16 arena: 2e-5 against the JAX plain version (products exact in f32 on
    both sides, p rounded to bf16 before the value product on both sides);
  - the verify step: logits 1e-4 (two layers of f32 matmuls in another
    summation order), arena rows 1e-5; int8 rows within one quantization
    step (an f32 projection an ulp apart may round to the other neighbour).
On the CPU the dispatch runs the plain version, whatever ``kernel`` says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfservingcache_tpu.models.generation as jgen
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.ops import attention as jatt
from tfservingcache_tpu_torch.models import generation as tgen
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import transformer_lm as tlm
from tfservingcache_tpu_torch.ops import attention as tatt


def _arena(lanes, hq, hkv, d, pps, pt, t_q, seed=0):
    rng = np.random.default_rng(seed)
    n_pages = lanes * pps + 1
    tables = rng.permutation(np.arange(1, n_pages)).reshape(lanes, pps).astype(np.int32)
    k_pages = rng.standard_normal((n_pages, hkv, pt, d)).astype(np.float32)
    v_pages = rng.standard_normal((n_pages, hkv, pt, d)).astype(np.float32)
    q = rng.standard_normal((lanes, hq, t_q, d)).astype(np.float32)
    pos = rng.integers(0, pps * pt - t_q + 1, lanes).astype(np.int32)
    pos[0] = pps * pt - max(1, t_q // 2)  # lane 0 runs past its table
    for s in range(lanes):
        tables[s, -(-(int(pos[s]) + t_q) // pt):] = 0
    return q, k_pages, v_pages, tables, pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("t_q", [1, 3, 5, 9])
@pytest.mark.parametrize("pt", [8, 16])
@pytest.mark.parametrize("g", [1, 4])
def test_verify_plain_matches_jax_plain_and_interpret_kernel(pt, g, t_q):
    hkv = 2
    arrays = _arena(lanes=5, hq=hkv * g, hkv=hkv, d=16, pps=4, pt=pt, t_q=t_q,
                    seed=g * 7 + pt + t_q)
    got = tatt.paged_verify_attention(*_t(*arrays), pt).numpy()
    want_plain = np.asarray(jatt.paged_verify_attention(*_j(*arrays), pt))
    want_kernel = np.asarray(jatt.paged_verify_attention_kernel(
        *_j(*arrays), page_tokens=pt, interpret=True))
    assert got.dtype == np.float32 and got.shape == (5, hkv * g, t_q, 16)
    np.testing.assert_allclose(got, want_plain, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=1e-5)


@pytest.mark.parametrize("g", [1, 4])
def test_verify_int8_matches_jax_on_dequantized_pages(g):
    q, kp, vp, tables, pos = _arena(lanes=4, hq=2 * g, hkv=2, d=16, pps=4, pt=8, t_q=5,
                                    seed=3 + g)
    kq, ks = tgen._quantize_kv_rows(torch.from_numpy(kp))
    vq, vs = tgen._quantize_kv_rows(torch.from_numpy(vp))
    tq, ttab, tpos = _t(q, tables, pos)
    got = tatt.paged_attention_verify(tq, kq, vq, ttab, tpos, 8, ks, vs).numpy()
    jkq, jks = jgen._quantize_kv_rows(jnp.asarray(kp))
    jvq, jvs = jgen._quantize_kv_rows(jnp.asarray(vp))
    want = np.asarray(jatt.paged_verify_attention(
        jnp.asarray(q), jatt.dequantize_pages(jkq, jks), jatt.dequantize_pages(jvq, jvs),
        jnp.asarray(tables), jnp.asarray(pos), 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want_kernel = np.asarray(jatt.paged_verify_attention_kernel(
        jnp.asarray(q), jkq, jvq, jnp.asarray(tables), jnp.asarray(pos), jks, jvs,
        page_tokens=8, interpret=True))
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=1e-5)


def test_verify_bf16_arena_matches_jax_plain():
    q, kp, vp, tables, pos = _arena(lanes=3, hq=4, hkv=2, d=16, pps=4, pt=8, t_q=5, seed=11)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, kp, vp))
    got = tatt.paged_verify_attention(tq, tk, tv, *_t(tables, pos), 8).numpy()
    want = np.asarray(jatt.paged_verify_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(pos), 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_at_one_position_is_bitwise_the_decode_version(dtype):
    q, kp, vp, tables, pos = (t.to(dtype) if t.is_floating_point() else t for t in
                              _t(*_arena(lanes=4, hq=8, hkv=2, d=16, pps=4, pt=8, t_q=1, seed=6)))
    assert torch.equal(tatt.paged_verify_attention(q, kp, vp, tables, pos, 8),
                       tatt.paged_decode_attention(q, kp, vp, tables, pos, 8))


def test_kernel_false_is_bitwise_the_plain_path_and_cpu_never_launches():
    arrays = _t(*_arena(lanes=3, hq=4, hkv=2, d=64, pps=4, pt=8, t_q=5, seed=5))
    plain = tatt.paged_verify_attention(*arrays, 8)
    before = tatt.VERIFY_LAUNCHES.value
    assert torch.equal(tatt.paged_attention_verify(*arrays, 8, kernel=False), plain)
    # on a CPU tensor the dispatch runs the plain path as well
    assert torch.equal(tatt.paged_attention_verify(*arrays, 8, kernel=True), plain)
    assert tatt.VERIFY_LAUNCHES.value == before


@pytest.mark.parametrize("t_q", [1, 5])
def test_cpu_dispatch_is_the_plain_path_at_a_head_dim_no_kernel_takes(t_q):
    """head_dim 96 (no kernel head_dim) on the CPU: the decode (T = 1) and
    verify dispatches run the plain version and match JAX's; on the card the
    same call raises (tests/test_torch_cuda.py)."""
    q, kp, vp, tables, pos = _arena(lanes=3, hq=4, hkv=2, d=96, pps=3, pt=8, t_q=t_q, seed=13)
    before = (tatt.PAGED_LAUNCHES.value, tatt.VERIFY_LAUNCHES.value)
    if t_q == 1:
        got = tatt.paged_attention(*_t(q, kp, vp, tables, pos), 8).numpy()
        want = jatt.paged_decode_attention(*_j(q, kp, vp, tables, pos), 8)
    else:
        got = tatt.paged_attention_verify(*_t(q, kp, vp, tables, pos), 8).numpy()
        want = jatt.paged_verify_attention(*_j(q, kp, vp, tables, pos), 8)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert (tatt.PAGED_LAUNCHES.value, tatt.VERIFY_LAUNCHES.value) == before


def test_verify_kernel_wrapper_refuses_cpu_tensors():
    arrays = _t(*_arena(lanes=2, hq=2, hkv=2, d=64, pps=2, pt=8, t_q=3, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        tatt.paged_verify_attention_kernel(*arrays, page_tokens=8)


TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}


@pytest.mark.parametrize("arena_dtype", ["", "int8"])
def test_paged_verify_step_matches_jax(arena_dtype):
    """Logits and the arena after one T = 5 verify step from the same arena
    state, with lane 2's positions running past its 4-page table (its last
    two rows go to the trash page, its own pages keep their history)."""
    import jax

    jdef = jreg.build("transformer_lm", TINY)
    params = jax.device_get(jdef.init(jax.random.PRNGKey(2)))
    module = treg.build("transformer_lm", TINY).make_module(tlm.params_from_jax(params)).eval()
    cfg = jdef.config
    rng = np.random.default_rng(4)
    lanes, pt, pps, t_q, hd = 3, 8, 4, 5, 12
    n_pages = lanes * pps + 1
    shape = (2, n_pages, 2, pt, hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(lanes, pps).astype(np.int32)
    pos = np.array([3, 17, pps * pt - 3], np.int32)
    tables[0, 2:] = 0
    tables[1, 3:] = 0
    toks = rng.integers(0, 97, (lanes, t_q)).astype(np.int32)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    arena = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    if arena_dtype == "int8":
        kq, ks = jgen._quantize_kv_rows(jnp.asarray(k0))
        vq, vs = jgen._quantize_kv_rows(jnp.asarray(v0))
        jcache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        arena = {name: torch.from_numpy(np.array(a)) for name, a in jcache.items()}
    want_logits, want_cache = jgen._paged_verify_step(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(toks), jcache,
        jnp.asarray(tables), jnp.asarray(pos), cfg, "transformer_lm", pt, kernel=False)
    with torch.inference_mode():
        got = tgen._paged_verify_step(module, cfg, torch.from_numpy(toks).long(), arena,
                                      torch.from_numpy(tables), torch.from_numpy(pos), pt,
                                      kernel=True)
    assert got.shape == (lanes, t_q, 97) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)
    for name in arena:
        w = np.asarray(want_cache[name])
        if name in ("k", "v") and arena_dtype == "int8":
            # int8 rows: equal up to a rounding flip where the f32 inputs differ
            # by an ulp (summation order): at most one step, on few elements
            diff = np.abs(arena[name].numpy().astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(arena[name].numpy(), w, rtol=0, atol=1e-5, err_msg=name)
    # lane 2 (pos 29, T 5): rows 29..31 land in its last page at offsets
    # 5..7; rows 32..33 run past the table to the trash page, so the page's
    # history (offsets 0..4) is untouched — the clip alone would put them there
    before = k0 if arena_dtype == "" else np.asarray(jcache["k"])
    last = tables[2, pps - 1]
    after = arena["k"].numpy()
    assert np.array_equal(after[:, last, :, :5], before[:, last, :, :5])
    assert not np.array_equal(after[:, last, :, 5:], before[:, last, :, 5:])
