"""The port's solo generation path (tfservingcache_tpu_torch/models/generation.py
and ``TorchModelRuntime.generate``) against the JAX package.

Config: the reference's TINY (tests/test_paged_kernel.py: 2 layers, 4 heads /
2 KV heads, d_model 48, vocab 97, max_seq 64) in f32, plus a bf16 twin.
Inputs come from ``numpy.random.default_rng(seed)``. Tolerances:
  - f32: greedy tokens identical; logits of the cached forward 1e-4
    (same math, other summation order);
  - bf16: tokens identical up to the first divergence, and there both
    tokens' logits (the JAX model's, teacher-forced) lie within 2**-3 of
    the position's maximum — a bf16 near-tie, twice the 2**-4 logit
    tolerance of tests/test_torch_transformer_lm.py;
  - sampling: JAX's threefry stream cannot be reproduced, so sampled
    tokens are held to the filter math (ids inside the top-k set, top_k=1
    equals greedy) and to reproducibility under one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.models import generation as jgen
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models import generation as tgen
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import transformer_lm as tlm
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.types import Model, ModelId

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
TINY_BF16 = dict(TINY, dtype="bfloat16")


def _both(cfg: dict, seed: int = 3):
    """(JAX model_def, JAX params, port module) on the same weights."""
    jdef = jreg.build("transformer_lm", cfg)
    params = jax.device_get(jdef.init(jax.random.PRNGKey(seed)))
    if cfg["dtype"] == "bfloat16":  # the artifact's storage dtype
        params = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16), params)
    tdef = treg.build("transformer_lm", cfg)
    module = tdef.make_module(tlm.params_from_jax(params)).eval()
    return jdef, jax.tree_util.tree_map(jnp.asarray, params), module


def _ragged(rows=5, width=11, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.asarray([int(x) for x in rng.integers(2, width + 1, rows)], np.int32)
    ids = np.zeros((rows, width), np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(1, TINY["vocab_size"], n)
    return ids, lens


def _port_generate(module, cfg, ids, lens, n, **kw):
    full = treg.build("transformer_lm", cfg).config  # the family defaults merged in
    return tgen.generate(module, full, torch.from_numpy(ids), torch.from_numpy(lens), n,
                         **kw).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_solo_greedy_matches_jax_f32(seed):
    jdef, params, module = _both(TINY, seed=seed + 3)
    ids, lens = _ragged(seed=seed)
    want = np.asarray(jgen.generate(jdef, params, ids, prompt_lengths=lens, max_new_tokens=12))
    got = _port_generate(module, TINY, ids, lens, 12)
    assert got.shape == want.shape == (5, 12) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_solo_greedy_bf16_agrees_off_near_ties():
    jdef, params, module = _both(TINY_BF16, seed=4)
    ids, lens = _ragged(rows=4, seed=2)
    n = 10
    want = np.asarray(jgen.generate(jdef, params, ids, prompt_lengths=lens, max_new_tokens=n))
    got = _port_generate(module, TINY_BF16, ids, lens, n)
    for b in range(ids.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if not diff.size:
            continue
        i = int(diff[0])
        seq = np.concatenate([ids[b, :lens[b]], want[b, :i]])[None]
        logits = np.asarray(jdef.apply(params, {"input_ids": jnp.asarray(seq)})["logits"])[0, -1]
        top = logits.max()
        assert top - logits[got[b, i]] <= 2.0**-3 and top - logits[want[b, i]] <= 2.0**-3, (
            f"row {b} diverges at token {i} off a near-tie")


def test_forward_cached_dyn_matches_jax_with_clamped_writes():
    """Per-example start positions, including one past max_len - s_len that
    ``lax.dynamic_update_slice`` clamps (the write lands on the last rows)."""
    jdef, params, module = _both(TINY, seed=5)
    rng = np.random.default_rng(7)
    b, s_len, max_len = 3, 4, 12
    ids = rng.integers(0, 97, (b, s_len)).astype(np.int32)
    start = np.array([0, 5, 10], np.int32)  # 10 + 4 > 12: clamped to 8
    k0 = rng.standard_normal((2, b, 2, max_len, 12)).astype(np.float32)
    v0 = rng.standard_normal((2, b, 2, max_len, 12)).astype(np.float32)
    cfg = jdef.config
    want_logits, want_cache = jgen._forward_cached_dyn(
        params, jnp.asarray(ids), {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(start), cfg)
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    with torch.inference_mode():
        got = tgen._forward_cached_dyn(module, torch.from_numpy(ids), cache,
                                       torch.from_numpy(start), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(want_cache["k"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(want_cache["v"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2.0**-6)])
def test_rope_per_example_matches_jax(dtype, tol):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 2, 5, 16)).astype(np.float32)
    positions = rng.integers(0, 100, (3, 5)).astype(np.int32)
    want = np.asarray(jgen._rope_per_example(
        jnp.asarray(x, dtype), jnp.asarray(positions), 10000.0).astype(jnp.float32))
    got = tgen._rope_per_example(torch.from_numpy(x).to(getattr(torch, dtype)),
                                 torch.from_numpy(positions), 10000.0)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_sample_filter_math_follows_the_reference():
    """top_k=1 at t > 0 is greedy; sampled ids lie in the top-k set; t <= 0
    is greedy whatever top_k says; k >= V or k = 0 leaves the row unfiltered."""
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.standard_normal((6, 97)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    temps = torch.tensor([0.8, 0.8, 0.0, 1.5, 1.0, 1.0])
    topks = torch.tensor([1, 5, 5, 3, 0, 500])
    greedy = logits.argmax(-1)
    top_sets = torch.topk(logits, 5, dim=-1).indices
    for _ in range(20):
        got = tgen._sample_per_row(logits, gen, temps, topks)
        assert got[0] == greedy[0] and got[2] == greedy[2]
        assert got[1] in top_sets[1]
        assert got[3] in top_sets[3, :3]
        assert 0 <= int(got[4]) < 97 and 0 <= int(got[5]) < 97
    # unfiltered rows do sample: over 20 draws at t=1, more than one id
    draws = {int(tgen._sample_per_row(logits, gen, temps, topks)[4]) for _ in range(20)}
    assert len(draws) > 1


@pytest.fixture()
def runtime(tmp_path):
    jreg.export_artifact("transformer_lm", str(tmp_path), name="lm", version=1,
                         config=TINY, seed=6)
    rt = TorchModelRuntime(ServingConfig(), device="cpu")
    mid = ModelId("lm", 1)
    rt.ensure_loaded(Model(identifier=mid, path=str(tmp_path / "lm" / "1")))
    yield rt, mid, tmp_path / "lm" / "1"
    rt.close()


def test_runtime_generate_matches_jax_runtime(runtime):
    from tfservingcache_tpu.config import ServingConfig as JConfig
    from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
    from tfservingcache_tpu.types import Model as JModel
    from tfservingcache_tpu.types import ModelId as JModelId

    rt, mid, path = runtime
    jrt = TPUModelRuntime(JConfig(platform="cpu"))
    jmid = JModelId("lm", 1)
    jrt.ensure_loaded(JModel(identifier=jmid, path=str(path)))
    try:
        ids, lens = _ragged(rows=3, width=9, seed=4)  # batch 3 -> 4, seq 9 -> 16, new 5 -> 8
        want = jrt.generate(jmid, ids, prompt_lengths=lens.tolist(), max_new_tokens=5, seed=0)
        got = rt.generate(mid, ids, prompt_lengths=lens.tolist(), max_new_tokens=5, seed=0)
        np.testing.assert_array_equal(got, want)
        # bucket overshoot past max_seq falls back to the exact sizes
        long_ids = np.random.default_rng(5).integers(1, 97, (1, 40)).astype(np.int32)
        want = jrt.generate(jmid, long_ids, max_new_tokens=24, seed=0)
        got = rt.generate(mid, long_ids, max_new_tokens=24, seed=0)
        np.testing.assert_array_equal(got, want)
    finally:
        jrt.close()


def test_runtime_generate_validation(runtime):
    rt, mid, _ = runtime
    ids = np.ones((2, 5), np.int32)
    for kwargs, match in [
        (dict(prompt_lengths=[0, 5]), "prompt_lengths"),
        (dict(max_new_tokens=0), "max_new_tokens"),
        (dict(temperature=-1.0), "temperature"),
        (dict(temperature=float("nan")), "temperature"),
        (dict(top_k=-1), "top_k"),
        (dict(max_new_tokens=60), "max_seq"),
    ]:
        with pytest.raises(RuntimeError_, match=match):
            rt.generate(mid, ids, **kwargs)
    with pytest.raises(RuntimeError_, match="batch, seq"):
        rt.generate(mid, np.ones((5,), np.int32))


def test_seeded_sampling_is_reproducible_and_top1_is_greedy(runtime):
    rt, mid, _ = runtime
    ids, lens = _ragged(rows=2, seed=6)
    kw = dict(prompt_lengths=lens.tolist(), max_new_tokens=10)
    a = rt.generate(mid, ids, temperature=0.9, top_k=20, seed=7, **kw)
    b = rt.generate(mid, ids, temperature=0.9, top_k=20, seed=7, **kw)
    np.testing.assert_array_equal(a, b)
    greedy = rt.generate(mid, ids, **kw)
    top1 = rt.generate(mid, ids, temperature=0.8, top_k=1, seed=3, **kw)
    np.testing.assert_array_equal(top1, greedy)
    assert ((a >= 0) & (a < 97)).all()
