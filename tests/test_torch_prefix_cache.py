"""The port's prefix KV cache on the solo ``:generate`` path
(``serving.prefix_cache_bytes``: ``TorchModelRuntime._prefix_generate`` /
``_speculative`` over ``generation.generate_from_cache`` and
``speculative_generate(cached_kv=..., return_cache=True)``) against the JAX
runtime with the same knob, on the CPU.

Config: the reference's prefix-cache test model (tests/test_prefix_cache.py:
2 layers, d_model 64, 4 heads / 2 KV heads, vocab 128, max_seq 128, f32)
and a 1-layer draft of the same vocabulary. Prompts come from
``numpy.random.default_rng(seed)``. f32, so greedy tokens must be IDENTICAL:
port vs JAX runtime, cache on vs off, turn by turn of a conversation (turn 2
= turn 1's prompt + its completion + new tokens); seeded sampling must be
reproducible within the port across cache state (JAX's threefry stream is
not the target). A stored entry's K/V rows must equal the JAX runtime's
entry at 1e-5 (the same f32 math in another summation order) — its last row
included, which a skipped final decode forward would leave unwritten.
"""

import jax
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models import generation as tgen
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.types import Model, ModelId

CFG = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
       "d_ff": 128, "max_seq": 128, "rope_theta": 10000.0, "dtype": "float32"}
DRAFT = dict(CFG, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64)
BUDGET = 64 << 20
M, DR = ModelId("m", 1), ModelId("dr", 1)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    jreg.export_artifact("transformer_lm", str(base), name="m", version=1, config=CFG, seed=0)
    jreg.export_artifact("transformer_lm", str(base), name="dr", version=1, config=DRAFT,
                         seed=1)
    return base


def _port(store, budget=BUDGET, names=("m",)):
    rt = TorchModelRuntime(ServingConfig(prefix_cache_bytes=budget), device="cpu")
    for n in names:
        rt.ensure_loaded(Model(identifier=ModelId(n, 1), path=str(store / n / "1")))
    return rt


def _jax(store, budget=BUDGET, names=("m",)):
    rt = TPUModelRuntime(JConfig(platform="cpu", prefix_cache_bytes=budget))
    for n in names:
        rt.ensure_loaded(JModel(identifier=JModelId(n, 1), path=str(store / n / "1")))
    return rt


def _conversation(rt, mid, rng_seed, prompt_len, max_new, turn2_new=7, **kw):
    rng = np.random.default_rng(rng_seed)
    prompt1 = rng.integers(0, 128, (1, prompt_len)).astype(np.int32)
    t1 = rt.generate(mid, prompt1, max_new_tokens=max_new, **kw)
    extra = rng.integers(0, 128, (1, turn2_new)).astype(np.int32)
    prompt2 = np.concatenate([prompt1, t1[:, :max_new], extra], axis=1)
    t2 = rt.generate(mid, prompt2, max_new_tokens=max_new, **kw)
    return t1, t2


@pytest.mark.parametrize("prompt_len,max_new", [(12, 8), (12, 5), (20, 12), (32, 32)])
def test_two_turn_greedy_matches_the_jax_runtime_and_cache_off(store, prompt_len, max_new):
    """Turn 2 hits turn 1's entry on both runtimes; the port's tokens equal
    the JAX runtime's and the cache-off port's, turn by turn."""
    port, off, jrt = _port(store), _port(store, budget=0), _jax(store)
    try:
        got = _conversation(port, M, prompt_len, prompt_len, max_new)
        plain = _conversation(off, M, prompt_len, prompt_len, max_new)
        want = _conversation(jrt, JModelId("m", 1), prompt_len, prompt_len, max_new)
        for g, p, w in zip(got, plain, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
        pc = port._prefix_cache
        assert (pc.hits, pc.misses) == (1, 1) == (jrt._prefix_cache.hits,
                                                  jrt._prefix_cache.misses)
        assert pc.total_bytes == jrt._prefix_cache.total_bytes and len(pc) == len(jrt._prefix_cache)
        assert off._prefix_cache is None
    finally:
        port.close()
        off.close()
        jrt.close()


def test_entry_rows_match_the_jax_entry_last_row_included(store):
    """prompt_len 32 + max_new 32: the entry is 64 rows, and its last row
    (the last emitted token's) is written, as the JAX scan writes it: every
    row equals the JAX runtime's entry and a fresh forward over the entry's
    64 tokens."""
    port, jrt = _port(store), _jax(store)
    try:
        prompt = np.random.default_rng(3).integers(0, 128, (1, 32)).astype(np.int32)
        np.testing.assert_array_equal(port.generate(M, prompt, max_new_tokens=32),
                                      jrt.generate(JModelId("m", 1), prompt, max_new_tokens=32))
        (ent,) = port._prefix_cache._by_model[M].values()
        (jent,) = jrt._prefix_cache._by_model[JModelId("m", 1)].values()
        assert ent.valid_len == jent.valid_len == 64
        np.testing.assert_array_equal(ent.tokens, jent.tokens)
        assert ent.k.shape == (2, 1, 2, 64, 16) and ent.nbytes == jent.nbytes
        np.testing.assert_allclose(ent.k.numpy(), np.asarray(jax.device_get(jent.k)),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(ent.v.numpy(), np.asarray(jax.device_get(jent.v)),
                                   rtol=0, atol=1e-5)
        loaded = port._lm(M)
        cfg = loaded.model_def.config
        cache = tgen.init_cache(cfg, 1, 64, "cpu")
        with torch.inference_mode():
            tgen._forward_cached_dyn(loaded.module, torch.from_numpy(ent.tokens[None]), cache,
                                     torch.zeros(1, dtype=torch.long), cfg)
        np.testing.assert_allclose(ent.k.numpy(), cache["k"].numpy(), rtol=0, atol=1e-5)
        assert ent.k[:, :, :, 63].abs().sum() > 0
    finally:
        port.close()
        jrt.close()


@pytest.mark.parametrize("temp,top_k,seed", [(0.9, 16, 11), (1.2, 0, 4)])
def test_seeded_sampling_hit_equals_miss(store, temp, top_k, seed):
    """Seeded sampled conversations: the cache-on port draws what the
    cache-off port draws under the same seed, on the hit turn too."""
    on, off = _port(store), _port(store, budget=0)
    try:
        kw = dict(temperature=temp, top_k=top_k, seed=seed)
        got = _conversation(on, M, 7, 12, 8, **kw)
        plain = _conversation(off, M, 7, 12, 8, **kw)
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g, p)
        assert on._prefix_cache.hits == 1
    finally:
        on.close()
        off.close()


def test_speculative_two_turn_matches_the_jax_runtime(store):
    """The solo "draft_model" path composes with the cache: turn 2's target
    prefill starts from the cached rows (a hit on both runtimes), and the
    tokens equal the JAX runtime's and the cache-off port's."""
    names = ("m", "dr")
    port, off, jrt = _port(store, names=names), _port(store, 0, names), _jax(store, names=names)
    try:
        kw = dict(spec_tokens=4)
        got = _conversation(port, M, 5, 14, 12, draft_model_id=DR, **kw)
        plain = _conversation(off, M, 5, 14, 12, draft_model_id=DR, **kw)
        want = _conversation(jrt, JModelId("m", 1), 5, 14, 12,
                             draft_model_id=JModelId("dr", 1), **kw)
        for g, p, w in zip(got, plain, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
        assert port._prefix_cache.hits == 1 == jrt._prefix_cache.hits
        assert port.spec_rounds["solo"] > 0
        ents = sorted(port._prefix_cache._by_model[M].values(), key=lambda e: e.valid_len)
        jents = sorted(jrt._prefix_cache._by_model[JModelId("m", 1)].values(),
                       key=lambda e: e.valid_len)
        for e, j in zip(ents, jents):
            np.testing.assert_array_equal(e.tokens, j.tokens)
            np.testing.assert_allclose(e.k.numpy(), np.asarray(jax.device_get(j.k)), atol=1e-5,
                                       rtol=0)
    finally:
        port.close()
        off.close()
        jrt.close()


def test_unload_drops_entries_and_batches_skip_the_cache(store):
    port = _port(store)
    try:
        rng = np.random.default_rng(2)
        pc = port._prefix_cache
        port.generate(M, rng.integers(0, 128, (2, 12)).astype(np.int32), max_new_tokens=8)
        assert (pc.hits, pc.misses, len(pc)) == (0, 0, 0)  # B = 2: not prefix-capable
        port.generate(M, rng.integers(0, 128, (1, 12)).astype(np.int32), max_new_tokens=8)
        assert len(pc) == 1 and pc.total_bytes > 0
        port.unload(M)
        assert len(pc) == 0 and pc.total_bytes == 0
    finally:
        port.close()


def test_engine_admission_reuses_solo_entries(store):
    """The continuous engine's admission prefill looks the cache up (it never
    inserts): after a solo turn, an engine request extending it is a
    "dense" hit, with the tokens of an engine without the cache."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 128, (1, 20)).astype(np.int32)
    out = {}
    for name, budget in (("on", BUDGET), ("off", 0)):
        rt = _port(store, budget=budget)
        eng = ContinuousGenerateEngine(rt, slots=2, chunk_tokens=4, page_tokens=8)
        try:
            t1 = rt.generate(M, prompt, max_new_tokens=8, seed=0)
            prompt2 = np.concatenate([prompt, t1, rng.integers(0, 128, (1, 3)).astype(np.int32)],
                                     axis=1) if name == "on" else out["prompt2"]
            out["prompt2"] = prompt2
            out[name] = eng.generate(M, prompt2, max_new_tokens=8)
            assert eng.prefix_hits_dense == (1 if budget else 0)
            rt._slot_states[M].check_page_conservation()
        finally:
            eng.close()
            rt.close()
    np.testing.assert_array_equal(out["on"], out["off"])
