"""The port's chunked prefill (``generation.paged_prefill_chunk``, the
runtime's ``slot_prefill_chunk`` / ``sample_first_token`` and the continuous
engine's PREFILLING lanes) against the JAX package, on the CPU.

Config: the reference's TINY (2 layers, 4 heads / 2 KV heads, d_model 48,
vocab 97, max_seq 64, f32), pages of 8 tokens. Inputs come from
``numpy.random.default_rng(seed)``. The JAX side runs
``_paged_prefill_chunk_jit`` with ``kernel=False`` (its plain gather path,
as the JAX package's own tests run it on the CPU); the port's wrapper runs
its plain version because the tensors are on the CPU.

Tolerances, chunk for chunk over a whole prompt from the same arena:
  - f32 arena: rows 1e-5, last logits 1e-4 (the same f32 math in another
    summation order);
  - bf16 arena: written rows within one bf16 ulp of |x| <= 8 (2**-5: an f32
    value a few ulps from a bf16 rounding boundary rounds either way), last
    logits 2e-3;
  - int8 arena: dequantized rows within one quantization step
    (absmax / 127, the scale) plus 1e-5, scales 1e-5 relative, last logits
    1e-2.
The engines' greedy tokens must be identical (f32, no near-tie at these
seeds), with the page census green after every drain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import generation as jgen
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime.batcher import ContinuousGenerateEngine as JEngine
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models import generation as tgen
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import transformer_lm as tlm
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.types import Model, ModelId

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
PT = 8
LM = ModelId("lm", 1)
ROW_TOL = {"float32": 1e-5, "bfloat16": 2.0**-5}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-3, "int8": 1e-2}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    return base


def _both(cfg, seed):
    jdef = jreg.build("transformer_lm", cfg)
    params = jax.device_get(jdef.init(jax.random.PRNGKey(seed)))
    module = treg.build("transformer_lm", cfg).make_module(tlm.params_from_jax(params)).eval()
    return jdef, jax.tree_util.tree_map(jnp.asarray, params), module


def _arenas(rng, arena_dtype, n_pages):
    """The same random arena for both sides: {"k", "v"[, scales]} torch and
    (arena_k, arena_v, scales) JAX."""
    hd = TINY["d_model"] // TINY["n_heads"]
    shape = (TINY["n_layers"], n_pages, TINY["n_kv_heads"], PT, hd)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if arena_dtype == "int8":
        (kq, ks), (vq, vs) = tgen._quantize_kv_rows(k), tgen._quantize_kv_rows(v)
        t = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        j = (jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
             {"k": jnp.asarray(ks.numpy()), "v": jnp.asarray(vs.numpy())})
        return t, j
    dt = getattr(torch, arena_dtype)
    t = {"k": k.to(dt), "v": v.to(dt)}
    jdt = jnp.bfloat16 if arena_dtype == "bfloat16" else jnp.float32
    j = (jnp.asarray(t["k"].float().numpy(), jdt), jnp.asarray(t["v"].float().numpy(), jdt), None)
    return t, j


def _dequant(k, scale):
    return k.astype(np.float32) * scale[..., None] if scale is not None else k.astype(np.float32)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("arena_dtype", ["float32", "bfloat16", "int8"])
def test_paged_prefill_chunk_matches_jax(arena_dtype, chunk):
    """A 37-token prompt chunk by chunk into a lane's shuffled pages (the
    table's tail on the trash page, so the last chunk's pad rows run past
    the reservation): every chunk's last real logits and, at the end, every
    written row agree with ``_paged_prefill_chunk_jit``."""
    jdef, jparams, module = _both(TINY, 0)
    rng = np.random.default_rng(11 + chunk)
    pps, n_pages, p = TINY["max_seq"] // PT, 12, 37
    t_arena, (jk, jv, jscales) = _arenas(rng, arena_dtype, n_pages)
    table = np.zeros((1, pps), np.int32)
    table[0, :-(-p // PT)] = rng.permutation(np.arange(1, n_pages))[:-(-p // PT)]
    prompt = rng.integers(0, TINY["vocab_size"], p).astype(np.int32)
    key = tuple(sorted(jdef.config.items()))
    for start in range(0, p, chunk):
        n = min(chunk, p - start)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n] = prompt[start:start + n]
        jk, jv, jscales, j_last = jgen._paged_prefill_chunk_jit(
            jparams, jk, jv, jscales, jnp.asarray(table), jnp.asarray(toks),
            jnp.asarray([start], jnp.int32), jnp.asarray([n], jnp.int32), cfg_key=key,
            page_tokens=PT, kernel=False)
        t_last = tgen.paged_prefill_chunk(
            module, jdef.config, t_arena, torch.from_numpy(table), torch.from_numpy(toks),
            torch.tensor([start], dtype=torch.int32), n, PT, True)
        assert t_last.shape == (1, TINY["vocab_size"]) and t_last.dtype == torch.float32
        np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), rtol=0,
                                   atol=LOGIT_TOL[arena_dtype])
    rows = np.arange(p)
    pages, offs = table[0, rows // PT], rows % PT
    got_k = t_arena["k"].float().numpy()[:, pages, :, offs]
    want_k = np.asarray(jk, np.float32)[:, pages, :, offs]
    got_v = t_arena["v"].float().numpy()[:, pages, :, offs]
    want_v = np.asarray(jv, np.float32)[:, pages, :, offs]
    if arena_dtype == "int8":
        for name, got, want in (("k", got_k, want_k), ("v", got_v, want_v)):
            gs = t_arena[f"{name}_scale"].numpy()[:, pages, :, offs]
            ws = np.asarray(jscales[name])[:, pages, :, offs]
            np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=0)
            diff = np.abs(_dequant(got, gs) - _dequant(want, ws))
            assert (diff <= ws[..., None] + 1e-5).all(), name
    else:
        np.testing.assert_allclose(got_k, want_k, rtol=0, atol=ROW_TOL[arena_dtype])
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=ROW_TOL[arena_dtype])


def test_chunked_last_logits_equal_the_monolithic_prefill(store):
    """The runtime's chunk path: the last chunk's logits equal a one-dispatch
    prefill's last logits (f32 1e-4), and ``sample_first_token`` under a seed
    draws what ``slot_prefill`` draws under it, greedy and sampled."""
    rt = TorchModelRuntime(ServingConfig(), device="cpu")
    try:
        rt.ensure_loaded(Model(identifier=LM, path=str(store / "lm" / "1")))
        st = rt.slot_decode_state(LM, 2, page_tokens=PT, arena_pages=16)
        prompt = np.random.default_rng(4).integers(1, 97, 29).astype(np.int32)
        assert st.reserve_pages(1, 29 + 8)
        for start in range(0, 29, 8):
            last = rt.slot_prefill_chunk(LM, st, 1, prompt[start:start + 8], start, 8)
        _tok, _pk, _pv, _hit, mono = rt._slot_prefill_impl(LM, prompt, 0.0, 0, 0)
        np.testing.assert_allclose(last.numpy(), mono.numpy(), rtol=0, atol=1e-4)
        for seed in range(6):
            for temp, top_k in ((0.0, 0), (0.9, 0), (1.3, 7)):
                want = rt.slot_prefill(LM, prompt, temp, top_k, seed)[0]
                assert rt.sample_first_token(last, temp, top_k, seed) == want
        with pytest.raises(ValueError):
            rt.slot_prefill_chunk(LM, st, 1, prompt[:9], 0, 8)
        st.release_pages(1)
        st.check_page_conservation()
    finally:
        rt.close()


def _ragged(rows, width, seed):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(2, width + 1, rows)]
    ids = np.zeros((rows, width), np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(1, TINY["vocab_size"], n)
    return ids, lens


def _engines(store, knobs, schedule, max_new=10):
    """(JAX tokens, port tokens, port engine, port slot state) of one
    schedule through both engines with the same knobs."""
    jrt = TPUModelRuntime(JConfig(platform="cpu"))
    jrt.ensure_loaded(JModel(identifier=JModelId("lm", 1), path=str(store / "lm" / "1")))
    trt = TorchModelRuntime(ServingConfig(), device="cpu")
    trt.ensure_loaded(Model(identifier=LM, path=str(store / "lm" / "1")))
    jeng = JEngine(jrt, slots=4, chunk_tokens=4, **knobs)
    teng = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, **knobs)
    try:
        want = [jeng.generate(JModelId("lm", 1), ids, prompt_lengths=lens,
                              max_new_tokens=max_new) for ids, lens in schedule]
        got = [teng.generate(LM, ids, prompt_lengths=lens, max_new_tokens=max_new)
               for ids, lens in schedule]
        return want, got, teng, trt._slot_states[LM]
    finally:
        jeng.close()
        teng.close()
        jrt.close()


@pytest.mark.parametrize("arena_dtype", ["", "bfloat16", "int8"])
@pytest.mark.parametrize("chunk", [5, 16])
def test_engine_chunked_matches_the_jax_engine(store, chunk, arena_dtype):
    """Two bursts of ragged prompts up to 40 tokens over 4 lanes with
    ``prefill_chunk_tokens`` 5 (clamped up to 8) or 16: tokens identical to
    the JAX engine with the same knobs; the engine ran one chunk per
    ``chunk``-token piece of every prompt longer than the chunk."""
    schedule = [_ragged(6, 40, 0), _ragged(5, 30, 1)]
    knobs = dict(page_tokens=PT, arena_pages=40, prefill_chunk_tokens=chunk)
    if arena_dtype:
        knobs["arena_dtype"] = arena_dtype
    want, got, teng, st = _engines(store, knobs, schedule)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    size = 8 if chunk == 5 else 16
    assert teng.prefill_chunk_tokens == size
    lens = [n for _ids, ls in schedule for n in ls]
    assert teng.prefill_chunks == sum(-(-n // size) for n in lens if n > size) > 0
    assert teng.admitted == len(lens)
    assert teng.prefill_tokens == sum(lens)
    st.check_page_conservation()
    assert sorted(st.free_pages) == list(range(1, 41))
    assert not st.active.any() and (st.block_tables == 0).all()


def test_chunking_off_by_default_and_for_short_prompts(store):
    """The knob defaults to 0 (every prompt in one dispatch); with 16 a
    schedule of prompts <= 16 tokens never chunks, and its tokens equal the
    unchunked engine's."""
    schedule = [_ragged(6, 16, 2)]
    knobs = dict(page_tokens=PT, arena_pages=32)
    trt = TorchModelRuntime(ServingConfig(), device="cpu")
    trt.ensure_loaded(Model(identifier=LM, path=str(store / "lm" / "1")))
    try:
        off = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, **knobs)
        assert off.prefill_chunk_tokens == 0
        plain = [off.generate(LM, ids, prompt_lengths=lens, max_new_tokens=8)
                 for ids, lens in schedule]
        assert off.prefill_chunks == 0
        off.close()
        trt.drop_slot_state(LM)
        on = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, prefill_chunk_tokens=16,
                                      **knobs)
        short = [on.generate(LM, ids, prompt_lengths=lens, max_new_tokens=8)
                 for ids, lens in schedule]
        assert on.prefill_chunks == 0 and on.prefill_tokens == sum(schedule[0][1])
        on.close()
        for a, b in zip(plain, short):
            np.testing.assert_array_equal(a, b)
        cfg_on = TorchModelRuntime(ServingConfig(prefill_chunk_tokens=12), device="cpu")
        assert ContinuousGenerateEngine(cfg_on, slots=2).prefill_chunk_tokens == 16
    finally:
        trt.close()


def test_prefilling_lanes_under_pagecheck_and_eos(store, monkeypatch, tmp_path):
    """PREFILLING lanes sit inactive past their table while others decode:
    the trash-page check stays quiet, the census stays green, and a row
    whose first token is EOS retires at its last chunk where the JAX engine
    retires it."""
    from tfservingcache_tpu_torch.runtime import model_runtime as tmr

    monkeypatch.setattr(tmr, "_PAGECHECK", True)
    checked = []
    real = tmr._check_trash_unreachable

    def spy(state):
        checked.append(int((~state.active).sum()))
        real(state)

    monkeypatch.setattr(tmr, "_check_trash_unreachable", spy)
    schedule = [_ragged(6, 40, 3)]
    want, got, teng, st = _engines(store, dict(page_tokens=PT, arena_pages=40,
                                               prefill_chunk_tokens=8), schedule)
    np.testing.assert_array_equal(got[0], want[0])
    assert checked and teng.prefill_chunks > 0
    st.check_page_conservation()
    # an eos_id equal to a first token: that row stops at its last chunk
    cfg = dict(TINY, eos_id=int(want[0][0, 0]))
    jreg.export_artifact("transformer_lm", str(tmp_path), name="lm", version=1, config=cfg,
                         seed=3)
    want, got, teng, st = _engines(tmp_path, dict(page_tokens=PT, arena_pages=40,
                                                  prefill_chunk_tokens=8), schedule)
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[0][0, 1:] == 0).all()
    st.check_page_conservation()
    assert sorted(st.free_pages) == list(range(1, 41))
