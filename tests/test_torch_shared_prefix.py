"""The port's shared-prefix KV over the paged arena (the radix index on the
slot state, ``shared_prefix_plan`` / ``slot_prefill_shared`` / ``slot_cow``
/ ``shared_prefix_publish`` / ``reclaim_prefix_pages`` and the continuous
engine's shared admissions) against the JAX package, on the CPU.

Config: the reference's TINY (2 layers, 4 heads / 2 KV heads, d_model 48,
vocab 97, max_seq 64, f32), pages of 8 tokens. Prompts come from
``numpy.random.default_rng(seed)``: one 20-token system prompt (two full
pages and a 4-token tail) plus distinct suffixes, and exact repeats. f32, so
greedy tokens must be IDENTICAL between sharing on and the JAX engine with
the same knobs, and on an f32 arena between sharing on and off. On a bf16
or int8 arena a shared row's suffix prefill reads the prefix's ROUNDED rows
where a cold prefill reads its own f32 rows, so on vs off is held to the
near-tie rule of tests/test_torch_transformer_lm.py: identical up to a first
divergence where both tokens lie within ``NEAR_TIE[arena]`` of the plain f32
forward's max logit (logits ~N(0, 1) here: bf16, 2**-4, a few bf16 ulps;
int8, 0.05, about 7x the 0.7% rms error an int8 row carries; measured
0.023). The page census must be green with the index's holds counted, and a
drained arena must hold only free and index-only pages, all of which
``reclaim_prefix_pages`` returns.
"""

import itertools

import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime.batcher import ContinuousGenerateEngine as JEngine
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.runtime import batcher as tbatcher
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.types import Model, ModelId

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
PT = 8
LM = ModelId("lm", 1)
SHARE = 1 << 20


DRAFT = dict(TINY, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    jreg.export_artifact("transformer_lm", str(base), name="draft", version=1, config=DRAFT,
                         seed=5)
    return base


def _port(store, names=("lm",), **serving):
    rt = TorchModelRuntime(ServingConfig(**serving), device="cpu")
    for n in names:
        rt.ensure_loaded(Model(identifier=ModelId(n, 1), path=str(store / n / "1")))
    return rt


def _batch(prompts):
    width = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    return ids, [len(p) for p in prompts]


def _schedule(seed=0, sys_len=20):
    """Burst 1: six rows behind one system prompt; burst 2: two exact
    repeats of burst 1 rows, two new suffixes and an unrelated prompt."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, 97, sys_len).astype(np.int32)
    first = [np.concatenate([system, rng.integers(1, 97, int(n)).astype(np.int32)])
             for n in rng.integers(1, 12, 6)]
    second = [first[0], first[3]]
    second += [np.concatenate([system, rng.integers(1, 97, int(n)).astype(np.int32)])
               for n in (3, 9)]
    second.append(rng.integers(1, 97, 13).astype(np.int32))
    return [_batch(first), _batch(second)]


def _run(eng, mid, schedule, max_new=10, **kw):
    return [eng.generate(mid, ids, prompt_lengths=lens, max_new_tokens=max_new, **kw)
            for ids, lens in schedule]


def _drained(st):
    """Census green; every page free or held only by the index; a full
    reclaim hands every page back."""
    st.check_page_conservation()
    stats = st.page_stats()
    assert stats["shared"] == stats["private"] == 0
    assert stats["free"] + stats["cached"] == st.arena_pages
    assert (st.block_tables == 0).all() and not st.active.any()
    return stats


ARENAS = {"float32": "", "bfloat16": "bfloat16", "int8": "int8"}
NEAR_TIE = {"float32": 0.0, "bfloat16": 2.0**-4, "int8": 0.05}


def _near_tie_equal(module, schedule, got, plain, tol):
    """Row by row: identical, or identical up to a first divergence where
    both tokens are within ``tol`` of the plain forward's max logit."""
    for (ids, lens), g, p in zip(schedule, got, plain):
        for i, n in enumerate(lens):
            diff = np.nonzero(g[i] != p[i])[0]
            if not diff.size:
                continue
            j = int(diff[0])
            seq = np.concatenate([ids[i, :n], p[i, :j]]).astype(np.int64)[None]
            with torch.inference_mode():
                logits = module({"input_ids": torch.from_numpy(seq)})["logits"][0, -1].numpy()
            top = logits.max()
            assert top - logits[g[i, j]] <= tol and top - logits[p[i, j]] <= tol, (i, j)


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_engine_sharing_matches_the_jax_engine_and_sharing_off(store, arena):
    schedule = _schedule()
    knobs = dict(page_tokens=PT, arena_pages=40)
    if ARENAS[arena]:
        knobs["arena_dtype"] = ARENAS[arena]
    jrt = TPUModelRuntime(JConfig(platform="cpu"))
    jrt.ensure_loaded(JModel(identifier=JModelId("lm", 1), path=str(store / "lm" / "1")))
    trt = _port(store)
    jeng = JEngine(jrt, slots=4, chunk_tokens=4, share_prefix_bytes=SHARE, **knobs)
    on = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, share_prefix_bytes=SHARE, **knobs)
    try:
        want = _run(jeng, JModelId("lm", 1), schedule)
        got = _run(on, LM, schedule)
        st = trt._slot_states[LM]
        jst = jrt._slot_states[JModelId("lm", 1)]
        assert st.prefix_index is not None
        assert on.prefix_hits_exact == 2 and on.prefix_hits_shared >= 6
        # the JAX index saw the same lookups with the same outcomes
        assert (st.prefix_index.hits, st.prefix_index.exact_hits, st.prefix_index.misses) == (
            jst.prefix_index.hits, jst.prefix_index.exact_hits, jst.prefix_index.misses)
        assert st.prefix_index.total_bytes == jst.prefix_index.total_bytes
        lens = [n for _ids, ls in schedule for n in ls]
        assert on.prefill_tokens < sum(lens)
        stats = _drained(st)
        assert stats["cached"] > 0
        assert trt.reclaim_prefix_pages(st, st.arena_pages) == stats["cached"]
        assert sorted(st.free_pages) == list(range(1, st.arena_pages + 1))
        st.check_page_conservation()
        on.close()
        trt.drop_slot_state(LM)
        off = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, share_prefix_bytes=0, **knobs)
        plain = _run(off, LM, schedule)
        off.close()
        assert trt._slot_states[LM].prefix_index is None
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        if arena == "float32":
            for g, p in zip(got, plain):
                np.testing.assert_array_equal(g, p)
        else:
            _near_tie_equal(trt._lm(LM).module, schedule, got, plain, NEAR_TIE[arena])
    finally:
        jeng.close()
        on.close()
        jrt.close()
        trt.close()


@pytest.mark.parametrize("extra", ["chunked", "spec"])
def test_engine_sharing_with_chunking_or_a_draft_matches_the_jax_engine(store, extra):
    """Sharing with chunked prefill (misses past 8 tokens prefill in chunks
    and publish at their last chunk; hits never chunk) or with a draft
    attached (the draft prefills every prompt whole, exact hits too):
    tokens, hit counts and census as the JAX engine's with the same knobs."""
    schedule = _schedule(seed=2)
    knobs = dict(page_tokens=PT, arena_pages=40, share_prefix_bytes=SHARE)
    names = ("lm",)
    if extra == "chunked":
        knobs["prefill_chunk_tokens"] = 8
    else:
        knobs.update(spec_draft_model="draft", spec_tokens=4)
        names = ("lm", "draft")
    jrt = TPUModelRuntime(JConfig(platform="cpu"))
    for n in names:
        jrt.ensure_loaded(JModel(identifier=JModelId(n, 1), path=str(store / n / "1")))
    trt = _port(store, names=names)
    jeng = JEngine(jrt, slots=4, chunk_tokens=4, **knobs)
    teng = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, **knobs)
    try:
        want = _run(jeng, JModelId("lm", 1), schedule)
        got = _run(teng, LM, schedule)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        st, jst = trt._slot_states[LM], jrt._slot_states[JModelId("lm", 1)]
        assert (st.prefix_index.hits, st.prefix_index.exact_hits, st.prefix_index.misses) == (
            jst.prefix_index.hits, jst.prefix_index.exact_hits, jst.prefix_index.misses)
        assert teng.prefix_hits_exact == 2 and teng.prefix_hits_shared > 0
        if extra == "chunked":
            assert teng.prefill_chunks > 0 and teng.spec_rounds == 0
        else:
            assert teng.spec_rounds > 0 and teng.prefill_chunks == 0
            st.spec_draft.check_page_conservation()
            assert sorted(st.spec_draft.free_pages) == list(range(1, st.spec_draft.arena_pages + 1))
        _drained(st)
    finally:
        jeng.close()
        teng.close()
        jrt.close()
        trt.close()


def test_exact_hit_boundary_cow_and_seeded_first_token(store):
    """Runtime surface: a published prompt with a mid-page tail comes back
    as an exact plan mapping the index's pristine boundary copy; the
    admission reserves one CoW page and the copy gives the lane a private
    boundary page holding the same rows; the first token sampled from the
    cached logits under a seed is the cold prefill's under that seed."""
    rt = _port(store)
    try:
        st = rt.slot_decode_state(LM, 3, page_tokens=PT, arena_pages=20,
                                  share_prefix_bytes=SHARE)
        prompt = np.random.default_rng(5).integers(1, 97, 21).astype(np.int32)  # 2 pages + 5
        assert st.reserve_pages(0, 21 + 6)
        tok, pk, pv, kind, last = rt.slot_prefill_shared(LM, st, prompt, 0.0, 0, 3, None)
        assert kind == "miss" and pk is not None
        rt.slot_admit(st, 0, pk, pv)
        rt.shared_prefix_publish(st, 0, prompt, last)
        lane0 = list(st.lane_pages[0])
        held = st.prefix_index.held_pages()
        assert set(lane0[:2]) <= set(held) and len(held) == 3  # 2 full pages + the tail copy
        boundary = next(pg for pg in held if pg not in lane0)
        for name in ("k", "v"):
            a = getattr(st, name)
            assert torch.equal(a[:, boundary], a[:, lane0[2]])
        plan = rt.shared_prefix_plan(st, prompt)
        assert plan.kind == "exact" and plan.pages == lane0[:2] and plan.boundary_page == boundary
        assert plan.tail_len == 5 and plan.covered == 16
        free_before = len(st.free_pages)
        assert st.reserve_pages(1, 21 + 6, plan.mapped_pages(), cow_headroom=1)
        assert len(st.free_pages) == free_before - (st.pages_needed(27) - 3)
        assert st.page_refs[boundary] == 2
        rt.slot_cow(st, 1, plan.n_full)
        private = int(st.block_tables[1, plan.n_full])
        assert private != boundary and st.page_refs[boundary] == 1 and st.page_refs[private] == 1
        assert torch.equal(st.k[:, private], st.k[:, boundary])
        st.check_page_conservation()
        stats = st.page_stats()
        assert stats["shared"] == 2 and stats["cached"] == 1
        for seed, (temp, top_k) in itertools.product(range(5), ((0.0, 0), (0.8, 0), (1.2, 5))):
            cold = rt.slot_prefill(LM, prompt, temp, top_k, seed)[0]
            hit = rt.slot_prefill_shared(LM, st, prompt, temp, top_k, seed, plan)
            assert hit[0] == cold and hit[1] is None and hit[3] == "exact"
        # a longer prompt over the same prefix: a shared plan and a suffix prefill
        longer = np.concatenate([prompt[:16], np.arange(1, 9, dtype=np.int32)])
        plan2 = rt.shared_prefix_plan(st, longer)
        assert plan2.kind == "shared" and plan2.covered == 16
        tok2, pk2, _pv2, kind2, _ = rt.slot_prefill_shared(LM, st, longer, 0.0, 0, 0, plan2)
        assert kind2 == "shared" and tok2 == rt.slot_prefill(LM, longer, 0.0, 0, 0)[0]
        for lane in (0, 1):
            st.release_pages(lane)
        _drained(st)
    finally:
        rt.close()


def test_sampled_sharing_equals_sharing_off_under_pinned_seeds(store, monkeypatch):
    """Sampled rows (t = 0.9, top_k 20) with the admission seeds pinned to
    a counter: sharing on emits what sharing off emits, the exact hits'
    first tokens (sampled from cached logits) included."""
    schedule = _schedule(seed=1)
    knobs = dict(page_tokens=PT, arena_pages=40)
    out = {}
    for name, share in (("on", SHARE), ("off", 0)):
        counter = itertools.count(100)
        monkeypatch.setattr(tbatcher.secrets, "randbits", lambda _bits: next(counter))
        rt = _port(store)
        eng = ContinuousGenerateEngine(rt, slots=4, chunk_tokens=4, share_prefix_bytes=share,
                                       **knobs)
        try:
            out[name] = [eng.generate(LM, ids[i:i + 1], prompt_lengths=[lens[i]],
                                      max_new_tokens=8, temperature=0.9, top_k=20)
                         for ids, lens in schedule for i in range(len(lens))]
            if share:
                assert eng.prefix_hits_exact == 2
        finally:
            eng.close()
            rt.close()
    for a, b in zip(out["on"], out["off"]):
        np.testing.assert_array_equal(a, b)


def test_reclaim_under_page_pressure(store):
    """A 14-page arena (a row needs up to 5) with a large index budget:
    cold index pages are reclaimed so every row admits (no deadlock), the
    tokens equal sharing off, and the census stays green."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 97, int(n)).astype(np.int32) for n in rng.integers(9, 28, 12)]
    schedule = [_batch(prompts[:6]), _batch(prompts[6:]), _batch(prompts[:3])]
    out = {}
    for name, share in (("on", SHARE), ("off", 0)):
        rt = _port(store)
        eng = ContinuousGenerateEngine(rt, slots=3, chunk_tokens=4, page_tokens=PT,
                                       arena_pages=14, share_prefix_bytes=share)
        freed = []
        real = rt.reclaim_prefix_pages

        def spy(state, want, protect=(), real=real, freed=freed):
            freed.append(real(state, want, protect))
            return freed[-1]

        rt.reclaim_prefix_pages = spy
        try:
            out[name] = _run(eng, LM, schedule, max_new=9)
            st = rt._slot_states[LM]
            if share:
                assert sum(freed) > 0  # admissions took pages back from the index
                held = st.prefix_index.held_pages()
                assert st.prefix_index.total_bytes < SHARE and len(held) <= 14
                _drained(st)
            else:
                st.check_page_conservation()
                assert sorted(st.free_pages) == list(range(1, 15))
        finally:
            eng.close()
            rt.close()
    for a, b in zip(out["on"], out["off"]):
        np.testing.assert_array_equal(a, b)


def test_index_budget_and_knob_plumbing(store):
    """The index's page bytes count K, V and an int8 arena's scales; a
    budget of one page keeps at most one page held; the ServingConfig knob
    reaches the state through ``build_node``'s engine."""
    rt = _port(store, kv_share_prefix_bytes=SHARE, kv_page_tokens=PT)
    try:
        st = rt.slot_decode_state(LM, 2, arena_pages=10, arena_dtype="int8")
        want = sum(t.nbytes for t in (st.k, st.v, *st.scales.values())) // 11
        assert st.prefix_index.page_nbytes == want and st.prefix_index.capacity_bytes == SHARE
        rt.drop_slot_state(LM)
        st = rt.slot_decode_state(LM, 2, arena_pages=10, share_prefix_bytes=0)
        assert st.prefix_index is None
        rt.drop_slot_state(LM)
        st = rt.slot_decode_state(LM, 2, arena_pages=10, share_prefix_bytes=1)
        prompt = np.arange(1, 20, dtype=np.int32)
        assert st.reserve_pages(0, 24)
        _tok, pk, pv, _kind, last = rt.slot_prefill_shared(LM, st, prompt, 0.0, 0, 0, None)
        rt.slot_admit(st, 0, pk, pv)
        rt.shared_prefix_publish(st, 0, prompt, last)
        assert st.prefix_index.held_pages() == {} and st.prefix_index.total_bytes == 0
        st.release_pages(0)
        st.check_page_conservation()
        assert sorted(st.free_pages) == list(range(1, 11))
    finally:
        rt.close()
