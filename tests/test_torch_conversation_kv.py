"""The port's conversation KV tier (``cache/conversation_kv.py``), the
runtime's park / resume surface (``park_lane``, ``plan_conversation_resume``,
``slot_resume_prefill``, ``generation.pages_export`` / ``pages_import``) and
the continuous engine's park at retirement and resume at admission, against
the JAX package, on the CPU (mirrors tests/test_conversation_kv.py, minus
the peer wire, which waits for gRPC).

Config: the reference's TINY (2 layers, 4 heads / 2 KV heads, d_model 48,
vocab 97, max_seq 64, f32), pages of 8 tokens. Prompts come from
``numpy.random.default_rng(seed)``. The port's engine and the JAX engine run
the same two-turn schedule on one artifact: greedy tokens and each row's
``prefill_tokens`` must be IDENTICAL on f32, bf16 and int8 arenas (the two
engines quantize and round the same rows the same way). Within the port, a
resumed turn 2 against the same prompt prefilled cold: identical on an f32
arena; on bf16 and int8 the resumed suffix prefill reads the parked ROUNDED
rows where a cold prefill reads its own f32 rows, so they are held to the
near-tie rule of tests/test_torch_shared_prefix.py (``NEAR_TIE``: bf16
2**-4, int8 0.05 of the plain forward's max logit). Blobs are compared byte
for byte, and the page census must be green after every engine test.
"""

import tempfile

import numpy as np
import pytest
import torch

from tfservingcache_tpu.cache import conversation_kv as jkv
from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.lab import faults as jfaults
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime.batcher import ContinuousGenerateEngine as JEngine
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.cache.conversation_kv import (
    KV_BLOB_MAGIC,
    ConversationKVTier,
    ParkedConversation,
    pack_parked,
    unpack_parked,
)
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.lab import faults
from tfservingcache_tpu_torch.models import generation
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime, _arena
from tfservingcache_tpu_torch.types import Model, ModelId

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
PT = 8
LM = ModelId("lm", 1)
JLM = JModelId("lm", 1)
TIER = 32 << 20
ARENAS = {"float32": "", "bfloat16": "bfloat16", "int8": "int8"}
NEAR_TIE = {"float32": 0.0, "bfloat16": 2.0**-4, "int8": 0.05}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    return base


def _port(store, **serving):
    rt = TorchModelRuntime(ServingConfig(**serving), device="cpu")
    rt.ensure_loaded(Model(identifier=LM, path=str(store / "lm" / "1")))
    return rt


def _jax(store):
    rt = TPUModelRuntime(JConfig(platform="cpu"))
    rt.ensure_loaded(JModel(identifier=JLM, path=str(store / "lm" / "1")))
    return rt


def _knobs(arena="float32"):
    """The engine knobs both packages' engines take as arguments."""
    knobs = dict(slots=2, chunk_tokens=2, page_tokens=PT, arena_pages=48)
    if ARENAS[arena]:
        knobs["arena_dtype"] = ARENAS[arena]
    return knobs


def _tier(tmp_path, pkg):
    """A conversation tier of TIER bytes with its directory under the
    test's own ``tmp_path``: the port reads these fields from its
    ServingConfig, the JAX engine takes them as arguments."""
    return dict(conversation_kv_bytes=TIER, conversation_kv_dir=str(tmp_path / f"{pkg}_kv"))


# -- blob codec ---------------------------------------------------------------

def _arrays(kind, n_pages=3, hist_len=17, seed=0):
    """(history, k, v, k_scale, v_scale, page dtype) with k/v as the port
    holds them (bf16 as uint16 bit patterns)."""
    rng = np.random.default_rng(seed)
    shape = (2, n_pages, 2, PT, 12)
    hist = rng.integers(1, 97, hist_len).astype(np.int32)
    if kind == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random(shape[:4]).astype(np.float32) for _ in range(2))
        return hist, k, v, ks, vs, "int8"
    if kind == "bfloat16":
        # finite bf16 bit patterns: f32 normals rounded to their top half
        k, v = ((rng.standard_normal(shape).astype(np.float32).view(np.uint32) >> 16)
                .astype(np.uint16) for _ in range(2))
        return hist, k, v, None, None, "bfloat16"
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return hist, k, v, None, None, "float32"


def _mk(kind="float32", model="lm@1", **kw):
    hist, k, v, ks, vs, dt = _arrays(kind, **kw)
    return ParkedConversation(model_id=model, history=hist, pages_k=k, pages_v=v, k_scale=ks,
                              v_scale=vs, page_tokens=PT, page_dtype=dt)


def _same(a, b) -> None:
    assert (a.model_id, a.page_tokens, a.page_dtype) == (b.model_id, b.page_tokens, b.page_dtype)
    for name in ("history", "pages_k", "pages_v", "k_scale", "v_scale"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()  # byte-exact, not allclose


@pytest.mark.parametrize("kind", sorted(ARENAS))
def test_pack_unpack_roundtrip_byte_exact(kind):
    parked = _mk(kind)
    blob = pack_parked(parked)
    assert blob.startswith(KV_BLOB_MAGIC)
    back = unpack_parked(blob)
    _same(parked, back)
    assert back.nbytes == parked.nbytes


def test_unpack_rejects_corruption():
    blob = pack_parked(_mk())
    with pytest.raises(ValueError):
        unpack_parked(b"NOPE!\n" + blob[len(KV_BLOB_MAGIC):])
    with pytest.raises(ValueError):
        unpack_parked(blob[:-3])          # truncated payload
    with pytest.raises(ValueError):
        unpack_parked(blob + b"\x00\x00")  # trailing junk
    with pytest.raises(ValueError):
        unpack_parked(blob[:len(KV_BLOB_MAGIC) + 2])  # truncated header length


@pytest.mark.parametrize("kind", sorted(ARENAS))
def test_blob_parity_with_the_reference(kind):
    """The reference's ``pack_parked`` and the port's give the same bytes for
    the same arrays, and each unpacks the other's byte for byte (bf16: the
    reference's ml_dtypes arrays against the port's uint16 bit patterns)."""
    import ml_dtypes

    hist, k, v, ks, vs, dt = _arrays(kind, seed=4)
    mine = _mk(kind, seed=4)
    jk, jv = (a.view(ml_dtypes.bfloat16) if dt == "bfloat16" else a for a in (k, v))
    ref = jkv.ParkedConversation(model_id="lm@1", history=hist, pages_k=jk, pages_v=jv,
                                 k_scale=ks, v_scale=vs, page_tokens=PT)
    blob = pack_parked(mine)
    assert jkv.pack_parked(ref) == blob
    _same(mine, unpack_parked(jkv.pack_parked(ref)))
    theirs = jkv.unpack_parked(blob)
    assert theirs.pages_k.dtype.name == dt and theirs.nbytes == mine.nbytes
    for name in ("history", "pages_k", "pages_v", "k_scale", "v_scale"):
        a, b = getattr(ref, name), getattr(theirs, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- tier: LRU spill + promotion ---------------------------------------------

def test_tier_spills_coldest_to_disk_and_repromotes(tmp_path):
    one = _mk(hist_len=17, seed=1)
    tier = ConversationKVTier(capacity_bytes=int(one.nbytes * 1.5),
                              disk_capacity_bytes=64 << 20, disk_dir=str(tmp_path / "kv"))
    try:
        tier.put("alpha", one)
        tier.put("beta", _mk(hist_len=18, seed=2))
        s = tier.stats()
        assert s["host_conversations"] == 1 and s["disk_conversations"] == 1
        assert s["spills"] == 1 and s["spilled_bytes"] == len(pack_parked(one))
        assert len(list((tmp_path / "kv").glob("*.kv"))) == 1
        got, outcome = tier.get("alpha", "lm@1")
        assert outcome == "spilled"
        _same(one, got)
        # promoted host-ward, pushing beta out to disk (the budget holds one)
        s = tier.stats()
        assert s["host_conversations"] == 1 and s["disk_conversations"] == 1
        assert s["spilled_hits"] == 1
        again, outcome = tier.get("alpha", "lm@1")  # peeks: the entry stays
        assert outcome == "hit"
        _same(one, again)
        assert tier.get("alpha", "other@1") == (None, "miss")
        assert tier.get("gamma", "lm@1") == (None, "miss")
        assert tier.stats()["misses"] == 2
        # a re-park replaces the entry without writing the old one to disk
        spills = tier.stats()["spills"]
        tier.put("alpha", _mk(hist_len=19, seed=5))
        assert tier.stats()["spills"] == spills and tier.get("alpha", "lm@1")[1] == "hit"
    finally:
        tier.close()
    assert not (tmp_path / "kv").exists()  # close() removes the spill dir it made


@pytest.mark.parametrize("spill", [False, True])
def test_tier_close_deletes_only_what_it_wrote(tmp_path, spill):
    """A tier over a directory that was there before it: with spilling off
    it never touches the directory; with it on, close() deletes its own
    spill files and leaves another file, and so the directory, as it was."""
    d = tmp_path / "shared"
    d.mkdir()
    (d / "keep.kv").write_bytes(b"not the tier's")
    one = _mk(hist_len=17, seed=1)
    tier = ConversationKVTier(capacity_bytes=int(one.nbytes * 1.5),
                              disk_capacity_bytes=(64 << 20) if spill else 0, disk_dir=str(d))
    try:
        tier.put("alpha", one)
        tier.put("beta", _mk(hist_len=18, seed=2))  # spills alpha when spilling is on
        assert tier.stats()["spills"] == int(spill)
        assert len(list(d.glob("*.kv"))) == 1 + int(spill)
    finally:
        tier.close()
    assert [p.name for p in d.iterdir()] == ["keep.kv"]
    assert (d / "keep.kv").read_bytes() == b"not the tier's"


def test_tier_drop_model_and_oversized_park(tmp_path):
    small = _mk(hist_len=9, n_pages=2)
    tier = ConversationKVTier(capacity_bytes=small.nbytes + 1, disk_capacity_bytes=1 << 20,
                              disk_dir=str(tmp_path / "kv"))
    try:
        tier.put("huge", _mk(n_pages=64))  # larger than the whole budget: dropped
        assert len(tier) == 0
        tier.put("c1", small)
        tier.put("c2", _mk(hist_len=9, n_pages=2, seed=7))
        assert len(tier) == 2  # one host, one spilled
        tier.put("c3", _mk(n_pages=64))  # an oversized re-park keeps the others
        assert len(tier) == 2
        tier.drop_model("lm@1")
        assert len(tier) == 0 and tier.total_bytes == 0
        assert tier.get("c1", "lm@1") == (None, "miss")
    finally:
        tier.close()


def test_tier_zero_budget_is_inert():
    tier = ConversationKVTier(capacity_bytes=0)
    try:
        assert not tier.enabled
        tier.put("a", _mk())
        assert tier.get("a", "lm@1") == (None, "miss")
        assert tier.parked_page_count() == 0
        assert tier.stats()["enabled"] is False
    finally:
        tier.close()


def test_census_counts_parked_pages_host_tier_only(tmp_path):
    a = _mk(hist_len=17, n_pages=3, seed=3)
    tier = ConversationKVTier(capacity_bytes=int(a.nbytes * 1.5), disk_capacity_bytes=1 << 20,
                              disk_dir=str(tmp_path / "kv"))
    try:
        tier.put("a", a)
        assert tier.parked_page_count() == tier.parked_page_count("lm@1") == 3
        assert tier.parked_page_count("other@1") == 0
        tier.put("b", _mk(hist_len=17, n_pages=3, seed=4))  # spills a
        assert tier.parked_page_count() == 3
        assert tier.stats()["disk_conversations"] == 1
    finally:
        tier.close()


# -- runtime surface ----------------------------------------------------------

@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_pages_export_import_round_trip_bit_identical(store, arena):
    """Export a lane's pages, scribble over the arena, import them into
    other pages: those pages (values and int8 scales) equal the originals
    bit for bit, through a host copy and a blob in between."""
    rt = _port(store)
    try:
        st = rt.slot_decode_state(LM, 2, page_tokens=PT, arena_pages=20,
                                  arena_dtype=ARENAS[arena])
        prompt = np.random.default_rng(2).integers(1, 97, 21).astype(np.int32)
        assert st.reserve_pages(0, 27)
        _tok, pk, pv = rt.slot_prefill(LM, prompt, 0.0, 0, 0)
        rt.slot_admit(st, 0, pk, pv)
        parked = rt.park_lane(st, 0, prompt)
        assert parked.pages_k.shape == (2, 3, 2, PT, 12)
        assert parked.page_dtype == (ARENAS[arena] or "float32")
        assert (parked.k_scale is not None) == (arena == "int8")
        src = list(st.lane_pages[0][:3])
        before = {n: t[:, src].clone() for n, t in _arena(st).items()}
        parked = unpack_parked(pack_parked(parked))
        assert st.reserve_pages(1, 27)
        dst = st.lane_pages[1][:3]
        for t in _arena(st).values():
            t[:, dst] = 0
        rt.slot_resume_prefill(LM, st, 1, np.concatenate([prompt, [5, 6]]).astype(np.int32),
                               parked, 21, 3, 0.0, 0, 0)
        for n, t in _arena(st).items():
            assert torch.equal(t[:, dst], before[n]), n
        # a bare export of the imported pages gives the same rows again
        again = generation.pages_export(_arena(st), dst)
        for n in again:
            assert torch.equal(again[n], before[n])
        for lane in (0, 1):
            st.release_pages(lane)
        st.check_page_conservation()
        assert sorted(st.free_pages) == list(range(1, 21))
    finally:
        rt.close()


def test_park_and_plan_refuse_what_cannot_resume(store):
    rt = _port(store)
    try:
        dense = rt.slot_decode_state(LM, 2, page_tokens=0)
        assert rt.park_lane(dense, 0, np.arange(1, 5, dtype=np.int32)) is None
        rt.drop_slot_state(LM)
        st = rt.slot_decode_state(LM, 2, page_tokens=PT, arena_pages=20)
        assert st.reserve_pages(0, 16)  # 2 pages
        assert rt.park_lane(st, 0, np.zeros((0,), np.int32)) is None   # empty history
        assert rt.park_lane(st, 0, np.arange(1, 20, dtype=np.int32)) is None  # 3 pages > 2
        assert rt.park_lane(st, 1, np.arange(1, 5, dtype=np.int32)) is None   # no reservation
        parked = rt.park_lane(st, 0, np.arange(1, 12, dtype=np.int32))
        prompt = np.arange(1, 20, dtype=np.int32)
        assert rt.plan_conversation_resume(st, prompt, parked) == (11, 2)
        # at least one suffix token is left; a first token that differs
        # resumes nothing; a later divergence resumes up to it
        assert rt.plan_conversation_resume(st, np.arange(1, 12, dtype=np.int32), parked) == (
            10, 2)
        assert rt.plan_conversation_resume(st, prompt + 1, parked) is None
        bent = prompt.copy()
        bent[6] = 90
        assert rt.plan_conversation_resume(st, bent, parked) == (6, 1)
        for attr, val in (("page_tokens", 16), ("page_dtype", "bfloat16"),
                          ("k_scale", np.zeros((2, 2, 2, PT), np.float32)),
                          ("pages_k", parked.pages_k[:, :, :1])):
            other = ParkedConversation(**{**parked.__dict__, attr: val, "nbytes": 1})
            assert rt.plan_conversation_resume(st, prompt, other) is None, attr
        assert rt.plan_conversation_resume(st, prompt, None) is None
        # a long prompt sheds whole pages until covered + the suffix bucket
        # fits max_seq 64: 52 + 16 > 64, then 48 + 16
        assert st.reserve_pages(1, 56)  # 7 pages
        hist = np.arange(1, 53, dtype=np.int32)
        long = rt.park_lane(st, 1, hist)
        assert long.pages_k.shape[1] == 7
        prompt = np.concatenate([hist, np.full(10, 7, np.int32)])
        assert rt.plan_conversation_resume(st, prompt, long) == (48, 6)
        assert rt.plan_conversation_resume(st, prompt[:60], long) == (52, 7)
        for lane in (0, 1):
            st.release_pages(lane)
        st.check_page_conservation()
    finally:
        rt.close()


def test_runtime_seeded_resume_sampling_parity(store, tmp_path):
    """A resumed first token is the full prefill's under the same seed
    (sampled, t = 0.8, top_k 5), over the re-imported rows."""
    rt = _port(store, **_tier(tmp_path, "port"))
    eng = ContinuousGenerateEngine(rt, **_knobs())
    rng = np.random.default_rng(2)
    p1 = rng.integers(1, 97, 11).astype(np.int32)
    try:
        out1 = eng.generate(LM, p1[None], max_new_tokens=5, conversation_id="conv")
        parked, outcome = eng.conversation_tier.get("conv", str(LM), touch=False)
        assert outcome == "hit"
        p2 = np.concatenate([p1, out1[0], rng.integers(1, 97, 3).astype(np.int32)])
        st = rt._slot_states[LM]
        covered, n_pages = rt.plan_conversation_resume(st, p2, parked)
        assert covered == 11 + 5 - 1
        assert st.reserve_pages(0, p2.shape[0] + 4)
        try:
            for seed in (7, 1234):
                tok_r = rt.slot_resume_prefill(LM, st, 0, p2, parked, covered, n_pages,
                                               0.8, 5, seed)[0]
                assert tok_r == rt.slot_prefill(LM, p2, 0.8, 5, seed)[0]
        finally:
            st.release_pages(0)
        st.check_page_conservation()
    finally:
        eng.close()
        rt.close()


# -- engine -------------------------------------------------------------------

def _two_turns(eng, mid, seed=0, n_conv=3):
    """Turn 1 of ``n_conv`` conversations, then each turn 2 (turn 1's prompt
    + its tokens + 4 new tokens) resumed, then the same turn-2 prompts cold
    under fresh ids. -> (turn-1 tokens, turn-2, cold, turn-2 stats)."""
    rng = np.random.default_rng(seed)
    firsts = [rng.integers(1, 97, int(n)).astype(np.int32) for n in rng.integers(9, 17, n_conv)]
    t1 = [eng.generate(mid, p[None], max_new_tokens=6, conversation_id=f"c{i}")
          for i, p in enumerate(firsts)]
    seconds = [np.concatenate([p, o[0].astype(np.int32), rng.integers(1, 97, 4).astype(np.int32)])
               for p, o in zip(firsts, t1)]
    t2, stats = [], []
    for i, p in enumerate(seconds):
        out, st = eng.generate(mid, p[None], max_new_tokens=6, conversation_id=f"c{i}",
                               return_stats=True)
        t2.append(out)
        stats.append(st[0])
    cold = [eng.generate(mid, p[None], max_new_tokens=6, conversation_id=f"cold{i}")
            for i, p in enumerate(seconds)]
    return firsts, seconds, t1, t2, cold, stats


def _near_tie_equal(module, prompt, got, want, tol):
    diff = np.nonzero(got != want)[0]
    if not diff.size:
        return
    j = int(diff[0])
    seq = np.concatenate([prompt, want[:j]]).astype(np.int64)[None]
    with torch.inference_mode():
        logits = module({"input_ids": torch.from_numpy(seq)})["logits"][0, -1].numpy()
    top = logits.max()
    assert top - logits[got[j]] <= tol and top - logits[want[j]] <= tol, j


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_engine_park_resume_matches_the_jax_engine(store, arena, tmp_path):
    """Turn 2 resumes from the parked turn 1 with a suffix-only prefill of
    exactly the unseen tail: tokens and per-row prefill_tokens equal the JAX
    engine's, and equal the cold prefill's (near-ties on bf16 / int8)."""
    jrt, trt = _jax(store), _port(store, **_tier(tmp_path, "port"))
    jeng = JEngine(jrt, **_knobs(arena), **_tier(tmp_path, "jax"))
    teng = ContinuousGenerateEngine(trt, **_knobs(arena))
    try:
        want = _two_turns(jeng, JLM)
        got = _two_turns(teng, LM)
        firsts, seconds = got[0], got[1]
        for w, g in zip(want[2:5], got[2:5]):
            for a, b in zip(w, g):
                np.testing.assert_array_equal(b, a)
        assert [s["prefill_tokens"] for s in got[5]] == [s["prefill_tokens"] for s in want[5]]
        # the parked history is prompt 1 + its tokens but the last
        assert [s["prefill_tokens"] for s in got[5]] == [
            len(p2) - (len(p1) + 6 - 1) for p1, p2 in zip(firsts, seconds)]
        assert [s["resumes"] for s in got[5]] == [1, 1, 1] and teng.resumes == 3
        assert teng.parks == 9 and teng.park_failures == 0
        ts, js = teng.conversation_tier.stats(), jeng.conversation_tier.stats()
        for key in ("hits", "misses", "parked_total", "host_conversations", "host_bytes"):
            assert ts[key] == js[key], key
        module = trt._lm(LM).module
        for p, r, c in zip(seconds, got[3], got[4]):
            if arena == "float32":
                np.testing.assert_array_equal(r, c)
            else:
                _near_tie_equal(module, p, r[0], c[0], NEAR_TIE[arena])
        st = trt._slot_states[LM]
        st.check_page_conservation()
        assert sorted(st.free_pages) == list(range(1, st.arena_pages + 1))
    finally:
        jeng.close()
        teng.close()
        jrt.close()
        trt.close()


def test_engine_zero_budget_identity(store):
    """conversation_kv_bytes 0: no tier, the id inert, prefill whole."""
    rt = _port(store, kv_page_tokens=PT, kv_arena_pages=32)
    eng = ContinuousGenerateEngine(rt, slots=2, chunk_tokens=2)
    try:
        assert eng.conversation_tier is None
        prompt = np.array([[5, 17, 40, 3, 9, 61, 2]], np.int32)
        plain = eng.generate(LM, prompt, max_new_tokens=6)
        tagged, stats = eng.generate(LM, prompt, max_new_tokens=6, conversation_id="conv",
                                     return_stats=True)
        np.testing.assert_array_equal(tagged, plain)
        assert stats[0]["prefill_tokens"] == prompt.shape[1] and eng.parks == 0
        rt._slot_states[LM].check_page_conservation()
    finally:
        eng.close()
        rt.close()


@pytest.mark.parametrize("disk_bytes", [0, 64 << 20])
def test_engine_close_leaves_the_configured_directory_alone(store, tmp_path, disk_bytes):
    """The default spill directory lies under the process's temporary
    directory, and an engine that parked and closed leaves an existing
    ``conversation_kv_dir`` and what else it holds as they were, with
    spilling off or on."""
    assert ServingConfig().conversation_kv_dir.startswith(tempfile.gettempdir())
    d = tmp_path / "kv"
    d.mkdir()
    (d / "other").write_text("kept")
    rt = _port(store, conversation_kv_bytes=TIER, conversation_kv_disk_bytes=disk_bytes,
               conversation_kv_dir=str(d))
    eng = ContinuousGenerateEngine(rt, **_knobs())
    try:
        eng.generate(LM, np.arange(1, 12, dtype=np.int32)[None], max_new_tokens=4,
                     conversation_id="c")
        assert eng.parks == 1
    finally:
        eng.close()
        rt.close()
    assert [p.name for p in d.iterdir()] == ["other"]


def test_engine_multirow_conversation_ids_never_alias(store, tmp_path):
    rt = _port(store, **_tier(tmp_path, "port"))
    eng = ContinuousGenerateEngine(rt, **_knobs())
    ids = np.random.default_rng(1).integers(1, 97, (2, 9)).astype(np.int32)
    try:
        out = eng.generate(LM, ids, max_new_tokens=4, conversation_id="batch")
        tier = eng.conversation_tier
        for r in range(2):
            parked, outcome = tier.get(f"batch#r{r}", str(LM), touch=False)
            assert outcome == "hit"
            np.testing.assert_array_equal(parked.history,
                                          np.concatenate([ids[r], out[r, :3]]))
        assert tier.get("batch", str(LM), touch=False)[1] == "miss"
    finally:
        eng.close()
        rt.close()


def test_a_turn_done_at_its_first_token_parks_nothing(store, tmp_path):
    """A row that retires at its prefill (max_new 1) never had its K/V
    written into its pages, so it parks nothing (the reference parks those
    unwritten pages, ROADMAP C5); the next turn prefills cold and equals a
    cold run."""
    rt = _port(store, **_tier(tmp_path, "port"))
    eng = ContinuousGenerateEngine(rt, **_knobs())
    p1 = np.random.default_rng(8).integers(1, 97, 13).astype(np.int32)
    try:
        out1 = eng.generate(LM, p1[None], max_new_tokens=1, conversation_id="c")
        assert eng.parks == 0 and eng.conversation_tier.get("c", str(LM))[0] is None
        p2 = np.concatenate([p1, out1[0], [3, 4, 5]]).astype(np.int32)
        got, stats = eng.generate(LM, p2[None], max_new_tokens=5, conversation_id="c",
                                  return_stats=True)
        assert stats[0]["prefill_tokens"] == p2.shape[0] and stats[0]["resumes"] == 0
        np.testing.assert_array_equal(got, eng.generate(LM, p2[None], max_new_tokens=5))
        rt._slot_states[LM].check_page_conservation()
    finally:
        eng.close()
        rt.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_conversation_parked_by_one_package_resumes_in_the_other(store, direction, tmp_path):
    """Turn 1 parks in one package's engine (``park_lane`` at retirement);
    its blob (``pack_parked``) is unpacked by the other package and parked
    there; turn 2 resumes from it with the first package's own turn-2
    tokens and prefill_tokens."""
    jrt, trt = _jax(store), _port(store, **_tier(tmp_path, "port"))
    jeng = JEngine(jrt, **_knobs(), **_tier(tmp_path, "jax"))
    teng = ContinuousGenerateEngine(trt, **_knobs())
    rng = np.random.default_rng(11)
    p1 = rng.integers(1, 97, 14).astype(np.int32)
    src, dst = (jeng, teng) if direction == "jax_to_port" else (teng, jeng)
    src_mid, dst_mid = (JLM, LM) if direction == "jax_to_port" else (LM, JLM)
    src_unpack = jkv.unpack_parked if direction == "port_to_jax" else unpack_parked
    src_pack = jkv.pack_parked if direction == "jax_to_port" else pack_parked
    try:
        out1 = src.generate(src_mid, p1[None], max_new_tokens=6, conversation_id="conv")
        parked, _ = src.conversation_tier.get("conv", str(src_mid), touch=False)
        dst.conversation_tier.put("conv", src_unpack(src_pack(parked)))
        p2 = np.concatenate([p1, out1[0], rng.integers(1, 97, 5).astype(np.int32)])
        want, want_stats = src.generate(src_mid, p2[None], max_new_tokens=6,
                                        conversation_id="conv", return_stats=True)
        got, got_stats = dst.generate(dst_mid, p2[None], max_new_tokens=6,
                                      conversation_id="conv", return_stats=True)
        np.testing.assert_array_equal(got, want)
        assert got_stats[0]["prefill_tokens"] == want_stats[0]["prefill_tokens"] == 5 + 1
        trt._slot_states[LM].check_page_conservation()
    finally:
        jeng.close()
        teng.close()
        jrt.close()
        trt.close()


def test_recovery_resumes_from_parked_ancestor(store, tmp_path):
    """kill_engine mid turn 2 (the same FaultSpec in both packages): the
    recovered row resumes through the SAME parked ancestor (the tier lookup
    peeks), so its prefill across both admissions stays below one cold
    prefill of the turn-2 prompt, and its tokens and prefill_tokens equal
    the JAX engine's under the same fault."""
    results = {}
    for name in ("jax", "port"):
        if name == "jax":
            rt, mid, lab = _jax(store), JLM, jfaults
            eng = JEngine(rt, **_knobs(), **_tier(tmp_path, name))
        else:
            rt, mid, lab = _port(store, **_tier(tmp_path, name)), LM, faults
            eng = ContinuousGenerateEngine(rt, **_knobs())
        rng = np.random.default_rng(3)
        p1 = rng.integers(1, 97, 12).astype(np.int32)
        try:
            out1 = eng.generate(mid, p1[None], max_new_tokens=6, conversation_id="conv")
            p2 = np.concatenate([p1, out1[0], rng.integers(1, 97, 4).astype(np.int32)])
            ref = eng.generate(mid, p2[None], max_new_tokens=8, conversation_id="ref")
            lab.arm([lab.FaultSpec(kind="kill_engine", after=2, count=1)])
            try:
                out2, stats = eng.generate(mid, p2[None], max_new_tokens=8,
                                           conversation_id="conv", return_stats=True)
            finally:
                lab.disarm()
            np.testing.assert_array_equal(out2, ref)
            covered = 12 + 6 - 1
            assert p2.shape[0] - covered <= stats[0]["prefill_tokens"] < p2.shape[0]
            results[name] = (out2, stats[0]["prefill_tokens"])
            if name == "port":
                assert eng.recovered == 1 and stats[0]["resumes"] == 2
                rt._slot_states[mid].check_page_conservation()
        finally:
            eng.close()
            rt.close()
    np.testing.assert_array_equal(results["port"][0], results["jax"][0])
    assert results["port"][1] == results["jax"][1]
