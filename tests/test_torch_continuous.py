"""The port's continuous engine (tfservingcache_tpu_torch/runtime/batcher.py) and
REST ``:generate`` against the JAX package, on the CPU.

Config: the reference's TINY (tests/test_paged_kernel.py: 2 layers, 4 heads /
2 KV heads, d_model 48, vocab 97, max_seq 64, f32). Every arm runs one
seeded ragged schedule through the JAX ``ContinuousGenerateEngine`` and the
port's, on the same artifact. Greedy tokens must be identical (f32: the same
math, other summation order) for the dense slot array and the paged arena in
f32, bf16 and int8; the page census must be green and every page free after
each drain.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models.registry import export_artifact
from tfservingcache_tpu.runtime.batcher import ContinuousGenerateEngine as JEngine
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.runtime import model_runtime as tmr
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
PT = 8


def _ragged(rows=6, width=11, seed=0):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(2, width + 1, rows)]
    ids = np.zeros((rows, width), np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(1, TINY["vocab_size"], n)
    return ids, lens


def _runtimes(path):
    """(JAX runtime, its id, port runtime, its id) on one artifact."""
    jrt = TPUModelRuntime(JConfig(platform="cpu"))
    jmid = JModelId("lm", 1)
    jrt.ensure_loaded(JModel(identifier=jmid, path=str(path)))
    trt = TorchModelRuntime(ServingConfig(), device="cpu")
    tmid = ModelId("lm", 1)
    trt.ensure_loaded(Model(identifier=tmid, path=str(path)))
    return jrt, jmid, trt, tmid


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    return base


def _both_engines(store, schedule, max_new, **knobs):
    jrt, jmid, trt, tmid = _runtimes(store / "lm" / "1")
    jeng = JEngine(jrt, slots=4, chunk_tokens=4, **knobs)
    teng = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, **knobs)
    try:
        want = [jeng.generate(jmid, ids, prompt_lengths=lens, max_new_tokens=max_new)
                for ids, lens in schedule]
        got = [teng.generate(tmid, ids, prompt_lengths=lens, max_new_tokens=max_new)
               for ids, lens in schedule]
        return want, got, teng, trt._slot_states[tmid]
    finally:
        jeng.close()
        teng.close()
        jrt.close()


ARENAS = {
    "dense": {},
    "paged_f32": dict(page_tokens=PT, arena_pages=32),
    "paged_bf16": dict(page_tokens=PT, arena_pages=32, arena_dtype="bfloat16"),
    "paged_int8": dict(page_tokens=PT, arena_pages=32, arena_dtype="int8"),
}


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_greedy_tokens_match_the_jax_engine(store, arena):
    """Two bursts of 6 ragged rows over 4 lanes (rows queue for lanes, the
    paged arms also for pages: 12 rows x 3 pages > 32)."""
    schedule = [_ragged(seed=0), _ragged(rows=6, width=9, seed=1)]
    want, got, teng, st = _both_engines(store, schedule, 12, **ARENAS[arena])
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert teng.admitted == 12 and teng.chunks > 0
    assert teng.decode_steps >= teng.chunks
    assert st.paged == (arena != "dense")
    if st.paged:
        st.check_page_conservation()
        assert sorted(st.free_pages) == list(range(1, 33))
        assert (st.block_tables == 0).all() and not st.active.any()
        assert (st.k.dtype == torch.int8) == (arena == "paged_int8")
        assert (st.scales is not None) == (arena == "paged_int8")


def test_eos_retires_rows_where_jax_does(tmp_path):
    """With an ``eos_id`` config the rows stop at it (zero-padded after), at
    prefill and inside a chunk, exactly where the JAX engine stops them."""
    export_artifact("transformer_lm", str(tmp_path), name="lm", version=1, config=TINY, seed=3)
    ids, lens = _ragged(seed=2)
    jrt, jmid, trt, tmid = _runtimes(tmp_path / "lm" / "1")
    try:
        roll = trt.generate(tmid, ids, prompt_lengths=lens, max_new_tokens=8, seed=0)
    finally:
        jrt.close()
        trt.close()
    eos = int(roll[0, 2])  # the third token of row 0 becomes EOS
    export_artifact("transformer_lm", str(tmp_path / "eos"), name="lm", version=1,
                    config=dict(TINY, eos_id=eos), seed=3)
    want, got, _teng, st = _both_engines(tmp_path / "eos", [(ids, lens)], 8,
                                         page_tokens=PT, arena_pages=32)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][0, 2] == eos and (got[0][0, 3:] == 0).all()
    st.check_page_conservation()
    assert len(st.free_pages) == 32


def test_request_over_the_arena_gets_the_reference_error(store):
    jrt, jmid, trt, tmid = _runtimes(store / "lm" / "1")
    jeng = JEngine(jrt, slots=2, chunk_tokens=4, page_tokens=PT, arena_pages=3)
    teng = ContinuousGenerateEngine(trt, slots=2, chunk_tokens=4, page_tokens=PT, arena_pages=3)
    ids = np.ones((1, 20), np.int32)
    try:
        with pytest.raises(Exception) as jerr:
            jeng.generate(jmid, ids, max_new_tokens=10)
        with pytest.raises(RuntimeError_) as terr:
            teng.generate(tmid, ids, max_new_tokens=10)
        assert str(terr.value) == str(jerr.value)
        assert "needs 4 KV pages (30 tokens) but the arena has only 3" in str(terr.value)
        # the engine keeps serving what fits
        assert teng.generate(tmid, ids[:, :8], max_new_tokens=4).shape == (1, 4)
        trt._slot_states[tmid].check_page_conservation()
    finally:
        jeng.close()
        teng.close()
        jrt.close()


def test_seeded_and_malformed_requests_take_the_solo_path(store):
    trt = TorchModelRuntime(ServingConfig(), device="cpu")
    tmid = ModelId("lm", 1)
    trt.ensure_loaded(Model(identifier=tmid, path=str(store / "lm" / "1")))
    eng = ContinuousGenerateEngine(trt, slots=2, chunk_tokens=4)
    try:
        ids, lens = _ragged(rows=2, seed=3)
        a = eng.generate(tmid, ids, prompt_lengths=lens, max_new_tokens=6, temperature=0.9,
                         top_k=10, seed=11)
        b = trt.generate(tmid, ids, prompt_lengths=lens, max_new_tokens=6, temperature=0.9,
                         top_k=10, seed=11)
        np.testing.assert_array_equal(a, b)
        assert eng.admitted == 0
        with pytest.raises(RuntimeError_, match="prompt_lengths"):
            eng.generate(tmid, ids, prompt_lengths=[0, 3], max_new_tokens=4)
        # unseeded sampling on the engine: in-vocab, top_k=1 equals greedy
        greedy = eng.generate(tmid, ids, prompt_lengths=lens, max_new_tokens=6)
        top1 = eng.generate(tmid, ids, prompt_lengths=lens, max_new_tokens=6,
                            temperature=0.7, top_k=1)
        np.testing.assert_array_equal(top1, greedy)
        sampled = eng.generate(tmid, ids, prompt_lengths=lens, max_new_tokens=6,
                               temperature=1.0, top_k=5)
        assert ((sampled >= 0) & (sampled < 97)).all()
        assert eng.admitted == 6
    finally:
        eng.close()
        trt.close()


def test_scheduler_failure_fails_the_rows_and_drops_the_state(store, monkeypatch):
    trt = TorchModelRuntime(ServingConfig(), device="cpu")
    tmid = ModelId("lm", 1)
    trt.ensure_loaded(Model(identifier=tmid, path=str(store / "lm" / "1")))
    eng = ContinuousGenerateEngine(trt, slots=2, chunk_tokens=4, page_tokens=PT, arena_pages=16)
    try:
        def boom(state, chunk):
            raise RuntimeError("device fault")

        monkeypatch.setattr(trt, "slot_decode_chunk", boom)
        with pytest.raises(RuntimeError, match="device fault"):
            eng.generate(tmid, np.ones((3, 4), np.int32), max_new_tokens=6)
        assert tmid not in trt._slot_states
        monkeypatch.undo()
        # a fresh state serves the next request
        out = eng.generate(tmid, np.ones((1, 4), np.int32), max_new_tokens=6)
        assert out.shape == (1, 6)
        trt._slot_states[tmid].check_page_conservation()
        eng.close()
        with pytest.raises(RuntimeError_, match="closed"):
            eng.generate(tmid, np.ones((1, 4), np.int32), max_new_tokens=2)
    finally:
        eng.close()
        trt.close()


def test_pagecheck_raises_on_a_live_lane_mapped_to_the_trash_page(store, monkeypatch):
    trt = TorchModelRuntime(ServingConfig(kv_page_tokens=PT, kv_arena_pages=16), device="cpu")
    tmid = ModelId("lm", 1)
    trt.ensure_loaded(Model(identifier=tmid, path=str(store / "lm" / "1")))
    try:
        st = trt.slot_decode_state(tmid, 2)
        assert st.paged and st.arena_pages == 16 and st.pages_per_slot == 8
        assert trt.max_seq_of(tmid) == 64 and trt.eos_id_of(tmid) is None
        assert st.reserve_pages(0, 20)  # 3 pages
        assert not st.reserve_pages(1, 8 * 14)  # 14 pages > 13 free: blocked, nothing taken
        assert st.page_stats() == {"free": 13, "cached": 0, "shared": 0, "private": 3}
        st.active[0] = True
        st.pos[0] = 10
        tmr._check_trash_unreachable(st)  # pages 0..1 live, both real
        st.block_tables[0, 1] = 0
        with pytest.raises(AssertionError, match="trash page 0 at block-table slot 1"):
            tmr._check_trash_unreachable(st)
        monkeypatch.setattr(tmr, "_PAGECHECK", True)
        with pytest.raises(AssertionError, match="TPUSC_PAGECHECK"):
            trt.slot_decode_chunk(st, 1)
        st.block_tables[0, 1] = st.lane_pages[0][1]
        st.release_pages(0)
        st.check_page_conservation()
    finally:
        trt.close()


def test_int8_arena_auto_sizes_to_the_dense_byte_budget(store):
    trt = TorchModelRuntime(ServingConfig(kv_page_tokens=PT, kv_arena_dtype="int8"),
                            device="cpu")
    tmid = ModelId("lm", 1)
    trt.ensure_loaded(Model(identifier=tmid, path=str(store / "lm" / "1")))
    try:
        st = trt.slot_decode_state(tmid, 4)
        # 4 lanes x 8 pages = 32 f32 pages; hd 12: 32 * 12 * 4 // (12 + 4) = 96
        assert st.arena_pages == 96 and st.k.shape == (2, 97, 2, PT, 12)
        assert st.scales["k"].shape == (2, 97, 2, PT)
        assert trt.slot_decode_state(tmid, 8) is st  # an existing state wins
        trt.unload(tmid)
        assert tmid not in trt._slot_states  # eviction drops the slot state
    finally:
        trt.close()


# -- REST :generate -----------------------------------------------------------

def _post(url, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("engine", ["coalesce", "continuous"])
def test_rest_generate_matches_jax_runtime(store, tmp_path, engine):
    serving = {"generate_engine": engine, "generate_slots": 4, "generate_chunk_tokens": 4}
    if engine == "continuous":
        serving.update(kv_page_tokens=PT)
    cfg = config_from_dict({
        "serving": serving,
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0},
    })
    node = build_node(cfg, device="cpu")
    port = node.start("127.0.0.1")
    url = f"http://127.0.0.1:{port}/v1/models/lm/versions/1:generate"
    ids, lens = _ragged(rows=3, seed=5)
    jrt = TPUModelRuntime(JConfig(platform="cpu"))
    jmid = JModelId("lm", 1)
    jrt.ensure_loaded(JModel(identifier=jmid, path=str(store / "lm" / "1")))
    try:
        status, out = _post(url, {"input_ids": ids.tolist(), "prompt_lengths": lens,
                                  "max_new_tokens": 7})
        assert status == 200, out
        want = jrt.generate(jmid, ids, prompt_lengths=lens, max_new_tokens=7, seed=0)
        np.testing.assert_array_equal(np.asarray(out["tokens"]), want)
        assert (node.engine is not None) == (engine == "continuous")
        if node.engine is not None:
            assert node.engine.admitted == 3
            node.runtime._slot_states[ModelId("lm", 1)].check_page_conservation()
        status, seeded = _post(url, {"input_ids": ids.tolist(), "prompt_lengths": lens,
                                     "max_new_tokens": 7, "temperature": 0.9, "seed": 4})
        assert status == 200 and np.asarray(seeded["tokens"]).shape == (3, 7)
        # validated and ignored, as the reference does without the tiers
        assert _post(url, {"input_ids": [[1, 2]], "max_new_tokens": 2,
                           "conversation_id": "c1", "priority": "high"})[0] == 200
        for body in ({"input_ids": []}, {"input_ids": "x"}, {},
                     {"input_ids": [[1]], "max_new_tokens": "abc"},
                     {"input_ids": [[1]], "max_new_tokens": 0},
                     {"input_ids": [[1]], "temperature": -1},
                     {"input_ids": [[1]], "priority": "urgent"},
                     {"input_ids": [[1]], "conversation_id": ""},
                     {"input_ids": [[1]], "max_new_tokens": 100},
                     {"input_ids": [[1, 2], [3]]}):
            assert _post(url, body)[0] == 400, body
        assert _post(url, None, raw=b"{nope")[0] == 400
        # "draft_model" is served now: an unknown draft is 404
        assert _post(url, {"input_ids": [[1]], "draft_model": "d"})[0] == 404
        assert _post(url + "?stream=true", {"input_ids": [[1]]})[0] == 501
        assert _post(url.replace(":generate", ":classify"), {"input_ids": [[1]]})[0] == 501
    finally:
        jrt.close()
        node.close()
