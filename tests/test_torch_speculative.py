"""The port's speculative decoding (tfservingcache_tpu_torch/models/speculative.py,
the runtime's draft surface and the continuous engine's spec rounds) against
the JAX package, on the CPU.

Configs: the target is the reference's TINY (tests/test_paged_kernel.py: 2
layers, 4 heads / 2 KV heads, d_model 48, vocab 97, max_seq 64, f32); the
draft a 1-layer model (d_model 32, 2 heads / 1 KV head) of the same
vocabulary; "twin" is an exact copy of the target under another name (every
proposal accepted). Inputs come from ``numpy.random.default_rng(seed)``.
Everything is f32, so greedy tokens must be IDENTICAL: port vs JAX, spec-on
vs spec-off, solo vs continuous (the same math, other summation order; no
near-tie at these seeds). Page censuses must be green on both arenas.
"""

import json
import math
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models import speculative as jspec
from tfservingcache_tpu.runtime.batcher import ContinuousGenerateEngine as JEngine
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.models import generation as tgen
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import speculative as tspec
from tfservingcache_tpu_torch.models import transformer_lm as tlm
from tfservingcache_tpu_torch.runtime import model_runtime as tmr
from tfservingcache_tpu_torch.runtime.base import ModelNotLoadedError, RuntimeError_
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
DRAFT = dict(TINY, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64)
PT = 8
LM, DR, TWIN = ModelId("lm", 1), ModelId("draft", 1), ModelId("twin", 1)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    jreg.export_artifact("transformer_lm", str(base), name="twin", version=1, config=TINY, seed=3)
    jreg.export_artifact("transformer_lm", str(base), name="draft", version=1, config=DRAFT,
                         seed=5)
    jreg.export_artifact("transformer_lm", str(base), name="wide", version=1,
                         config=dict(DRAFT, vocab_size=101), seed=6)
    return base


def _port_runtime(store, names=("lm", "draft"), **serving):
    rt = TorchModelRuntime(ServingConfig(**serving), device="cpu")
    for n in names:
        rt.ensure_loaded(Model(identifier=ModelId(n, 1), path=str(store / n / "1")))
    return rt


def _jax_runtime(store, names=("lm", "draft")):
    rt = TPUModelRuntime(JConfig(platform="cpu"))
    for n in names:
        rt.ensure_loaded(JModel(identifier=JModelId(n, 1), path=str(store / n / "1")))
    return rt


def _ragged(rows=6, width=11, seed=0):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(2, width + 1, rows)]
    ids = np.zeros((rows, width), np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(1, TINY["vocab_size"], n)
    return ids, lens


def _both(cfg, seed):
    """(JAX model_def, JAX params, port model_def, port module) on one set of
    weights."""
    jdef = jreg.build("transformer_lm", cfg)
    params = jax.device_get(jdef.init(jax.random.PRNGKey(seed)))
    tdef = treg.build("transformer_lm", cfg)
    module = tdef.make_module(tlm.params_from_jax(params)).eval()
    return jdef, jax.tree_util.tree_map(jnp.asarray, params), tdef, module


# -- the solo path ------------------------------------------------------------

@pytest.mark.parametrize("spec", [1, 4, 7])
def test_speculative_generate_matches_jax(spec):
    jdef_t, p_t, tdef_t, m_t = _both(TINY, 0)
    jdef_d, p_d, tdef_d, m_d = _both(DRAFT, 1)
    ids, lens = _ragged(rows=3, width=16, seed=spec)
    lens = np.asarray(lens, np.int32)
    want, want_rounds = jspec.speculative_generate(
        jdef_t, p_t, jdef_d, p_d, ids, prompt_lengths=lens, max_new_tokens=20,
        spec_tokens=spec, return_rounds=True)
    got, rounds = tspec.speculative_generate(
        tdef_t, m_t, tdef_d, m_d, torch.from_numpy(ids), prompt_lengths=torch.from_numpy(lens),
        max_new_tokens=20, spec_tokens=spec, return_rounds=True)
    assert got.dtype == torch.int32 and got.shape == (3, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)
    plain = tgen.generate(m_t, tdef_t.config, torch.from_numpy(ids), torch.from_numpy(lens), 20)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())  # the target's own greedy decode


def test_draft_equal_to_target_leaves_no_hole():
    """Every proposal accepted: the round count stays ceil((m-1)/(spec+1))
    for the whole sequence (a never-written draft row would decay it)."""
    _jdef, _p, tdef, module = _both(TINY, 2)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 97, (1, 8)).astype(np.int32))
    spec, m = 4, 26
    out, rounds = tspec.speculative_generate(tdef, module, tdef, module, ids, max_new_tokens=m,
                                             spec_tokens=spec, return_rounds=True)
    assert rounds == math.ceil((m - 1) / (spec + 1))
    plain = tgen.generate(module, tdef.config, ids, torch.tensor([8]), m)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())


def test_speculative_generate_validation():
    _jdef, _p, tdef, module = _both(TINY, 2)
    ids = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="spec_tokens must be >= 1"):
        tspec.speculative_generate(tdef, module, tdef, module, ids, spec_tokens=0)
    wide = treg.build("transformer_lm", dict(DRAFT, vocab_size=101))
    with pytest.raises(ValueError, match="share a vocabulary"):
        tspec.speculative_generate(tdef, module, wide, module, ids)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tspec.speculative_generate(tdef, module, tdef, module, ids, max_new_tokens=61)


def test_runtime_generate_with_a_draft(store):
    """runtime.generate(draft_model_id=...) equals the JAX runtime's and the
    plain greedy decode; spec_tokens is clamped to {1, 2, 4, 8}; the
    reference's errors."""
    trt, jrt = _port_runtime(store), _jax_runtime(store)
    ids, lens = _ragged(rows=3, seed=4)
    try:
        plain = trt.generate(LM, ids, prompt_lengths=lens, max_new_tokens=10)
        want = jrt.generate(JModelId("lm", 1), ids, prompt_lengths=lens, max_new_tokens=10,
                            draft_model_id=JModelId("draft", 1), spec_tokens=4)
        for spec in (4, 3, 100000):
            got = trt.generate(LM, ids, prompt_lengths=lens, max_new_tokens=10,
                               draft_model_id=DR, spec_tokens=spec)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, plain)
        assert trt.spec_rounds["solo"] > 0 and trt.spec_emitted["solo"] == 3 * 16
        with pytest.raises(RuntimeError_, match="spec_tokens must be >= 1"):
            trt.generate(LM, ids, draft_model_id=DR, spec_tokens=0)
        with pytest.raises(RuntimeError_, match="temperature 0"):
            trt.generate(LM, ids, draft_model_id=DR, temperature=0.5)
        with pytest.raises(ModelNotLoadedError, match="draft model"):
            trt.generate(LM, ids, draft_model_id=ModelId("ghost", 1))
    finally:
        trt.close()
        jrt.close()


def test_health_gate_disables_an_all_zero_draft_and_reprobes(store):
    """A draft whose weights are all zero proposes token 0 every time; the
    target never emits 0 on this prompt, so every round accepts nothing
    (8 tokens in 7 rounds: 1.14 < 1.5 a round). After 8 such generates
    the pair is disabled: 63 generates decode plain, the 64th re-probes."""
    trt = _port_runtime(store)
    try:
        with torch.no_grad():
            for p in trt._resident.get(DR).module.parameters():
                p.zero_()
        ids = np.random.default_rng(9).integers(1, 97, (1, 6)).astype(np.int32)
        plain = trt.generate(LM, ids, max_new_tokens=8)
        assert 0 not in plain

        def rounds_after(n):
            for _ in range(n):
                np.testing.assert_array_equal(
                    trt.generate(LM, ids, max_new_tokens=8, draft_model_id=DR), plain)
            return trt.spec_rounds["solo"]

        assert rounds_after(tmr.SPEC_DISABLE_AFTER) == 7 * tmr.SPEC_DISABLE_AFTER
        assert trt._spec_health[(LM, DR)]["disabled"]
        assert rounds_after(tmr.SPEC_REPROBE_EVERY - 1) == 7 * tmr.SPEC_DISABLE_AFTER
        assert rounds_after(1) == 7 * (tmr.SPEC_DISABLE_AFTER + 1)  # the re-probe
        trt.unload(DR)  # the pair's history goes with either half
        assert (LM, DR) not in trt._spec_health
    finally:
        trt.close()


# -- the engine round ---------------------------------------------------------

@pytest.mark.parametrize("arena_dtype", ["", "int8"])
def test_paged_spec_round_matches_jax(arena_dtype):
    """One round from the same arena state: identical toks/accept/pos on the
    greedy lanes (lane 2 frozen, lane 3 sampled: it accepts nothing and
    advances by one)."""
    jdef_t, p_t, _tdef_t, m_t = _both(TINY, 0)
    jdef_d, p_d, _tdef_d, m_d = _both(DRAFT, 1)
    rng = np.random.default_rng(8)
    lanes, pps, spec = 4, 8, 4

    def arena(cfg):
        hd = cfg["d_model"] // cfg["n_heads"]
        shape = (cfg["n_layers"], lanes * pps + 1, cfg["n_kv_heads"], PT, hd)
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        if arena_dtype == "int8":
            (kq, ks), (vq, vs) = tgen._quantize_kv_rows(torch.from_numpy(k)), \
                tgen._quantize_kv_rows(torch.from_numpy(v))
            return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        return {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}

    a_t, a_d = arena(TINY), arena(DRAFT)
    pos = np.array([5, 20, 33, 50], np.int32)
    t_tab = rng.permutation(np.arange(1, lanes * pps + 1)).reshape(lanes, pps).astype(np.int32)
    d_tab = rng.permutation(np.arange(1, lanes * pps + 1)).reshape(lanes, pps).astype(np.int32)
    for s in range(lanes):
        t_tab[s, -(-(int(pos[s]) + spec + 1) // PT):] = 0
        d_tab[s, -(-(int(pos[s]) + spec + 1) // PT):] = 0
    tok = rng.integers(0, 97, lanes).astype(np.int32)
    active = np.array([True, True, False, True])
    temps = np.array([0.0, 0.0, 0.0, 0.8], np.float32)
    topks = np.array([0, 0, 0, 5], np.int32)

    def jscales(a):
        return {"k": jnp.asarray(a["k_scale"].numpy()), "v": jnp.asarray(a["v_scale"].numpy())} \
            if "k_scale" in a else None

    key = lambda cfg: tuple(sorted(cfg.items()))  # noqa: E731
    *_arenas, j_tok, j_pos, j_toks, j_acc = jspec._paged_spec_round_jit(
        p_t, p_d, jnp.asarray(a_t["k"].numpy()), jnp.asarray(a_t["v"].numpy()), jscales(a_t),
        jnp.asarray(a_d["k"].numpy()), jnp.asarray(a_d["v"].numpy()), jscales(a_d),
        jnp.asarray(t_tab), jnp.asarray(d_tab), jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(active), jax.random.PRNGKey(0), jnp.asarray(temps), jnp.asarray(topks),
        cfg_t_key=key(jdef_t.config), cfg_d_key=key(jdef_d.config), family_t="transformer_lm",
        family_d="transformer_lm", spec=spec, page_tokens=PT, kernel=False)
    tok2, pos2, toks, acc = tspec.paged_spec_round(
        m_t, jdef_t.config, m_d, jdef_d.config, a_t, a_d, torch.from_numpy(t_tab),
        torch.from_numpy(d_tab), torch.from_numpy(tok).long(), torch.from_numpy(pos),
        torch.from_numpy(active), torch.Generator().manual_seed(0), torch.from_numpy(temps),
        torch.from_numpy(topks), spec, PT, True)
    greedy = [0, 1, 2]
    np.testing.assert_array_equal(toks.numpy()[greedy], np.asarray(j_toks)[greedy])
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(pos2.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(tok2.numpy()[greedy], np.asarray(j_tok)[greedy])
    assert acc[2] == 0 and pos2[2] == pos[2] and tok2[2] == tok[2]  # frozen
    assert acc[3] == 1 and pos2[3] == pos[3] + 1 and 0 <= int(tok2[3]) < 97  # sampled


ARENAS = {
    "dense": {},
    "paged_f32": dict(page_tokens=PT, arena_pages=32),
    "paged_bf16": dict(page_tokens=PT, arena_pages=32, arena_dtype="bfloat16"),
    "paged_int8": dict(page_tokens=PT, arena_pages=32, arena_dtype="int8"),
}


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_engine_spec_on_matches_spec_off_and_the_jax_engine(store, arena):
    """Two bursts of 6 ragged rows over 4 lanes with the 1-layer draft:
    spec-on tokens equal spec-off and the JAX engine's spec-on tokens; the
    dense arm ignores the knob (no paged state)."""
    schedule = [_ragged(seed=0), _ragged(rows=6, width=9, seed=1)]
    knobs = ARENAS[arena]
    trt, jrt = _port_runtime(store), _jax_runtime(store)
    engines = {
        "jax": JEngine(jrt, slots=4, chunk_tokens=4, spec_draft_model="draft", spec_tokens=4,
                       **knobs),
        "on": ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, spec_draft_model="draft",
                                       spec_tokens=4, **knobs),
    }
    try:
        out = {name: [eng.generate(JModelId("lm", 1) if name == "jax" else LM, ids,
                                   prompt_lengths=lens, max_new_tokens=12)
                      for ids, lens in schedule]
               for name, eng in engines.items()}
        st = trt._slot_states[LM]
        on = engines["on"]
        if st.paged:
            assert on.spec_rounds > 0 and on.accepted > 0 and on.drafted >= 4 * on.spec_rounds
            for s in (st, st.spec_draft):
                s.check_page_conservation()
                assert sorted(s.free_pages) == list(range(1, s.arena_pages + 1))
            assert (st.spec_draft.k.dtype == torch.int8) == (arena == "paged_int8")
        else:
            assert on.spec_rounds == 0 and st.spec_draft is None
        on.close()
        trt.drop_slot_state(LM)
        engines["off"] = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4,
                                                  spec_draft_model="", **knobs)
        out["off"] = [engines["off"].generate(LM, ids, prompt_lengths=lens, max_new_tokens=12)
                      for ids, lens in schedule]
        assert engines["off"].spec_rounds == 0
        for w, g, off in zip(out["jax"], out["on"], out["off"]):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, off)
    finally:
        for eng in engines.values():
            eng.close()
        trt.close()
        jrt.close()


def test_solo_and_continuous_spec_agree(store):
    trt = _port_runtime(store, names=("lm", "twin"))
    eng = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, page_tokens=PT,
                                   spec_draft_model="twin@1")
    ids, lens = _ragged(rows=4, seed=6)
    try:
        cont = eng.generate(LM, ids, prompt_lengths=lens, max_new_tokens=14)
        solo = trt.generate(LM, ids, prompt_lengths=lens, max_new_tokens=14, draft_model_id=TWIN)
        np.testing.assert_array_equal(cont, solo)
        # an exact copy accepts every proposal: 13 tokens after the prefill's
        # in ceil(13 / 5) = 3 rounds for each row
        assert eng.spec_rounds == 3 and eng.accepted == 4 * 13 + 4 * 2
        assert trt.spec_rounds["continuous"] == 4 * 3
    finally:
        eng.close()
        trt.close()


def test_census_green_under_recycling_with_pagecheck(store, monkeypatch):
    """16 rows through a 12-page arena (rows wait for pages) with the
    pre-round trash-page check armed on both states."""
    monkeypatch.setattr(tmr, "_PAGECHECK", True)
    trt = _port_runtime(store)
    eng = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, page_tokens=PT, arena_pages=12,
                                   spec_draft_model="draft", spec_tokens=2)
    off = ContinuousGenerateEngine(_port_runtime(store), slots=4, chunk_tokens=4, page_tokens=PT,
                                   arena_pages=12)
    ids, lens = _ragged(rows=16, width=12, seed=7)
    try:
        got = eng.generate(LM, ids, prompt_lengths=lens, max_new_tokens=10)
        want = off.generate(LM, ids, prompt_lengths=lens, max_new_tokens=10)
        np.testing.assert_array_equal(got, want)
        st = trt._slot_states[LM]
        assert st.spec_tokens == 2 and eng.spec_rounds > 0 and eng.admitted == 16
        for s in (st, st.spec_draft):
            s.check_page_conservation()
            assert sorted(s.free_pages) == list(range(1, s.arena_pages + 1))
            assert (s.block_tables == 0).all()
    finally:
        eng.close()
        off.close()
        trt.close()


def test_draft_eviction_detaches_and_decodes_plain(store, monkeypatch):
    trt = _port_runtime(store)
    eng = ContinuousGenerateEngine(trt, slots=4, chunk_tokens=4, page_tokens=PT,
                                   spec_draft_model="draft")
    ids, lens = _ragged(rows=4, seed=8)
    try:
        plain = trt.generate(LM, ids, prompt_lengths=lens, max_new_tokens=12)
        np.testing.assert_array_equal(
            eng.generate(LM, ids, prompt_lengths=lens, max_new_tokens=12), plain)
        rounds = eng.spec_rounds
        assert rounds > 0 and trt._slot_states[LM].spec_draft is not None
        real = trt.slot_decode_spec_round

        def evict_then_round(state):
            trt.unload(DR)  # the draft goes between the residency check and the round
            return real(state)

        monkeypatch.setattr(trt, "slot_decode_spec_round", evict_then_round)
        steps = eng.decode_steps
        np.testing.assert_array_equal(
            eng.generate(LM, ids, prompt_lengths=lens, max_new_tokens=12), plain)
        st = trt._slot_states[LM]
        assert st.spec_draft is None and st.spec_tokens == 0
        assert eng.spec_rounds == rounds and eng.decode_steps > steps
        st.check_page_conservation()
        assert len(st.free_pages) == st.arena_pages
    finally:
        eng.close()
        trt.close()


def test_slot_attach_draft_contract(store):
    trt = _port_runtime(store, names=("lm", "draft", "wide"))
    try:
        dense = trt.slot_decode_state(LM, 2)
        with pytest.raises(RuntimeError_, match="paged slot state"):
            trt.slot_attach_draft(dense, DR)
        trt.drop_slot_state(LM)
        st = trt.slot_decode_state(LM, 2, page_tokens=PT, arena_pages=8, arena_dtype="int8")
        with pytest.raises(ModelNotLoadedError, match="ghost"):
            trt.slot_attach_draft(st, ModelId("ghost", 1))
        with pytest.raises(RuntimeError_, match="share a vocabulary"):
            trt.slot_attach_draft(st, ModelId("wide", 1))
        with pytest.raises(RuntimeError_, match="spec_tokens must be >= 1"):
            trt.slot_attach_draft(st, DR, 0)
        with pytest.raises(RuntimeError_, match="no draft attached"):
            trt.slot_decode_spec_round(st)
        d_st = trt.slot_attach_draft(st, DR, 3)
        assert st.spec_tokens == 4 and st.spec_draft is d_st and st.spec_draft_id == DR
        assert trt.slot_attach_draft(st, DR, 100) is d_st  # idempotent
        # the draft's own auto-sized arena, int8 and kernel flag like the target's
        assert d_st.paged and d_st.page_tokens == PT and d_st.slots == 2
        assert d_st.k.dtype == torch.int8 and d_st.kernel == st.kernel
        assert d_st.tok is st.tok and d_st.pos is st.pos and d_st.active is st.active
        assert LM in trt._slot_states and DR not in trt._slot_states
        trt.unload(LM)  # the target's slot state goes, its draft state with it
        assert LM not in trt._slot_states
    finally:
        trt.close()


# -- REST :generate -----------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _node(store, tmp_path, **serving):
    cfg = config_from_dict({
        "serving": serving,
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0},
    })
    node = build_node(cfg, device="cpu")
    return node, f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/lm/versions/1:generate"


def test_rest_draft_model_contract(store, tmp_path):
    node, url = _node(store, tmp_path)
    jrt = _jax_runtime(store)
    ids, lens = _ragged(rows=2, seed=10)
    body = {"input_ids": ids.tolist(), "prompt_lengths": lens, "max_new_tokens": 9}
    try:
        want = jrt.generate(JModelId("lm", 1), ids, prompt_lengths=lens, max_new_tokens=9,
                            draft_model_id=JModelId("draft", 1))
        for draft in ("draft", {"name": "draft"}, {"name": "draft", "version": 1}):
            status, out = _post(url, dict(body, draft_model=draft))
            assert status == 200, out
            np.testing.assert_array_equal(np.asarray(out["tokens"]), want)
        assert node.runtime.is_loaded(DR)  # ensured beside the target
        status, out = _post(url, dict(body, draft_model="draft", spec_tokens=100000))
        assert status == 200 and out["tokens"] == want.tolist()  # clamped to 8
        assert _post(url, dict(body, draft_model="ghost"))[0] == 404
        for bad in ({"version": 1}, 5, {"name": "draft", "version": "x"}):
            assert _post(url, dict(body, draft_model=bad))[0] == 400, bad
        status, out = _post(url, dict(body, draft_model="draft", temperature=0.9))
        assert status == 400 and "temperature 0" in out["error"]
        for spec in (0, "abc"):
            assert _post(url, dict(body, draft_model="draft", spec_tokens=spec))[0] == 400
        assert _post(url + "?stream=true", dict(body, draft_model="draft"))[0] == 501
    finally:
        jrt.close()
        node.close()


def test_rest_engine_spec_rounds(store, tmp_path):
    """serving.spec_draft_model: the backend loads the draft beside the
    target and the continuous engine replaces every chunk with a round (the
    exact copy keeps the health gate open)."""
    node, url = _node(store, tmp_path, generate_engine="continuous", generate_slots=4,
                      generate_chunk_tokens=4, kv_page_tokens=PT, spec_draft_model="twin",
                      spec_tokens=2)
    jrt = _jax_runtime(store, names=("lm",))
    ids, lens = _ragged(rows=3, seed=11)
    try:
        status, out = _post(url, {"input_ids": ids.tolist(), "prompt_lengths": lens,
                                  "max_new_tokens": 10})
        assert status == 200, out
        want = jrt.generate(JModelId("lm", 1), ids, prompt_lengths=lens, max_new_tokens=10)
        np.testing.assert_array_equal(np.asarray(out["tokens"]), want)
        assert node.engine.spec_rounds > 0 and node.engine.decode_steps == 0
        st = node.runtime._slot_states[LM]
        assert st.spec_draft_id == TWIN and st.spec_tokens == 2
        for s in (st, st.spec_draft):
            s.check_page_conservation()
    finally:
        jrt.close()
        node.close()
