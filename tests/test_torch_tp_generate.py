"""``:generate`` on a tensor-parallel group in the port (the KV-head-sharded
cache and arena of parallel/sharding.py, the shard-by-shard cached forward
of models/generation.py, the continuous engine, speculation and
conversations over ``TensorParallelLM``) against the JAX package's
single-process mesh engine on the virtual 8-device CPU mesh
(tests/conftest.py), mirroring tests/test_mesh_parity.py:79, :149, :250 and
:361.

Setup: the reference's f32 ``SMALL`` (2 layers, 4 heads over 2 KV heads,
pages of 16), exported once by the JAX package. The JAX side runs on
``make_mesh({"model": 2})``; the port's on the groups ``["cpu"] * 2`` (the
arena cut, one KV head a shard) and ``["cpu"] * 4`` (4 does not divide 2 KV
heads: attention and the arena whole on the leader, the FFN and the
embedding cut).

Bars: greedy tokens IDENTICAL at f32 (to the JAX mesh engine, to the port's
one-device engine, and between a speculative and a plain decode), seeded
samples identical to the port's one-device run; the census green after each
drain; the arena gauge EQUAL to the sum of the shards' bytes; the paged
helpers' layout ``torch.equal`` to one device's. bf16 logits of the group's
cached forward within the ``BAR = 5e-2`` of test_torch_sharding.py against
the JAX forward (measured max |diff| 0.039 at P = 2 and 0.047 at P = 4; the
f32 group sits 1.4e-6 from the port's one-device cached forward, within
1e-5). ``-s`` prints the measured errors.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.parallel import sharding as jsharding
from tfservingcache_tpu.parallel.mesh import make_mesh
from tfservingcache_tpu.runtime.batcher import ContinuousGenerateEngine as JEngine
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.models import generation as tgen
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import transformer_lm as tlm
from tfservingcache_tpu_torch.parallel import sharding
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId
from tfservingcache_tpu_torch.utils.metrics import Metrics

from torch_obs_globals import confined_globals

# the reference's mesh-parity config (tests/test_mesh_parity.py:29)
SMALL = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
         "d_ff": 128, "max_seq": 128, "dtype": "float32"}
# tests/test_torch_sharding.py:57, in f32
MOE_TINY = {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 4, "n_kv_heads": 4,
            "d_ff": 64, "n_experts": 4, "max_seq": 32, "dtype": "float32"}
PT = 16
BAR = 5e-2
LM, TWIN = ModelId("lm", 1), ModelId("twin", 1)
TOPOLOGY = {"mesh_devices": 2, "mesh_axes": {"model": 2}, "mesh_fast_path": True}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp_gen_store")
    for name in ("lm", "twin"):
        jreg.export_artifact("transformer_lm", str(base), name=name, version=1, config=SMALL,
                             seed=0)
    jreg.export_artifact("moe_lm", str(base), name="moe", version=1, config=MOE_TINY, seed=6)
    return base


def _model(store, name: str) -> Model:
    return Model(identifier=ModelId(name, 1), path=str(store / name / "1"))


def _port(store, n: int, names=("lm",), metrics=None, **serving) -> TorchModelRuntime:
    """The port's runtime on ``["cpu"] * n`` (one device for n = 1) with
    ``names`` loaded."""
    devices = dict(devices=["cpu"] * n) if n > 1 else dict(device="cpu")
    rt = TorchModelRuntime(ServingConfig(**serving), metrics=metrics, **devices)
    for name in names:
        rt.ensure_loaded(_model(store, name))
    return rt


def _jax_mesh(store, names=("lm",)) -> TPUModelRuntime:
    rt = TPUModelRuntime(JConfig(platform="cpu"), mesh=make_mesh({"model": 2}))
    for name in names:
        rt.ensure_loaded(JModel(identifier=JModelId(name, 1), path=str(store / name / "1")))
    return rt


def _engine(rt, **kw) -> ContinuousGenerateEngine:
    kw.setdefault("page_tokens", PT)
    kw.setdefault("share_prefix_bytes", 1 << 20)
    return ContinuousGenerateEngine(rt, slots=4, chunk_tokens=4, **kw)


# -- the sharded cache ----------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "paged", "int8"])
def test_shard_kv_arena_cuts_the_head_axis_into_contiguous_shards(kind, n):
    """Each cut buffer is a ``KVShards`` of contiguous tensors with storage
    of their own (never views of one global arena), holding the head slice
    the reference's spec names; at n = 4 the 2 KV heads are not cut and the
    buffer is one tensor on the leader. The specs are the reference's
    ``kv_arena_shardings``."""
    group = (torch.device("cpu"),) * n
    if kind == "dense":
        cache = tgen.init_cache(SMALL, 3, 32, "cpu")
    else:
        cache = tgen.init_paged_cache(SMALL, 9, PT, "int8" if kind == "int8" else "", "cpu")
    gen = torch.Generator().manual_seed(n)
    for t in cache.values():
        t.copy_((torch.randn(t.shape, generator=gen) * 50).to(t.dtype))
    placed = sharding.shard_kv_arena(cache, group)
    want = jsharding.kv_arena_shardings(make_mesh({"model": n}),
                                        {k: np.asarray(v.float()) for k, v in cache.items()})
    assert set(placed) == set(cache)
    for name, buf in cache.items():
        spec = sharding.kv_arena_shardings({"model": n}, cache)[name]
        assert spec == tuple(want[name].spec), name
        got = placed[name]
        if n == 4:
            assert isinstance(got, torch.Tensor) and torch.equal(got, buf)
            assert got.data_ptr() != buf.data_ptr()
            continue
        assert isinstance(got, sharding.KVShards) and len(got.shards) == n
        assert got.shape == buf.shape and got.dtype == buf.dtype and got.nbytes == buf.nbytes
        size = buf.shape[2] // n
        for i, shard in enumerate(got.shards):
            assert shard.is_contiguous()
            assert torch.equal(shard, buf.narrow(2, i * size, size))
            assert shard.untyped_storage().data_ptr() != buf.untyped_storage().data_ptr()
        assert torch.equal(got.gather(), buf)
    # the group's own allocation: zeros, each shard contiguous, no whole copy
    alloc = (tgen.init_cache(SMALL, 3, 32, "cpu", group) if kind == "dense" else
             tgen.init_paged_cache(SMALL, 9, PT, "int8" if kind == "int8" else "", "cpu", group))
    for name, buf in alloc.items():
        assert buf.shape == cache[name].shape and buf.dtype == cache[name].dtype
        for shard in sharding.kv_shards(buf):
            assert shard.is_contiguous() and not shard.is_meta and not shard.any()


def test_batch_and_replicated_specs_are_the_references():
    for n in (1, 2):
        mesh = make_mesh({"model": n})
        assert sharding.replicated({"model": n}) == tuple(jsharding.replicated(mesh).spec)
        assert sharding.batch_sharding({"model": n}) == tuple(
            jsharding.batch_sharding(mesh).spec)
    assert sharding.batch_sharding({"data": 2, "model": 2}) == tuple(
        jsharding.batch_sharding(make_mesh({"data": 2, "model": 2})).spec) == ("data",)


@pytest.mark.parametrize("arena_dtype", ["", "int8"])
def test_pages_export_of_a_group_is_the_one_device_layout(arena_dtype):
    """The same arena content placed on a group and on one device exports
    ``torch.equal`` pages (the shards concatenated on the head axis, in
    shard order); an import splits them back, and a park on the group
    followed by an import on one device (and the reverse) leaves every page
    bit-identical. So the conversation tier, its disk spill and the peer
    wire carry the same bytes whichever placement parked them."""
    group = (torch.device("cpu"),) * 2
    one = tgen.init_paged_cache(SMALL, 9, PT, arena_dtype, "cpu")
    gen = torch.Generator().manual_seed(5)
    for t in one.values():
        t.copy_((torch.randn(t.shape, generator=gen) * 50).to(t.dtype))
    tp = sharding.shard_kv_arena(one, group)
    pages = [7, 2, 5]
    got, want = tgen.pages_export(tp, pages), tgen.pages_export(one, pages)
    assert set(got) == set(want) == set(one)
    for name in want:
        assert got[name].shape == want[name].shape and torch.equal(got[name], want[name])
    # park on the group, resume on one device and on the group
    back_one = tgen.init_paged_cache(SMALL, 9, PT, arena_dtype, "cpu")
    back_tp = tgen.init_paged_cache(SMALL, 9, PT, arena_dtype, "cpu", group)
    tgen.pages_import(back_one, [1, 3, 8], got)
    tgen.pages_import(back_tp, [1, 3, 8], want)
    for name, buf in one.items():
        ref = buf[:, pages]
        assert torch.equal(back_one[name][:, [1, 3, 8]], ref)
        assert torch.equal(back_tp[name].gather()[:, [1, 3, 8]], ref)
    # copy-on-write and the shared-prefix gather work shard by shard
    tgen.page_copy(tp, 7, 4)
    tgen.page_copy(one, 7, 4)
    ck_tp, cv_tp = tgen.paged_gather_prefix(tp, [4, 2])
    ck, cv = tgen.paged_gather_prefix(one, [4, 2])
    assert isinstance(ck_tp, sharding.KVShards)
    assert torch.equal(ck_tp.gather(), ck) and torch.equal(cv_tp.gather(), cv)


# -- the cached forward ----------------------------------------------------------

def _cached_logits(module, cfg, ids, group=None) -> np.ndarray:
    """Logits of a prefill through ``_forward_cached_dyn`` (cache placed on
    ``group``), then one decode step on top of it."""
    b, s = ids.shape
    with torch.inference_mode():
        cache = tgen.init_cache(cfg, b, s + 1, "cpu", group)
        pre = tgen._forward_cached_dyn(module, torch.from_numpy(ids), cache,
                                       torch.zeros(b, dtype=torch.long), cfg)
        step = tgen._forward_cached_dyn(module, torch.from_numpy(ids[:, -1:]), cache,
                                        torch.full((b,), s, dtype=torch.long), cfg)
    return torch.cat([pre, step], dim=1).numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_group_cached_forward_holds_the_bars(n):
    """bf16: within BAR of the JAX forward over the same tokens; f32:
    within 1e-5 of the port's one-device cached forward (the partials add
    in another order)."""
    group = (torch.device("cpu"),) * n
    ids = np.random.default_rng(n).integers(0, 128, (2, 9)).astype(np.int32)
    seq = np.concatenate([ids, ids[:, -1:]], axis=1)
    for dtype in ("bfloat16", "float32"):
        jmodel = jreg.build("transformer_lm", dict(SMALL, dtype=dtype))
        jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
        params = tlm.params_from_jax(jparams)
        model = treg.build("transformer_lm", dict(SMALL, dtype=dtype))
        cfg = model.config
        plan = model.tensor_parallel(group)
        module = plan.make_module(sharding.shard_params(params, plan.rules, group))
        got = _cached_logits(module, cfg, ids, group)
        if dtype == "bfloat16":
            want = np.asarray(jmodel.apply(jparams, {"input_ids": seq})["logits"])
            np.testing.assert_allclose(got, want, atol=BAR, rtol=BAR)
            print(f"P={n} bf16: max|diff| vs the JAX forward {np.abs(got - want).max():.3g}")
        else:
            one = model.make_module(params)
            want = _cached_logits(one, cfg, ids)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            print(f"P={n} f32: max|diff| vs one device {np.abs(got - want).max():.3g}")


def test_each_shard_attends_its_own_heads_on_its_arena_shard(store, monkeypatch):
    """One decode dispatch a layer and shard (the B1 launches on a card are
    n_layers x P x decode steps), each over one query-head pair and one KV
    head of a contiguous arena shard; the chunked prefill's verify
    dispatch the same (n_layers x P x chunks)."""
    seen = {"decode": [], "verify": []}

    def spy(kind, real):
        def call(q, k_pages, v_pages, *a, **kw):
            seen[kind].append((tuple(q.shape), tuple(k_pages.shape), k_pages.is_contiguous()))
            return real(q, k_pages, v_pages, *a, **kw)
        return call

    monkeypatch.setattr(tgen, "paged_attention", spy("decode", tgen.paged_attention))
    monkeypatch.setattr(tgen, "paged_attention_verify",
                        spy("verify", tgen.paged_attention_verify))
    rt = _port(store, 2)
    eng = _engine(rt, prefill_chunk_tokens=8, share_prefix_bytes=0)
    try:
        p = np.arange(1, 21, dtype=np.int32)[None]
        eng.generate(LM, p, max_new_tokens=5)
        steps = eng.decode_steps
        assert steps > 0 and len(seen["decode"]) == SMALL["n_layers"] * 2 * steps
        assert eng.prefill_chunks == 3
        assert len(seen["verify"]) == SMALL["n_layers"] * 2 * 3
        for kind in seen:
            for q_shape, k_shape, contiguous in seen[kind]:
                assert q_shape[1] == 2 and k_shape[1] == 1 and contiguous, (kind, q_shape)
    finally:
        eng.close()
        rt.close()


# -- the continuous engine -------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_continuous_paged_generate_greedy_parity_on_a_group(store, tmp_path, n):
    """Greedy continuous-engine decode on a group emits exactly the JAX mesh
    engine's tokens and the port's one-device tokens, across a chunked
    prefill, a shared-prefix hit with equal ``prefill_tokens`` and a
    conversation resume, with the kernel asked for (the plain path on the
    CPU); both censuses are green."""
    tier = dict(conversation_kv_bytes=16 << 20)
    rt1 = _port(store, 1, conversation_kv_dir=str(tmp_path / "one"), **tier)
    rtn = _port(store, n, conversation_kv_dir=str(tmp_path / "group"), **tier)
    jrt = _jax_mesh(store)
    engines = {
        "one": _engine(rt1, prefill_chunk_tokens=8, paged_kernel=False),
        "group": _engine(rtn, prefill_chunk_tokens=8, paged_kernel=True),
        "jax": JEngine(jrt, slots=4, chunk_tokens=4, page_tokens=PT, share_prefix_bytes=1 << 20,
                       prefill_chunk_tokens=8, conversation_kv_bytes=16 << 20),
    }
    assert rtn.mesh_topology() == {"mesh_devices": n, "mesh_axes": {"model": n},
                                   "mesh_fast_path": True}
    assert rt1.mesh_topology() is None
    rng = np.random.default_rng(7)
    p1 = rng.integers(1, SMALL["vocab_size"], 24).astype(np.int32)
    extra = rng.integers(1, SMALL["vocab_size"], 5).astype(np.int32)
    try:
        turn1 = {k: e.generate(e is engines["jax"] and JModelId("lm", 1) or LM, p1[None],
                               max_new_tokens=8, conversation_id="conv")
                 for k, e in engines.items()}
        np.testing.assert_array_equal(turn1["group"], turn1["one"])
        np.testing.assert_array_equal(turn1["group"], turn1["jax"])
        assert engines["group"].prefill_chunks == engines["one"].prefill_chunks == 3
        st = rtn._slot_states[LM]
        assert st.kernel is True
        assert isinstance(st.k, sharding.KVShards) == (n == 2)
        for shard in sharding.kv_shards(st.k):
            assert shard.is_contiguous() and shard.shape[2] == (1 if n == 2 else 2)
        assert st.k.shape == rt1._slot_states[LM].k.shape

        # the shared-prefix hit: the same prompt prefills only its tail
        hits = {k: e.generate(e is engines["jax"] and JModelId("lm", 1) or LM, p1[None],
                              max_new_tokens=8, return_stats=True)
                for k, e in engines.items()}
        np.testing.assert_array_equal(hits["group"][0], hits["one"][0])
        np.testing.assert_array_equal(hits["group"][0], hits["jax"][0])
        tokens = {k: h[1][0]["prefill_tokens"] for k, h in hits.items()}
        assert tokens["group"] == tokens["one"] == tokens["jax"] < p1.shape[0]

        # the conversation's second turn resumes from its parked pages
        p2 = np.concatenate([p1, turn1["one"][0].astype(np.int32), extra])
        turn2 = {k: e.generate(e is engines["jax"] and JModelId("lm", 1) or LM, p2[None],
                               max_new_tokens=8, conversation_id="conv", return_stats=True)
                 for k, e in engines.items()}
        np.testing.assert_array_equal(turn2["group"][0], turn2["one"][0])
        np.testing.assert_array_equal(turn2["group"][0], turn2["jax"][0])
        stats = {k: t[1][0] for k, t in turn2.items()}
        assert stats["group"]["resumes"] == stats["one"]["resumes"] == 1
        assert (stats["group"]["prefill_tokens"] == stats["one"]["prefill_tokens"]
                == stats["jax"]["prefill_tokens"] < p2.shape[0] - p1.shape[0])
        for rt in (rt1, rtn):
            rt._slot_states[LM].check_page_conservation()
        jrt._slot_states[JModelId("lm", 1)].check_page_conservation()
    finally:
        for e in engines.values():
            e.close()
        for rt in (rt1, rtn, jrt):
            rt.close()


def test_dense_slot_array_on_a_group_equals_one_device(store):
    """With ``kv_page_tokens`` 0 the engine's dense slot array is cut over
    the KV heads as the arena is, and decodes the one-device tokens."""
    rt1, rt2 = _port(store, 1), _port(store, 2)
    engines = [_engine(rt, page_tokens=0, share_prefix_bytes=0) for rt in (rt1, rt2)]
    ids = np.random.default_rng(4).integers(1, 128, (3, 13)).astype(np.int32)
    try:
        one, group = (e.generate(LM, ids, max_new_tokens=7) for e in engines)
        np.testing.assert_array_equal(group, one)
        st = rt2._slot_states[LM]
        assert not st.paged and isinstance(st.k, sharding.KVShards)
        assert st.k.shape == rt1._slot_states[LM].k.shape
    finally:
        for e in engines:
            e.close()
        rt1.close()
        rt2.close()


def test_int8_arena_census_and_bytes_gauge_on_a_group(store):
    """A mixed-priority burst on the group's int8 arena: the census stays
    green, the scales are cut with the payload, and
    ``tpusc_gen_kv_arena_bytes`` is the sum of the shards' bytes, which
    equals the one-device int8 arena's."""
    metrics = Metrics(model_labels=True)
    rt = _port(store, 2, metrics=metrics, kv_arena_dtype="int8")
    one = _port(store, 1, kv_arena_dtype="int8")
    eng, eng1 = _engine(rt, metrics=metrics), _engine(one)
    rng = np.random.default_rng(3)
    try:
        for i, pr in enumerate(("high", "normal", "low", "normal")):
            p = rng.integers(1, SMALL["vocab_size"], 10 + 3 * i).astype(np.int32)[None]
            out = eng.generate(LM, p, max_new_tokens=6, priority=pr)
            np.testing.assert_array_equal(out, eng1.generate(LM, p, max_new_tokens=6,
                                                             priority=pr))
        st = rt._slot_states[LM]
        st.check_page_conservation()
        buffers = [st.k, st.v, *st.scales.values()]
        for buf in buffers:
            assert isinstance(buf, sharding.KVShards) and len(buf.shards) == 2
            assert all(s.shape[2] == 1 and s.is_contiguous() for s in buf.shards)
        expect = sum(t.nbytes for buf in buffers for t in buf.shards)
        got = metrics.gen_kv_arena_bytes.labels(dtype="int8").value
        st1 = one._slot_states[LM]
        assert got == expect == st1.k.nbytes * 2 + sum(t.nbytes for t in st1.scales.values())
    finally:
        eng.close()
        eng1.close()
        rt.close()
        one.close()


# -- the solo path and speculation -----------------------------------------------

def test_seeded_sampling_on_a_group_equals_one_device(store):
    rt1, rt2 = _port(store, 1), _port(store, 2)
    ids = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]], np.int32)
    try:
        for temp, top_k in ((0.7, 8), (1.0, 0)):
            a = rt1.generate(LM, ids, max_new_tokens=10, temperature=temp, top_k=top_k,
                             seed=1234)
            b = rt2.generate(LM, ids, max_new_tokens=10, temperature=temp, top_k=top_k,
                             seed=1234)
            np.testing.assert_array_equal(a, b)
    finally:
        rt1.close()
        rt2.close()


@pytest.mark.parametrize("name,n", [("lm", 2), ("lm", 4), ("moe", 2)])
def test_solo_greedy_generate_on_a_group_equals_the_jax_mesh(store, name, n):
    """transformer_lm on groups of 2 and 4 and moe_lm (experts replicated on
    the leader) on a group of 2 against the JAX runtime on
    ``make_mesh({"model": 2})``; then B = 1 turns through the prefix cache
    (a miss stores the group's cache rows, the next turn continues from
    them) against the port's one-device runtime with the same cache (a
    suffix-only prefill routes moe_lm's experts over another shape than the
    JAX runtime's full prefill)."""
    mid = ModelId(name, 1)
    rt = _port(store, n, names=(name,), prefix_cache_bytes=1 << 20)
    one = _port(store, 1, names=(name,), prefix_cache_bytes=1 << 20)
    jrt = _jax_mesh(store, names=(name,))
    vocab = (MOE_TINY if name == "moe" else SMALL)["vocab_size"]
    ids = np.random.default_rng(9).integers(1, vocab, (2, 7)).astype(np.int32)
    try:
        assert rt._resident.get(mid, touch=False).tensor_parallel
        got = rt.generate(mid, ids, max_new_tokens=9)
        want = np.asarray(jrt.generate(JModelId(name, 1), ids, max_new_tokens=9))
        np.testing.assert_array_equal(got, want)
        row = ids[:1]
        first = rt.generate(mid, row, max_new_tokens=9)
        np.testing.assert_array_equal(first, one.generate(mid, row, max_new_tokens=9))
        turn2 = np.concatenate([row, first, row[:, :3]], axis=1)
        hit = rt._prefix_cache.lookup(mid, turn2[0])
        assert hit is not None and len(sharding.kv_shards(hit.k)) == (2 if n == 2 else 1)
        np.testing.assert_array_equal(rt.generate(mid, turn2, max_new_tokens=4),
                                      one.generate(mid, turn2, max_new_tokens=4))
        # the group's count includes the lookup above
        assert rt._prefix_cache.hits == 2 and one._prefix_cache.hits == 1
    finally:
        rt.close()
        one.close()
        jrt.close()


def test_speculation_with_an_exact_copy_draft_on_a_group(store):
    """The draft, loaded on the same group, is cut by the same rules; the
    solo speculative decode and the engine's rounds emit the plain decode
    and accept every proposal."""
    rt = _port(store, 2, names=("lm", "twin"))
    eng = _engine(rt, spec_draft_model="twin@1", share_prefix_bytes=0)
    ids = np.random.default_rng(2).integers(1, 128, (2, 11)).astype(np.int32)
    try:
        assert rt._resident.get(TWIN, touch=False).tensor_parallel
        plain = rt.generate(LM, ids, max_new_tokens=14)
        solo = rt.generate(LM, ids, max_new_tokens=14, draft_model_id=TWIN)
        np.testing.assert_array_equal(solo, plain)
        cont = eng.generate(LM, ids, max_new_tokens=14)
        np.testing.assert_array_equal(cont, plain)
        st = rt._slot_states[LM]
        assert isinstance(st.spec_draft.k, sharding.KVShards)
        # 13 tokens after the prefill's in ceil(13 / 5) = 3 full rounds a row
        assert eng.spec_rounds == 3 and eng.accepted == 2 * 13 + 2 * 2
        st.check_page_conservation()
        st.spec_draft.check_page_conservation()
    finally:
        eng.close()
        rt.close()


# -- the node ------------------------------------------------------------------

def _post(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_monitoring_engine_reports_the_group(store, tmp_path):
    """``/monitoring/engine`` of a two-device node carries the reference's
    ``"mesh"`` dict after a REST ``:generate`` on the continuous engine; a
    one-device node's has none."""
    jrt = _jax_mesh(store)
    try:
        assert jrt.mesh_topology() == TOPOLOGY
    finally:
        jrt.close()
    snaps = {}
    for chips in (2, 1):
        cfg = config_from_dict({
            "mesh": {"chips_per_group": chips},
            "serving": {"generate_engine": "continuous", "generate_slots": 2,
                        "kv_page_tokens": PT, "kv_arena_pages": 32},
            "cache": {"base_dir": str(tmp_path / f"cache{chips}")},
            "model_provider": {"base_dir": str(store)},
            "cache_node": {"rest_port": 0, "grpc_port": 0},
        })
        with confined_globals():
            node = build_node(cfg, device="cpu")
            try:
                port = node.start("127.0.0.1")
                status, body = _post(f"http://127.0.0.1:{port}/v1/models/lm:generate",
                                     {"input_ids": [[3, 5, 7, 9]], "max_new_tokens": 4})
                assert status == 200 and np.asarray(body["tokens"]).shape == (1, 4)
                assert node.engine.admitted == 1
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/monitoring/engine?reset=0", timeout=60) as r:
                    snaps[chips] = json.loads(r.read())
            finally:
                node.close()
    assert snaps[2]["mesh"] == TOPOLOGY
    assert "mesh" not in snaps[1]
