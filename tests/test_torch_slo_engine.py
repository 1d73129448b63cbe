"""The port's SLO engine on ``:generate`` (runtime/batcher.py: priority
admission, preemption through the conversation park, crash recovery with
``lab/faults.py``'s ``kill_engine`` seam; protocol/local_backend.py and
protocol/rest.py: ``?stream=true`` over SSE) against the JAX package, on the
CPU (mirrors tests/test_slo_engine.py minus gRPC, the router and the
coalescer, which the port does not have yet).

Config: the reference's TINY (2 layers, 4 heads / 2 KV heads, d_model 48,
vocab 97, max_seq 64, f32), pages of 8 tokens. f32 throughout, so greedy
tokens must be IDENTICAL: between the two packages' engines under the same
admissions, preemptions and ``FaultSpec``, and between a contended, killed
or streamed run and a plain one. The page census must be green after each
drain.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.lab import faults as jfaults
from tfservingcache_tpu.models.registry import export_artifact
from tfservingcache_tpu.runtime import batcher as jbatcher
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict
from tfservingcache_tpu_torch.lab import faults
from tfservingcache_tpu_torch.runtime import batcher as tbatcher
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import Model, ModelId

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
PT = 8
LM = ModelId("lm", 1)
JLM = JModelId("lm", 1)
# (package, model id, engine module, fault module)
PACKAGES = {"jax": (JLM, jbatcher, jfaults), "port": (LM, tbatcher, faults)}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    export_artifact("transformer_lm", str(base), name="draft", version=1,
                    config=dict(TINY, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64),
                    seed=5)
    return base


def _runtime(store, pkg, **serving):
    """A runtime with the artifact loaded; ``serving`` sets the port's
    ServingConfig fields."""
    if pkg == "jax":
        rt = TPUModelRuntime(JConfig(platform="cpu"))
        rt.ensure_loaded(JModel(identifier=JLM, path=str(store / "lm" / "1")))
        return rt
    rt = TorchModelRuntime(ServingConfig(**serving), device="cpu")
    rt.ensure_loaded(Model(identifier=LM, path=str(store / "lm" / "1")))
    return rt


def _wait(cond, what, deadline=60.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


# -- priority admission -------------------------------------------------------

def _admission_order(store, pkg):
    """Six rows of mixed classes submitted in ONE batch to a one-lane
    engine: they admit (first token) in (class, submit) order."""
    mid, mod, _ = PACKAGES[pkg]
    rt = _runtime(store, pkg)
    eng = mod.ContinuousGenerateEngine(rt, slots=1, chunk_tokens=2, page_tokens=PT,
                                       arena_pages=32)
    order: list[int] = []
    lock = threading.Lock()
    classes = ["low", "normal", "high", "low", "high", "normal"]
    rng = np.random.default_rng(4)

    def first(i):
        def cb(_t, i=i):
            with lock:
                if i not in order:
                    order.append(i)
        return cb

    reqs = [mod._ContinuousReq(prompt=rng.integers(1, 97, 6 + i).astype(np.int32), max_new=4,
                               temperature=0.0, top_k=0, priority=c,
                               rank=tbatcher.PRIORITY_RANKS[c], seq=i, on_token=first(i))
            for i, c in enumerate(classes)]
    try:
        eng._sched(mid).submit(reqs)
        for r in reqs:
            assert r.done.wait(60) and r.error is None
        return order, [list(r.tokens) for r in reqs]
    finally:
        eng.close()
        rt.close()


def test_priority_admission_order_matches_the_jax_engine(store):
    want_order, want_tokens = _admission_order(store, "jax")
    got_order, got_tokens = _admission_order(store, "port")
    assert got_order == want_order == [2, 4, 1, 5, 0, 3]  # high, normal, low; FIFO inside
    assert got_tokens == want_tokens


def test_priority_jumps_the_queue_behind_a_busy_lane(store):
    """Public path: with the one lane busy, a high row submitted after a
    normal one is admitted first (reference test_priority_admission_jumps_fifo);
    an unknown class is refused."""
    rt = _runtime(store, "port")
    eng = tbatcher.ContinuousGenerateEngine(rt, slots=1, chunk_tokens=1)
    first_tok_at: dict[str, float] = {}
    lock = threading.Lock()

    def run(tag, prompt, priority, max_new=4):
        def on_tok(_t):
            with lock:
                first_tok_at.setdefault(tag, time.monotonic())
        eng.generate(LM, np.asarray(prompt, np.int32)[None], max_new_tokens=max_new,
                     priority=priority, on_token=on_tok)

    try:
        with pytest.raises(ValueError, match="unknown priority"):
            eng.generate(LM, np.ones((1, 3), np.int32), priority="urgent")
        # freeze the scheduler for a beat after the blocker admits, so both
        # queued rows are pending before any retirement decides admission
        faults.arm([faults.FaultSpec(kind="freeze_scheduler", after=2, count=1, duration_s=2.0)])
        blocker = threading.Thread(target=run, args=("blocker", [1, 2, 3], "normal", 24))
        blocker.start()
        _wait(lambda: eng.admitted >= 1, "the blocker")
        sched = eng._scheds[LM]
        t_normal = threading.Thread(target=run, args=("normal", [4, 5, 6], "normal"))
        t_normal.start()
        _wait(lambda: len(sched.pending) >= 1, "the normal row")
        t_high = threading.Thread(target=run, args=("high", [7, 8, 9], "high"))
        t_high.start()
        _wait(lambda: len(sched.pending) >= 2, "the high row")
        assert eng.admitted == 1, "the blocker retired before both rows queued"
        for t in (blocker, t_normal, t_high):
            t.join(timeout=60)
            assert not t.is_alive()
        assert first_tok_at["high"] < first_tok_at["normal"]
        assert faults.snapshot()[0]["fired"] == 1
    finally:
        faults.disarm()
        eng.close()
        rt.close()


# -- preemption ---------------------------------------------------------------

def _preempt_run(store, pkg):
    """Three rows (normal, low, low) admitted at one boundary fill a 12-page
    arena; when the newest low row has emitted 4 tokens, a high row arrives
    (submitted from that token's callback, so both engines see it at the
    same boundary) with a lane free but no page: it parks the newest low
    row, which resumes after it. -> (tokens a row, preemptions a row,
    prefill tokens a row, the uncontended tokens)."""
    mid, mod, _ = PACKAGES[pkg]
    rt = _runtime(store, pkg)
    knobs = dict(slots=4, chunk_tokens=1, page_tokens=PT, arena_pages=12)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 97, 16).astype(np.int32) for _ in range(4)]
    classes = ["normal", "low", "low", "high"]
    try:
        calm = mod.ContinuousGenerateEngine(rt, **knobs)
        try:
            alone = [calm.generate(mid, p[None], max_new_tokens=16) for p in prompts]
        finally:
            calm.close()
        rt.drop_slot_state(mid)
        eng = mod.ContinuousGenerateEngine(rt, **knobs)
        reqs = [mod._ContinuousReq(prompt=p, max_new=16, temperature=0.0, top_k=0, priority=c,
                                   rank=tbatcher.PRIORITY_RANKS[c], seq=i)
                for i, (p, c) in enumerate(zip(prompts, classes))]

        def arrive(_t):
            if len(reqs[2].tokens) == 4:
                eng._sched(mid).submit([reqs[3]])

        reqs[2].on_token = arrive
        try:
            eng._sched(mid).submit(reqs[:3])
            for r in reqs:
                assert r.done.wait(60) and r.error is None
            if pkg == "port":
                st = rt._slot_states[mid]
                st.check_page_conservation()
                assert sorted(st.free_pages) == list(range(1, 13))
                assert eng.preemptions == 1 and eng.resumes == 1 and eng.park_failures == 0
        finally:
            eng.close()
        return ([np.asarray(r.tokens) for r in reqs], [r.preemptions for r in reqs],
                [r.prefill_tokens for r in reqs], [a[0] for a in alone])
    finally:
        rt.close()


def test_preemption_victims_and_tokens_match_the_jax_engine(store):
    want = _preempt_run(store, "jax")
    got = _preempt_run(store, "port")
    assert got[1] == want[1] == [0, 0, 1, 0]  # the newest low lane is the victim
    # the victim resumes from its park: 16 cold tokens + the one row the
    # park could not cover (its last emitted token)
    assert got[2] == want[2] == [16, 16, 17, 16]
    for g, w, a in zip(got[0], want[0], got[3]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, a)


def test_preempt_limit_bounds_how_often_a_row_is_parked(store):
    """A low row that fills the arena is parked by two high arrivals; the
    third high waits for it to finish (preempt_limit 2)."""
    rt = _runtime(store, "port")
    knobs = dict(slots=2, chunk_tokens=1, page_tokens=PT, arena_pages=8)
    low_prompt = np.arange(1, 9, dtype=np.int32)
    try:
        calm = tbatcher.ContinuousGenerateEngine(rt, **knobs)
        try:
            want = calm.generate(LM, low_prompt[None], max_new_tokens=56)
        finally:
            calm.close()
        rt.drop_slot_state(LM)
        eng = tbatcher.ContinuousGenerateEngine(rt, **knobs)
        low_toks: list[int] = []
        res = {}

        def run_low():
            res["low"] = eng.generate(LM, low_prompt[None], max_new_tokens=56, priority="low",
                                      return_stats=True, on_token=low_toks.append)
            res["low_done"] = time.monotonic()

        highs = []
        try:
            tl = threading.Thread(target=run_low)
            tl.start()
            for k in range(3):
                n = len(low_toks)
                _wait(lambda n=n: len(low_toks) > n, "the low row decoding")
                t0 = time.monotonic()
                out, stats = eng.generate(LM, np.arange(20 + k, 28 + k, dtype=np.int32)[None],
                                          max_new_tokens=8, priority="high", return_stats=True)
                highs.append((t0, time.monotonic(), stats[0]))
            tl.join(timeout=120)
            assert not tl.is_alive()
        finally:
            eng.close()
        out_low, stats_low = res["low"]
        assert stats_low[0]["preemptions"] == eng.preempt_limit == 2
        assert eng.preemptions == 2
        np.testing.assert_array_equal(out_low, want)
        # the third high arrival found the low row out of budget: it waited
        # for the low row to retire before its first token
        assert highs[2][1] >= res["low_done"] - 0.5
        assert highs[2][2]["ttft_s"] > highs[0][2]["ttft_s"]
        rt._slot_states[LM].check_page_conservation()
    finally:
        rt.close()


# -- streaming ----------------------------------------------------------------

def _node(store, tmp_path, **serving):
    cfg = config_from_dict({
        "serving": serving,
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    })
    node = build_node(cfg, device="cpu")
    return node, f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/lm/versions/1:generate"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _sse(raw: bytes) -> list[dict]:
    return [json.loads(line[len(b"data: "):]) for line in raw.split(b"\n")
            if line.startswith(b"data: ")]


def _check_stream(url, body, want_rows):
    status, headers, raw = _post(url + "?stream=true", body)
    assert status == 200, raw
    assert headers["Content-Type"] == "text/event-stream"
    assert headers["Cache-Control"] == "no-cache" and headers["Transfer-Encoding"] == "chunked"
    assert raw.endswith(b"\n\n")
    events = _sse(raw)
    toks = [e["token"] for e in events[:-1]]
    assert all(set(e) == {"token"} for e in events[:-1])
    assert events[-1] == {"done": True, "tokens": want_rows}
    assert toks == want_rows[0][:len(toks)] and len(toks) >= 1
    return toks


def test_rest_sse_stream_parity_greedy_seeded_and_draft(store, tmp_path):
    """``?stream=true`` over real HTTP on a continuous paged node: a token
    frame a token, then the done frame equal to the buffered body; the
    seeded (solo) and "draft_model" paths replay the finished row the same
    way; the engine's path streams while it decodes."""
    node, url = _node(store, tmp_path, generate_engine="continuous", generate_slots=4,
                      generate_chunk_tokens=2, kv_page_tokens=PT)
    try:
        cases = (
            {"input_ids": [list(range(1, 21))], "max_new_tokens": 10},
            {"input_ids": [[3, 1, 4, 1, 5, 9, 2, 6]], "max_new_tokens": 8, "temperature": 0.8,
             "seed": 7},
            {"input_ids": [list(range(5, 17))], "max_new_tokens": 9, "draft_model": "draft",
             "spec_tokens": 2},
        )
        for body in cases:
            status, _h, raw = _post(url, body)
            assert status == 200, raw
            want = json.loads(raw)["tokens"]
            toks = _check_stream(url, body, want)
            assert toks == want[0]  # no EOS in TINY: every token streams
        assert node.engine.admitted == 2  # the two greedy requests, buffered and streamed
        node.runtime._slot_states[LM].check_page_conservation()
        # a client that streams and then reads everything leaves the server healthy
        assert _post(url, cases[0])[0] == 200
    finally:
        node.close()


def test_rest_stream_validation(store, tmp_path):
    """A bad priority and a 2-row stream answer 400 before any 200; a
    malformed max_new_tokens inside a stream ends it with an error frame."""
    node, url = _node(store, tmp_path, generate_engine="continuous", generate_slots=2,
                      kv_page_tokens=PT)
    try:
        status, _h, raw = _post(url + "?stream=true", {"input_ids": [[1, 2, 3]],
                                                        "priority": "urgent"})
        assert status == 400 and "priority" in json.loads(raw)["error"]
        status, _h, raw = _post(url + "?stream=1", {"input_ids": [[1, 2], [3, 4]],
                                                     "max_new_tokens": 4})
        assert status == 400 and "single-row" in json.loads(raw)["error"]
        status, _h, raw = _post(url + "?stream=true", {"input_ids": [[1, 2]],
                                                        "max_new_tokens": "abc"})
        assert status == 200 and len(_sse(raw)) == 1 and "error" in _sse(raw)[0]
        # every class is served, streamed or not
        for pr in ("high", "normal", "low"):
            status, _h, raw = _post(url, {"input_ids": [[1, 2, 3]], "max_new_tokens": 3,
                                          "priority": pr, "conversation_id": "c"})
            assert status == 200, raw
    finally:
        node.close()


def test_a_dead_client_callback_is_dropped_and_the_row_finishes(store):
    rt = _runtime(store, "port")
    eng = tbatcher.ContinuousGenerateEngine(rt, slots=2, chunk_tokens=2, page_tokens=PT)
    calls = []

    def broken(t):
        calls.append(t)
        raise ConnectionResetError("client gone")

    try:
        prompt = np.arange(1, 9, dtype=np.int32)[None]
        out = eng.generate(LM, prompt, max_new_tokens=7, on_token=broken)
        np.testing.assert_array_equal(out, eng.generate(LM, prompt, max_new_tokens=7))
        assert len(calls) == 1
    finally:
        eng.close()
        rt.close()


# -- crash recovery -----------------------------------------------------------

def _killed(store, pkg, spec, rows=1, **knobs):
    """Greedy rows under one FaultSpec (streamed through on_token for one
    row) against the same rows unkilled. -> (killed, unkilled, streamed,
    the engine)."""
    mid, mod, lab = PACKAGES[pkg]
    rt = _runtime(store, pkg)
    ids = np.random.default_rng(9).integers(1, 97, (rows, 10)).astype(np.int32)
    try:
        ref = mod.ContinuousGenerateEngine(rt, **knobs)
        try:
            want = ref.generate(mid, ids, max_new_tokens=12)
        finally:
            ref.close()
        rt.drop_slot_state(mid)
        eng = mod.ContinuousGenerateEngine(rt, **knobs)
        streamed: list[int] = []
        lab.arm([lab.FaultSpec(**spec)])
        try:
            out = eng.generate(mid, ids, max_new_tokens=12,
                               on_token=streamed.append if rows == 1 else None)
        finally:
            lab.disarm()
            eng.close()
        if pkg == "port" and mid in rt._slot_states:
            rt._slot_states[mid].check_page_conservation()
        return out, want, streamed, eng
    finally:
        rt.close()


@pytest.mark.parametrize("arena", ["dense", "paged"])
def test_mid_stream_kill_engine_is_token_exact_like_the_jax_engine(store, arena):
    """kill_engine mid decode: recovery re-prefills prompt + emitted tokens
    on a fresh scheduler; the stream the callback saw continues with no
    token dropped, repeated or changed, and equals the JAX engine's under
    the same FaultSpec."""
    knobs = dict(slots=2, chunk_tokens=1)
    if arena == "paged":
        knobs.update(page_tokens=PT, arena_pages=16)
    spec = {"kind": "kill_engine", "after": 6, "count": 1}
    j_out, _, j_streamed, _ = _killed(store, "jax", spec, **knobs)
    out, want, streamed, eng = _killed(store, "port", spec, **knobs)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, j_out)
    assert streamed == want[0].tolist() == j_streamed
    assert eng.recovered == 1


def test_kill_recovers_in_flight_and_queued_rows_and_a_prefilling_lane(store):
    """One lane, three rows, chunked prefill of 8: the kill lands with one
    row in flight (mid chunked prefill: it restarts from chunk 0) and two
    queued; all three are requeued and finish with the unkilled tokens, as
    the JAX engine's do."""
    knobs = dict(slots=1, chunk_tokens=2, page_tokens=PT, arena_pages=16,
                 prefill_chunk_tokens=8)
    spec = {"kind": "kill_engine", "after": 1, "count": 1}
    j_out, _, _, _ = _killed(store, "jax", spec, rows=3, **knobs)
    out, want, _, eng = _killed(store, "port", spec, rows=3, **knobs)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, j_out)
    assert eng.recovered == 3 and eng.prefill_chunks >= 3


def test_recoveries_exhaust_and_recovery_off_fails_the_rows(store):
    """A kill at every step: each row survives max_recoveries crashes and
    fails on the next; with recovery off the first crash fails every row."""
    for recovery, recovered in ((True, 2 * 2), (False, 0)):
        rt = _runtime(store, "port", generate_recovery=recovery)
        eng = tbatcher.ContinuousGenerateEngine(rt, slots=2, chunk_tokens=2, page_tokens=PT)
        assert eng.max_recoveries == 2
        faults.arm([faults.FaultSpec(kind="kill_engine", count=0)])
        try:
            with pytest.raises(faults.InjectedFault):
                eng.generate(LM, np.ones((2, 5), np.int32), max_new_tokens=4)
            assert eng.recovered == recovered
            assert faults.snapshot()[0]["fired"] == (3 if recovery else 1)
        finally:
            faults.disarm()
            eng.close()
            rt.close()


@pytest.mark.parametrize("kind", ["stall_store", "corrupt_peer_chunk", "drop_peer", "bogus"])
def test_a_fault_kind_without_a_hooked_site_is_refused(kind):
    """The port hooks the scheduler's step (kill_engine, freeze_scheduler),
    fleet status ingestion (drop_peer, cluster/status.py), the manager's
    provider miss (stall_store) and the peer-transfer receiver
    (corrupt_peer_chunk): each arms at the reference's site. A spec of any
    other kind is refused instead of arming a fault that never fires."""
    if kind != "bogus":
        assert jfaults.FaultSpec(kind=kind).site  # a reference kind with its own site
    if kind in faults.SITE_OF:
        assert faults.FaultSpec(kind=kind).site == jfaults.FaultSpec(kind=kind).site
    else:
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultSpec(kind=kind)
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.arm_json(json.dumps([{"kind": kind}]))
    assert not faults.armed()
    assert {faults.FaultSpec(kind=k).site for k in ("kill_engine", "freeze_scheduler")} == {
        "engine_step"}
    assert set(faults.SITE_OF) == {"kill_engine", "freeze_scheduler", "drop_peer",
                                   "stall_store", "corrupt_peer_chunk"}
