"""The port's batchers (runtime/batcher.py ``MicroBatcher`` and
``GenerateCoalescer``) against the JAX package's, each on its own
package's ``FakeRuntime`` and the same event-gated schedule.

A schedule never waits on time: the first request (the blocker) enters
the runtime and blocks there on an event, so every later request of its key
must queue behind the held gate. Each request is marked with what it must
do, enter the runtime (a free gate, or a solo path) or queue, and the next
is submitted only once the batcher's ``tpusc_batcher_queue_depth`` gauge
and the runtime's entry count show it done, so batch membership is decided
by the schedule, not by thread timing. Then the event opens. Per-caller
results, runtime batch sizes, ``batches`` / ``batched_requests``, and the
exposition's batcher families must equal the reference's; for the
coalescer also its flight-recorder rows, phase notes and tenant-ledger
tokens."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from tfservingcache_tpu.models.registry import TensorSpec as JTensorSpec
from tfservingcache_tpu.runtime import batcher as jbatcher
from tfservingcache_tpu.runtime.fake import FakeRuntime as JFakeRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu.utils import accounting as jaccounting
from tfservingcache_tpu.utils import flight_recorder as jflight
from tfservingcache_tpu.utils import metrics as jmetrics
from tfservingcache_tpu_torch.models.registry import TensorSpec
from tfservingcache_tpu_torch.runtime import batcher
from tfservingcache_tpu_torch.runtime.fake import FakeRuntime
from tfservingcache_tpu_torch.types import Model, ModelId
from tfservingcache_tpu_torch.utils import accounting, flight_recorder, metrics

from torch_obs_globals import confined_globals

PKGS = {
    "port": SimpleNamespace(
        MicroBatcher=batcher.MicroBatcher, GenerateCoalescer=batcher.GenerateCoalescer,
        FakeRuntime=FakeRuntime, ModelId=ModelId, Model=Model, TensorSpec=TensorSpec,
        Metrics=metrics.Metrics, RECORDER=flight_recorder.RECORDER, LEDGER=accounting.LEDGER,
        gauge=lambda child: child.value),
    "ref": SimpleNamespace(
        MicroBatcher=jbatcher.MicroBatcher, GenerateCoalescer=jbatcher.GenerateCoalescer,
        FakeRuntime=JFakeRuntime, ModelId=JModelId, Model=JModel, TensorSpec=JTensorSpec,
        Metrics=jmetrics.Metrics, RECORDER=jflight.RECORDER, LEDGER=jaccounting.LEDGER,
        gauge=lambda child: child._value.get()),
}
WAIT_S = 60.0
EOS = 7


@pytest.fixture(autouse=True)
def _clean_globals():
    with confined_globals():
        yield


def _wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"schedule stalled: {what}"
        time.sleep(0.001)


def fake_tokens(ids, lengths, max_new: int, version: int) -> np.ndarray:
    """The stub generate: row r's tokens come from its true prompt, so a
    scatter or length mix-up changes the answer."""
    ids = np.asarray(ids)
    lengths = np.full((ids.shape[0],), ids.shape[1]) if lengths is None else np.asarray(lengths)
    base = np.array([int(ids[r, :lengths[r]].sum()) for r in range(ids.shape[0])])
    return ((base[:, None] * 3 + np.arange(max_new)[None, :] + version) % 50).astype(np.int32)


class Stand:
    """One package's FakeRuntime, metrics and batchers, with the runtime's
    predict and generate gated on ``go`` and every call's rows recorded."""

    def __init__(self, pkg, *, max_batch=64, max_inflight=1, family="transformer_lm",
                 max_seq=64, signature=None, predict=None):
        self.pkg = pkg
        self.rt = rt = pkg.FakeRuntime()
        self.metrics = pkg.Metrics()
        self.go = threading.Event()
        self.entered = 0
        self.sizes = []
        self.seeds = []
        self._lock = threading.Lock()
        orig_predict = predict or rt.predict
        if signature is not None:
            rt.signature = signature

        def gated_predict(model_id, inputs, output_filter=None):
            self._enter(int(np.asarray(next(iter(inputs.values()))).shape[0]))
            return orig_predict(model_id, inputs, output_filter)

        def gated_generate(model_id, input_ids, prompt_lengths=None, max_new_tokens=32,
                           temperature=0.0, top_k=0, seed=0, **_kw):
            if not rt.is_loaded(model_id):
                raise RuntimeError(f"model {model_id} is not loaded")
            self._enter(int(np.asarray(input_ids).shape[0]), seed)
            return fake_tokens(input_ids, prompt_lengths, max_new_tokens, model_id.version)

        rt.predict = gated_predict
        rt.generate = gated_generate
        rt.family_of = lambda _m: family
        rt.max_seq_of = lambda _m: max_seq
        rt.eos_id_of = lambda _m: EOS
        self.mb = pkg.MicroBatcher(rt, max_batch=max_batch, metrics=self.metrics,
                                   max_inflight=max_inflight)
        self.gc = pkg.GenerateCoalescer(rt, max_batch=max_batch, metrics=self.metrics,
                                        max_inflight=max_inflight)

    def _enter(self, rows: int, seed=None) -> None:
        with self._lock:
            self.entered += 1
            self.sizes.append(rows)
            self.seeds.append(seed)
        assert self.go.wait(WAIT_S), "the schedule never opened the runtime"

    def load(self, name="m", version=1):
        mid = self.pkg.ModelId(name, version)
        self.rt.ensure_loaded(self.pkg.Model(identifier=mid, path="/nowhere"))
        return mid

    def queued(self) -> int:
        depth = self.metrics.batcher_queue_depth
        return int(self.pkg.gauge(depth.labels("predict")) + self.pkg.gauge(depth.labels("generate")))

    def run(self, calls, gated=True):
        """Submit ``calls`` ((expect, thunk) pairs, expect "enter" or
        "queue") in order, each once its predecessor did what it was marked
        to do, then open the runtime. Ungated, the runtime is open from the
        start and each call runs to its end before the next. -> per-call
        ("ok", value) or ("err", type name, message)."""
        out = [None] * len(calls)

        def one(i, fn):
            try:
                value = fn()
                out[i] = ("ok", {k: v.tolist() for k, v in value.items()}
                          if isinstance(value, dict) else np.asarray(value).tolist())
            except Exception as e:  # noqa: BLE001 - compared across packages
                out[i] = ("err", type(e).__name__, str(e))

        if not gated:
            self.go.set()
        threads = []
        want = {"enter": 0, "queue": 0}
        try:
            for i, (expect, fn) in enumerate(calls):
                t = threading.Thread(target=one, args=(i, fn), daemon=True)
                t.start()
                threads.append(t)
                if not gated:
                    t.join(WAIT_S)
                    continue
                want[expect] += 1
                _wait_for(lambda: (self.entered, self.queued()) == (want["enter"], want["queue"]),
                          f"call {i} did not {expect}")
        finally:
            self.go.set()
            for t in threads:
                t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
        return out

    def families(self) -> dict:
        """The batcher families of the exposition: {(sample, labels): value}."""
        wanted = ("tpusc_coalesced_batches", "tpusc_coalesced_requests",
                  "tpusc_batcher_queue_depth", "tpusc_gen_wasted_steps",
                  "tpusc_gen_admission_wait_seconds", "tpusc_request_phase_seconds")
        got = {}
        for fam in text_string_to_metric_families(self.metrics.render().decode()):
            if fam.name not in wanted:
                continue
            for s in fam.samples:
                if s.name.endswith("_created") or s.name.endswith("_sum"):
                    continue  # wall-clock stamps and summed durations
                if fam.name.endswith("_seconds") and s.name.endswith("_bucket"):
                    continue  # durations: only the counts are schedule-determined
                got[(s.name, tuple(sorted(s.labels.items())))] = s.value
        return got

    def summary(self, results) -> dict:
        return {"results": results, "sizes": sorted(self.sizes),
                "seed_7_calls": self.seeds.count(7),
                "mb": (self.mb.batches, self.mb.batched_requests),
                "gc": (self.gc.batches, self.gc.batched_requests),
                "families": self.families()}


def both(scenario, **stand_kw):
    """Run ``scenario(stand)`` on each package. -> {pkg: summary}."""
    out = {}
    for name, pkg in PKGS.items():
        stand = Stand(pkg, **stand_kw)
        out[name] = stand.summary(scenario(stand))
    return out


def x(v, rows=1):
    return {"x": np.full((rows,), float(v), np.float32)}


# -- MicroBatcher -------------------------------------------------------------

E, Q = "enter", "queue"


def s_coalesce(st):
    """Arrivals behind a held gate form ONE batch, each caller's rows back."""
    mid = st.load(version=3)
    return st.run([(E, lambda: st.mb.predict(mid, x(0)))] +
                  [(Q, lambda i=i: st.mb.predict(mid, x(i))) for i in range(1, 6)])


def s_scatter_order(st):
    """Ragged row counts scatter back by row range, in arrival order."""
    mid = st.load(version=3)
    return st.run([(E, lambda: st.mb.predict(mid, x(0)))] +
                  [(Q, lambda k=k, r=r: st.mb.predict(mid, x(10 * k + 1, r)))
                   for k, r in enumerate([1, 3, 2])])


def s_hard_cap(st):
    """max_batch 8 is a hard cap: rows 3+3 close when a third 3 arrives (it
    leads a fresh batch), 3+3+2 = 8 flushes at once, and a 9-row request
    runs solo past the gate."""
    mid = st.load()
    rows = [(Q, 3), (Q, 3), (Q, 3), (Q, 3), (E, 9), (Q, 2)]
    return st.run([(E, lambda: st.mb.predict(mid, x(0)))] +
                  [(e, lambda i=i, r=r: st.mb.predict(mid, x(i, r)))
                   for i, (e, r) in enumerate(rows, start=1)])


def s_models_do_not_mix(st):
    """Two models, two keys: their requests never share a batch."""
    a, b = st.load("a", 1), st.load("b", 2)
    return st.run([(E, lambda: st.mb.predict(a, x(5))), (Q, lambda: st.mb.predict(a, x(6))),
                   (E, lambda: st.mb.predict(b, x(5))), (Q, lambda: st.mb.predict(a, x(7))),
                   (Q, lambda: st.mb.predict(b, x(8)))])


def s_shapes_do_not_mix(st):
    """A different non-batch shape or output filter is another key."""
    mid = st.load()
    return st.run([(E, lambda: st.mb.predict(mid, x(0))),
                   (E, lambda: st.mb.predict(mid, {"x": np.ones((1, 2), np.float32)})),
                   (Q, lambda: st.mb.predict(mid, x(1))),
                   (E, lambda: st.mb.predict(mid, x(2), ["y"])),
                   (Q, lambda: st.mb.predict(mid, x(3)))])


MB_SCENARIOS = {"coalesce": s_coalesce, "scatter_order": s_scatter_order,
                "hard_cap": s_hard_cap, "models_do_not_mix": s_models_do_not_mix,
                "shapes_do_not_mix": s_shapes_do_not_mix}


@pytest.mark.parametrize("name", sorted(MB_SCENARIOS))
def test_microbatcher_matches_the_reference(name):
    got = both(MB_SCENARIOS[name], max_batch=8 if name == "hard_cap" else 64)
    assert got["port"] == got["ref"]
    port = got["port"]
    assert all(r[0] == "ok" for r in port["results"]), port["results"]
    assert port["mb"][0] >= 1  # something coalesced
    expected_sizes = {"coalesce": [1, 5], "scatter_order": [1, 6], "hard_cap": [1, 6, 8, 9],
                      "models_do_not_mix": [1, 1, 1, 2], "shapes_do_not_mix": [1, 1, 1, 2]}
    assert port["sizes"] == expected_sizes[name]


def test_microbatcher_results_are_each_callers_own_rows():
    """Spot-check the shared answers: y = x * version (FakeRuntime)."""
    got = both(s_scatter_order)["port"]["results"]
    assert got[0] == ("ok", {"y": [0.0]})
    for k, r in enumerate([1, 3, 2]):
        assert got[k + 1] == ("ok", {"y": [3.0 * (10 * k + 1)] * r})


def _boom(*_a, **_kw):
    raise RuntimeError("device on fire")


def _liar(*_a, **_kw):
    return {"y": np.zeros((1,), np.float32)}  # one row, whatever came in


@pytest.mark.parametrize("predict,error", [(_boom, "RuntimeError"), (_liar, "ValueError")])
def test_a_failed_batch_reaches_every_waiter_like_the_reference(predict, error):
    """A runtime error reaches every caller of the batch; an output whose
    batch axis disagrees with the rows sent is refused for every joiner
    ("refusing to scatter"), never handed out across callers."""
    def scenario(st):
        mid = st.load()
        return st.run([(E, lambda: st.mb.predict(mid, x(0, 2)))] +
                      [(Q, lambda i=i: st.mb.predict(mid, x(i, 2))) for i in (1, 2, 3)])

    got = {}
    for name, pkg in PKGS.items():
        stand = Stand(pkg, predict=predict)
        got[name] = stand.summary(scenario(stand))
    assert got["port"] == got["ref"]
    joined = got["port"]["results"][1:]
    assert all(r[0] == "err" and r[1] == error for r in joined), joined
    if error == "ValueError":
        assert all("refusing to scatter" in r[2] for r in joined)
    assert got["port"]["mb"] == ((0, 0) if error == "RuntimeError" else (1, 3))


@pytest.mark.parametrize("outputs", ["static", "reduced"])
def test_models_without_a_batch_axis_fall_through(outputs):
    """No "batch" axis on the input, or an output reduced over the batch:
    every request runs solo, as in the reference."""
    def signature_of(pkg):
        spec = pkg.TensorSpec
        if outputs == "static":
            return lambda _m: ({"x": spec("float32", (1,))}, {"y": spec("float32", (1,))},
                               "tensorflow/serving/predict")
        return lambda _m: ({"x": spec("float32", ("batch",))}, {"y": spec("float32", ())},
                           "tensorflow/serving/predict")

    got = {}
    for name, pkg in PKGS.items():
        stand = Stand(pkg, signature=signature_of(pkg))
        mid = stand.load(version=2)
        results = stand.run([(E, lambda i=i: stand.mb.predict(mid, x(i))) for i in range(3)],
                            gated=False)
        got[name] = stand.summary(results)
    assert got["port"] == got["ref"]
    assert got["port"]["mb"] == (0, 0) and got["port"]["sizes"] == [1, 1, 1]
    assert got["port"]["results"][2] == ("ok", {"y": [4.0]})


# -- GenerateCoalescer --------------------------------------------------------

def _gen(st, mid, ids, **kw):
    return st.gc.generate(mid, np.asarray(ids, np.int32), **kw)


def g_merge(st):
    """Ragged prompts of one bucket, a 2-row request and mixed max_new
    behind the held gate: one batch; each caller gets its own rows, cut to
    its own max_new."""
    mid = st.load(version=2)
    return st.run([
        (E, lambda: _gen(st, mid, [[1, 2, 3, 4]], max_new_tokens=4)),
        (Q, lambda: _gen(st, mid, [[1, 2, 3, 0]], prompt_lengths=[3], max_new_tokens=4)),
        (Q, lambda: _gen(st, mid, [[4, 5, 6, 7]], max_new_tokens=3)),
        (Q, lambda: _gen(st, mid, [[9, 9, 2], [5, 1, 1]], max_new_tokens=4)),
        (E, lambda: _gen(st, mid, [[8, 8, 8, 8]], max_new_tokens=2)),  # bucket 2: another key
    ])


def g_seeded_runs_solo(st):
    """A seeded request never waits on the held gate: it runs solo with
    its own seed (the blocker's key is held the whole time)."""
    mid = st.load()
    return st.run([
        (E, lambda: _gen(st, mid, [[1, 2, 3]], max_new_tokens=4)),
        (E, lambda: _gen(st, mid, [[1, 2, 3]], max_new_tokens=4, seed=7)),
        (Q, lambda: _gen(st, mid, [[3, 2, 1]], max_new_tokens=4)),
        (Q, lambda: _gen(st, mid, [[2, 2, 2]], max_new_tokens=4)),
    ])


def g_sampling_keys(st):
    """Temperature and top_k are part of the key."""
    mid = st.load()
    return st.run([
        (E, lambda: _gen(st, mid, [[1, 2]], max_new_tokens=2)),
        (E, lambda: _gen(st, mid, [[1, 2]], max_new_tokens=2, temperature=0.5)),
        (Q, lambda: _gen(st, mid, [[2, 1]], max_new_tokens=2)),
        (E, lambda: _gen(st, mid, [[2, 2]], max_new_tokens=2, temperature=0.5, top_k=3)),
        (Q, lambda: _gen(st, mid, [[3, 1]], max_new_tokens=2)),
    ])


GC_SCENARIOS = {"merge": g_merge, "seeded_runs_solo": g_seeded_runs_solo,
                "sampling_keys": g_sampling_keys}


def _recorder_rows(rec) -> list:
    """The recorder's step rows, window aggregates and phase notes without
    their times, in a fixed order (batches released together drain in
    thread order)."""
    snap = rec.snapshot()
    rows = []
    for model, entry in snap["models"].items():
        for step in entry["steps"]:
            rows.append((model, "step", sorted((k, v) for k, v in step.items()
                                               if k not in ("t_wall", "step_ms"))))
        rows.append((model, "window", sorted((k, v) for k, v in entry["window"].items()
                                             if k != "step_ms_sum")))
    for model, notes in snap["phases"].items():
        rows += [(model, n["engine"], sorted(n["phases"])) for n in notes]
    return sorted(rows, key=repr)


def _ledger_tokens(ledger) -> dict:
    return {t: (v["totals"]["tokens_in"], v["totals"]["tokens_out"])
            for t, v in ledger.snapshot()["tenants"].items()}


@pytest.mark.parametrize("name", sorted(GC_SCENARIOS))
def test_generate_coalescer_matches_the_reference(name):
    """Per-caller tokens, batch sizes and counts, the batcher families
    (``tpusc_coalesced_*{generate}``, ``tpusc_gen_wasted_steps{coalesce}``,
    the admission-wait and phase counts), the flight-recorder rows and the
    ledger's tokens equal the reference's on the same schedule."""
    got, obs = {}, {}
    for pkg_name, pkg in PKGS.items():
        pkg.RECORDER.clear()
        pkg.LEDGER.clear()
        stand = Stand(pkg)
        got[pkg_name] = stand.summary(GC_SCENARIOS[name](stand))
        obs[pkg_name] = (_recorder_rows(pkg.RECORDER), _ledger_tokens(pkg.LEDGER))
    assert got["port"] == got["ref"]
    assert obs["port"] == obs["ref"]
    port = got["port"]
    assert all(r[0] == "ok" for r in port["results"]), port["results"]
    assert port["gc"][0] >= 1
    # the seeded request reached the runtime once, with its own seed
    assert port["seed_7_calls"] == (1 if name == "seeded_runs_solo" else 0)
    fams = port["families"]
    assert fams[("tpusc_coalesced_requests_total", (("kind", "generate"),))] == port["gc"][1]


def test_coalesced_tokens_are_each_callers_solo_answer():
    port = both(g_merge)["port"]
    assert port["gc"] == (1, 3) and port["sizes"] == [1, 1, 4]
    want = [fake_tokens([[1, 2, 3, 4]], None, 4, 2), fake_tokens([[1, 2, 3, 0]], [3], 4, 2),
            fake_tokens([[4, 5, 6, 7]], None, 3, 2), fake_tokens([[9, 9, 2], [5, 1, 1]], None, 4, 2),
            fake_tokens([[8, 8, 8, 8]], None, 2, 2)]
    assert [r[1] for r in port["results"]] == [w.tolist() for w in want]


@pytest.mark.parametrize("case", ["oversized", "moe_lm", "bad_lengths"])
def test_coalescer_refusals_match_the_reference(case):
    """An oversized prompt raises ValueError at submit; a moe_lm model and
    malformed prompt_lengths run solo (the runtime answers on its own)."""
    got = {}
    for name, pkg in PKGS.items():
        stand = Stand(pkg, family="moe_lm" if case == "moe_lm" else "transformer_lm", max_seq=8)
        mid = stand.load()
        if case == "oversized":
            calls = [(E, lambda: _gen(stand, mid, [[1] * 6], max_new_tokens=4))]
        elif case == "moe_lm":
            calls = [(E, lambda i=i: _gen(stand, mid, [[1, i]], max_new_tokens=2))
                     for i in range(3)]
        else:
            calls = [(E, lambda: _gen(stand, mid, [[1, 2, 3]], prompt_lengths=[5],
                                      max_new_tokens=2)),
                     (E, lambda: _gen(stand, mid, [[1, 2]], prompt_lengths=[1, 1],
                                      max_new_tokens=2))]
        got[name] = stand.summary(stand.run(calls, gated=False))
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port["gc"] == (0, 0)
    if case == "oversized":
        assert port["results"][0][:2] == ("err", "ValueError") and port["sizes"] == []
        assert "exceeds max_seq 8" in port["results"][0][2]
    else:
        assert len(port["sizes"]) == len(port["results"])  # every call ran solo
