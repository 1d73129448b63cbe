"""The port's scenario lab (``lab/workload.py``, ``lab/scenario.py``) and the
fault injector's tallies (``lab/faults.py``, ``utils/metrics.py``,
``utils/flight_recorder.py``, ``observability.lab_faults``) against the JAX
package, on the CPU (mirrors tests/test_scenario_lab.py).

- ``compile_schedule``: the reference's schedule field for field, for every
  arrival process, several seeds, multi-turn specs and a leftover budget;
  ``WorkloadSpec``'s refusals the reference's;
- ``default_scenarios``, ``default_faults`` and ``SCORECARD_FIELDS`` the
  reference's; a stub cell's row the reference's, key for key;
- a firing tallies three ways, as the reference's does: the
  ``tpusc_fault_injected{kind}`` counter, ``RECORDER.fault_counts()`` and one
  ``fault_injected:<kind>`` flight dump; ``observability.lab_faults`` (and
  its env override) arms a node, a malformed spec refuses to start;
- a mini matrix (4 scenarios x 5 fault columns, two tenants) on the port's
  continuous paged engine behind a cache manager, as ``chip_smoke.py``'s
  ``lab`` phase runs it on the card: nothing lost, recoveries in the kill
  cells, every fault fired, the census green. On the CPU the paged engine
  runs B1's plain version.
- the no-fault cells' greedy tokens identical to the JAX engine's on the
  same artifact and schedule.

Config: the reference test's TINY in f32, so that greedy tokens must be
identical between the packages. No test asserts a time.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
from torch_obs_globals import confined_globals

from tfservingcache_tpu.config import ServingConfig as JConfig
from tfservingcache_tpu.lab import faults as jfaults
from tfservingcache_tpu.lab import scenario as jscenario
from tfservingcache_tpu.lab import workload as jworkload
from tfservingcache_tpu.models.registry import export_artifact
from tfservingcache_tpu.runtime.batcher import ContinuousGenerateEngine as JEngine
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import Model as JModel
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu.utils.flight_recorder import RECORDER as JRECORDER
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider
from tfservingcache_tpu_torch.cluster.status import FleetView, NodeStatus
from tfservingcache_tpu_torch.config import ServingConfig, config_from_dict, load_config
from tfservingcache_tpu_torch.lab import faults
from tfservingcache_tpu_torch.lab import scenario
from tfservingcache_tpu_torch.lab import workload
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import ModelId
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER
from tfservingcache_tpu_torch.utils.metrics import Metrics

TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
TENANTS = ("tenant0", "tenant1")
# the lab phase's engine settings at the small size: pages of 8 tokens
ENGINE = dict(slots=3, chunk_tokens=2, page_tokens=8, arena_pages=64)
SEED = 5


@pytest.fixture(autouse=True)
def _disarmed():
    """No test of this file may leave either injector armed."""
    yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    for i, name in enumerate(TENANTS):
        export_artifact("transformer_lm", str(base), name=name, version=1, config=TINY,
                        seed=i)
    return base


def _fields(rows) -> list[tuple]:
    return [dataclasses.astuple(r) + (r.index,) for r in rows]


# -- workload DSL ---------------------------------------------------------------

SPECS = [
    dict(name="poisson", tenants=("a", "b", "c"), zipf_s=1.3, requests=20),
    dict(name="burst", arrival="burst", requests=25, burst_size=4, burst_gap_s=0.5,
         turns=3, prompt_lens=(4, 9), prompt_mix=(3.0, 1.0)),
    dict(name="flash", arrival="flash_crowd", tenants=("a", "b"), zipf_s=0.8,
         requests=11, rate_rps=4.0, flash_at_s=1.0, flash_width_s=0.1, flash_share=0.5,
         turns=2, turn_suffix_tokens=3),
    dict(name="turns", requests=10, turns=4, turn_gap_s=0.15, prompt_lens=(8,),
         turn_suffix_tokens=8, temperature=0.7, max_new=5),
    dict(name="one", requests=1, turns=3),
]


@pytest.mark.parametrize("seed", [0, 7, 11, 123])
@pytest.mark.parametrize("spec", SPECS, ids=[s["name"] for s in SPECS])
def test_compile_schedule_is_the_references(spec, seed):
    """Arrival offsets, tenants, prompts, budgets, conv, turn and index, for
    every arrival process, multi-turn specs and a leftover budget (25
    requests in turns of 3, 11 in turns of 2, 10 in turns of 4)."""
    for vocab in (97, 32000):
        got = workload.compile_schedule(workload.WorkloadSpec(**spec), seed, vocab=vocab)
        want = jworkload.compile_schedule(jworkload.WorkloadSpec(**spec), seed, vocab=vocab)
        assert _fields(got) == _fields(want)
        assert len(got) == spec["requests"]


def test_schedules_replay_and_extend_their_turns():
    spec = workload.WorkloadSpec(name="mt", requests=9, turns=4, turn_suffix_tokens=5,
                                 prompt_lens=(6,))
    sched = workload.compile_schedule(spec, seed=3)
    assert sched == workload.compile_schedule(spec, seed=3)
    assert sched != workload.compile_schedule(spec, seed=4)
    convs: dict[int, list] = {}
    for r in sched:
        convs.setdefault(r.conv, []).append(r)
    assert sorted(len(v) for v in convs.values()) == [1, 4, 4]  # the leftover is its own
    for rows in convs.values():
        rows.sort(key=lambda r: r.turn)
        for prev, cur in zip(rows, rows[1:]):
            assert cur.prompt[:len(prev.prompt)] == prev.prompt
            assert len(cur.prompt) == len(prev.prompt) + 5 and cur.at_s > prev.at_s


@pytest.mark.parametrize("bad", [
    dict(arrival="thundering_herd"), dict(tenants=()),
    dict(prompt_lens=(4, 8), prompt_mix=(1.0,)), dict(requests=0), dict(turns=0),
])
def test_workload_spec_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as want:
        jworkload.WorkloadSpec(name="x", **bad)
    with pytest.raises(ValueError) as got:
        workload.WorkloadSpec(name="x", **bad)
    assert str(got.value) == str(want.value)


# -- the matrix and the scorecard -------------------------------------------------

@pytest.mark.parametrize("tenants, requests, max_new", [
    (("lm",), 16, 10), (TENANTS, 12, 8), (("a", "b", "c"), 7, 3)])
def test_default_scenarios_are_the_references(tenants, requests, max_new):
    got = scenario.default_scenarios(tenants, requests=requests, max_new=max_new)
    want = jscenario.default_scenarios(tenants, requests=requests, max_new=max_new)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]


@pytest.mark.parametrize("duration_s", [0.4, 0.05])
def test_default_faults_are_the_references(duration_s):
    def cols(specs):
        return [None if f is None else dataclasses.asdict(f) for f in specs]

    assert cols(scenario.default_faults(duration_s)) == cols(jscenario.default_faults(duration_s))
    assert faults.KINDS == jfaults.KINDS and faults.SITE_OF == jfaults.SITE_OF


def _stub_gen(sr):
    if sr.index == 1:
        raise RuntimeError("boom")
    if sr.index == 2:
        return {"ok": False, "ttft_s": None, "tokens": 0, "error": "x"}
    return {"ok": True, "ttft_s": 0.01 * (sr.index + 1), "tokens": 4, "error": None}


def test_a_stub_cells_row_is_the_references_key_for_key():
    """The schema in order, the lost requests counted from error returns and
    raises, the percentile rule; the timing fields (tok_s, wall_s) are the
    only ones that may differ, and the platform is "cpu" in both."""
    assert scenario.SCORECARD_FIELDS == jscenario.SCORECARD_FIELDS
    spec = dict(name="stub", requests=6, rate_rps=200.0, max_new=4)
    got = scenario.run_cell(workload.compile_schedule(workload.WorkloadSpec(**spec), 2), _stub_gen,
                            scenario_name="stub", census_fn=lambda: True)
    want = jscenario.run_cell(jworkload.compile_schedule(jworkload.WorkloadSpec(**spec), 2),
                              _stub_gen, scenario_name="stub", census_fn=lambda: True)
    assert list(got) == list(want) == list(scenario.SCORECARD_FIELDS) + ["errors"]
    timed = {"tok_s", "wall_s", "goodput"}
    assert {k: v for k, v in got.items() if k not in timed} == {
        k: v for k, v in want.items() if k not in timed}
    assert (got["completed"], got["lost"], got["tokens_out"]) == (4, 2, 16)
    assert got["platform"] == "cpu" and got["errors"] == ["RuntimeError('boom')", "x"]


def test_run_cell_arms_a_fresh_spec_copy_each_cell():
    """The caller's FaultSpec keeps its tallies at 0, so the same spec fires
    in every cell of a matrix; the counter and the recorder count each
    cell's firings."""
    sched = workload.compile_schedule(workload.WorkloadSpec(name="s", requests=2,
                                                            rate_rps=500.0), seed=1)
    fault = faults.FaultSpec(kind="drop_peer", count=0)
    metrics = Metrics()

    def gen(sr):
        assert faults.fire("status_ingest", peer="p", payload=sr) is None
        return {"ok": True, "ttft_s": 0.001, "tokens": 1, "error": None}

    with confined_globals():
        one = scenario.run_cell(sched, gen, scenario_name="a", fault=fault)
        two = scenario.run_cell(sched, gen, scenario_name="b", fault=fault, metrics=metrics)
    assert one["fault_injections"] == two["fault_injections"] == 2
    assert fault.visits == 0 and fault.fired == 0
    assert metrics.registry.family_total("tpusc_fault_injected") == 2
    assert not faults.armed()


# -- the fault injector's tallies ---------------------------------------------------

def _drill(mod, metrics, recorder, flight_dir):
    """The reference test's drill: drop_peer armed, fired five times, into
    its own flight dir. -> (counter, recorder tally delta, dump reasons)."""
    recorder.configure(flight_dir=str(flight_dir), dump_cooldown_s=60.0)
    base = recorder.fault_counts().get("drop_peer", 0)
    mod.arm([mod.FaultSpec(kind="drop_peer", count=0)], metrics=metrics)
    try:
        for i in range(5):
            assert mod.fire("status_ingest", peer="p", payload=i) is None
        assert mod.fire("status_ingest", peer="p", payload=None) is None
    finally:
        mod.disarm()
        recorder.configure(flight_dir="")
    if mod is jfaults:
        counter = metrics.registry.get_sample_value("tpusc_fault_injected_total",
                                                    {"kind": "drop_peer"})
    else:
        counter = metrics.fault_injected.labels("drop_peer").value
    docs = [json.loads(p.read_text()) for p in sorted(flight_dir.iterdir())]
    return counter, recorder.fault_counts()["drop_peer"] - base, docs


def test_a_firing_counts_tallies_and_dumps_like_the_reference(tmp_path):
    with confined_globals():
        got = _drill(faults, Metrics(), RECORDER, tmp_path / "port")
        want = _drill(jfaults, JMetrics(), JRECORDER, tmp_path / "jax")
    assert got[:2] == want[:2] == (6, 6)
    assert len(got[2]) == len(want[2]) == 1  # one dump within the cooldown
    for key in ("reason", "model", "context"):
        assert got[2][0][key] == want[2][0][key]
    assert got[2][0]["reason"] == "fault_injected:drop_peer"
    assert got[2][0]["context"] == {"site": "status_ingest", "peer": "p"}


def test_the_counter_family_is_the_references():
    port = Metrics().registry.render().decode()
    assert ("# HELP tpusc_fault_injected_total Scenario-lab fault injections fired "
            "(kind=kill_engine|freeze_scheduler|stall_store|corrupt_peer_chunk|drop_peer)"
            in port)
    assert "# TYPE tpusc_fault_injected_total counter" in port
    ref = JMetrics()
    assert ref.fault_injected._labelnames == ("kind",)
    assert Metrics().fault_injected.labelnames == ("kind",)


def test_a_disarmed_hook_records_nothing():
    base = RECORDER.fault_counts()
    for site in set(faults.SITE_OF.values()):
        payload = object()
        assert faults.fire(site, model="m", payload=payload) is payload
    assert RECORDER.fault_counts() == base and faults.snapshot() == []


def _node_cfg(tmp_path, lab_faults=None):
    raw = {"cache": {"base_dir": str(tmp_path / "cache")},
           "model_provider": {"base_dir": str(tmp_path / "store")},
           "observability": {"flight_dir": str(tmp_path / "flight")},
           "cache_node": {"rest_port": 0, "grpc_port": 0}}
    if lab_faults is not None:
        raw["observability"]["lab_faults"] = lab_faults
    return config_from_dict(raw)


SPEC_JSON = '[{"kind": "drop_peer", "peer": "node-b", "count": 2}]'


def _assert_node_armed(node):
    assert faults.armed()
    assert faults.snapshot() == [{"kind": "drop_peer", "visits": 0, "fired": 0}]
    assert faults.fire("status_ingest", peer="node-b", payload="s") is None
    assert faults.fire("status_ingest", peer="node-c", payload="s") == "s"
    assert node.metrics.fault_injected.labels("drop_peer").value == 1


def test_observability_lab_faults_arms_the_node(tmp_path):
    assert config_from_dict({}).observability.lab_faults == ""
    node = build_node(_node_cfg(tmp_path, SPEC_JSON), device="cpu")
    try:
        _assert_node_armed(node)
    finally:
        faults.disarm()
        node.close()
    node = build_node(_node_cfg(tmp_path), device="cpu")
    try:
        assert not faults.armed()  # the default arms nothing
    finally:
        node.close()


def test_the_env_override_arms_the_node(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TPUSC_OBSERVABILITY_LAB_FAULTS", SPEC_JSON)
    monkeypatch.setenv("TPUSC_CACHE_NODE_REST_PORT", "0")
    monkeypatch.setenv("TPUSC_CACHE_NODE_GRPC_PORT", "0")
    monkeypatch.setenv("TPUSC_CACHE_BASE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("TPUSC_MODEL_PROVIDER_BASE_DIR", str(tmp_path / "store"))
    monkeypatch.setenv("TPUSC_OBSERVABILITY_FLIGHT_DIR", str(tmp_path / "flight"))
    cfg = load_config()
    assert cfg.observability.lab_faults == SPEC_JSON
    node = build_node(cfg, device="cpu")
    try:
        _assert_node_armed(node)
    finally:
        faults.disarm()
        node.close()


@pytest.mark.parametrize("bad", ['{"kind": "drop_peer"}', '[{"kind": "nope"}]',
                                 "not json", '[{"kind": "drop_peer", "bogus": 1}]'])
def test_a_malformed_spec_refuses_to_start(tmp_path, bad):
    """As the reference's arm_json: the start raises, nothing is armed, and
    no thread is left behind."""
    before = threading.active_count()
    with pytest.raises((ValueError, TypeError)) as got:
        build_node(_node_cfg(tmp_path, bad), device="cpu")
    with pytest.raises((ValueError, TypeError)) as want:
        jfaults.arm_json(bad)
    assert type(got.value) is type(want.value)
    assert not faults.armed() and threading.active_count() <= before


# -- the mini matrix on the port's paged engine -------------------------------------

class _Stack:
    """Two tenants behind a disk provider, a disk cache, a CPU runtime and a
    cache manager, with one Metrics: chip_smoke.py's lab stack at TINY."""

    def __init__(self, store, tmp_path):
        self.metrics = Metrics()
        self.runtime = TorchModelRuntime(ServingConfig(), device="cpu", metrics=self.metrics)
        self.manager = CacheManager(
            DiskModelProvider(str(store)),
            ModelDiskCache(str(tmp_path / "cache"), capacity_bytes=1 << 30),
            self.runtime, metrics=self.metrics)
        self.mids = {t: ModelId(t, 1) for t in TENANTS}
        for mid in self.mids.values():
            self.manager.ensure_servable(mid)

    def census(self) -> bool:
        try:
            for mid in self.mids.values():
                st = self.runtime._slot_states.get(mid)
                if st is not None:
                    st.check_page_conservation()
            return True
        except AssertionError:
            return False

    def close(self):
        self.manager.close()
        self.runtime.close()


def _cell(stack, spec, fault, tokens):
    """One cell as bench.py's scenario_lab runs it (a fresh engine, warmed
    outside the arming; stall_store evicts the first tenant so the stall
    sits on the real cold miss; drop_peer feeds a FleetView). ``tokens``
    gets each request's greedy tokens by schedule index."""
    sched = workload.compile_schedule(spec, seed=SEED, vocab=TINY["vocab_size"])
    fleet = None
    if fault is not None and fault.kind == "drop_peer":
        fleet = FleetView(stale_after_s=0.5)
        fleet.ingest(NodeStatus(ident="peer-b", seq=1, t_wall=time.time()))
    eng = ContinuousGenerateEngine(stack.runtime, metrics=stack.metrics, **ENGINE)
    try:
        eng.generate(stack.mids[spec.tenants[0]], np.ones((1, 8), np.int32), max_new_tokens=2)
        if fault is not None and fault.kind == "stall_store":
            stack.manager.disk_cache.remove(stack.mids[spec.tenants[0]])
            stack.manager.disk_cache.drain_evictions()

        def gen(sr):
            mid = stack.mids[sr.tenant]
            stack.manager.ensure_servable(mid)
            out, stats = eng.generate(mid, np.asarray(sr.prompt, np.int32)[None],
                                      max_new_tokens=sr.max_new, return_stats=True)
            tokens[sr.index] = out[0].tolist()
            if fleet is not None:
                fleet.ingest(NodeStatus(ident="peer-b", seq=sr.index + 2, t_wall=time.time()))
            return {"ok": True, "ttft_s": stats[0]["ttft_s"], "tokens": stats[0]["tokens"],
                    "error": None}

        row = scenario.run_cell(sched, gen, scenario_name=spec.name, fault=fault,
                                metrics=stack.metrics, census_fn=stack.census)
        if fleet is not None:
            row["peer_health_after"] = round(fleet.health("peer-b"), 3)
        return row
    finally:
        eng.close()
        for mid in stack.mids.values():
            stack.runtime.drop_slot_state(mid)


SCENARIOS = scenario.default_scenarios(TENANTS, requests=8, max_new=6)


@pytest.mark.parametrize("spec", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_mini_matrix_on_the_paged_engine(store, tmp_path, spec):
    """One scenario x the five fault columns: every request completes, the
    kill cell recovers, every fault fires, the census stays green, and the
    greedy tokens of every faulted cell are the no-fault cell's."""
    stack = _Stack(store, tmp_path)
    rows, tokens = [], []
    try:
        with confined_globals():
            for fault in scenario.default_faults(duration_s=0.2):
                tokens.append({})
                rows.append(_cell(stack, spec, fault, tokens[-1]))
    finally:
        stack.close()
    for row in rows:
        assert list(row)[:len(scenario.SCORECARD_FIELDS)] == list(scenario.SCORECARD_FIELDS)
        assert row["lost"] == 0 and row["completed"] == spec.requests, row
        assert row["conservation_ok"] is True and row["platform"] == "cpu", row
        assert row["tokens_out"] == spec.requests * spec.max_new
        assert row["fault_injections"] == (0 if row["fault"] == "none" else
                                           spec.requests if row["fault"] == "drop_peer" else 1)
        assert row["kernel_active"] is False
    by_fault = {r["fault"]: r for r in rows}
    assert by_fault["kill_engine"]["recovered"] > 0
    assert by_fault["none"]["recovered"] == 0
    assert by_fault["stall_store"]["cold_miss_rate"] > 0
    assert 0.0 <= by_fault["drop_peer"]["peer_health_after"] <= 1.0
    for got in tokens[1:]:
        assert got == tokens[0]


@pytest.mark.parametrize("spec", SCENARIOS, ids=[s.name for s in SCENARIOS])
def test_the_no_fault_cell_is_the_jax_engines_token_for_token(store, tmp_path, spec):
    """The same artifact and schedule through both packages' engines, open
    loop: every request's greedy tokens identical."""
    sched = workload.compile_schedule(spec, seed=SEED, vocab=TINY["vocab_size"])
    got, want = {}, {}
    stack = _Stack(store, tmp_path)
    try:
        with confined_globals():
            _cell(stack, spec, None, got)
    finally:
        stack.close()
    rt = TPUModelRuntime(JConfig(platform="cpu"))
    mids = {t: JModelId(t, 1) for t in TENANTS}
    for t, mid in mids.items():
        rt.ensure_loaded(JModel(identifier=mid, path=str(store / t / "1")))
    eng = JEngine(rt, **ENGINE)
    try:
        def gen(sr):
            out = eng.generate(mids[sr.tenant], np.asarray(sr.prompt, np.int32)[None],
                               max_new_tokens=sr.max_new)
            want[sr.index] = np.asarray(out)[0].tolist()
            return {"ok": True, "ttft_s": 0.0, "tokens": sr.max_new, "error": None}

        with confined_globals():
            row = jscenario.run_cell(sched, gen, scenario_name=spec.name)
        assert row["lost"] == 0
    finally:
        eng.close()
        rt.close()
    assert sorted(got) == list(range(spec.requests))
    assert got == want
