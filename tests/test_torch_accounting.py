"""The port's tenant ledger (tfservingcache_tpu_torch/utils/accounting.py)
against the JAX package's: the same ``note_step`` / ``gauge_set`` /
``gauge_sync`` / ``note_arena`` / ``note_load`` sequence on one fake clock
gives the same ``snapshot`` and ``summary``; ``publish`` writes the same
``tpusc_tenant_*`` samples into each package's ``Metrics``; and the
noisy-neighbour detector writes its dump into the test's own directory."""

import json
import os

import pytest
from prometheus_client.parser import text_string_to_metric_families

from tfservingcache_tpu.utils import accounting as jaccounting
from tfservingcache_tpu.utils import flight_recorder as jflight
from tfservingcache_tpu.utils import metrics as jmetrics
from tfservingcache_tpu_torch.utils import accounting, flight_recorder, metrics

from torch_obs_globals import confined_globals

PACKAGES = {"jax": jaccounting, "port": accounting}


@pytest.fixture(autouse=True)
def _clean_globals():
    with confined_globals():
        yield


class FakeClock:
    def __init__(self):
        self.t = 500.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


@pytest.fixture()
def clocks(monkeypatch):
    out = {}
    for name, mod in PACKAGES.items():
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", clock)
        out[name] = clock
    return out


def _drive(ledger, clock) -> None:
    """Three tenants through every write the port makes."""
    ledger.gauge_sync("hbm_bytes", {"a@1": 1000.0, "b@1": 250.0}, owner="hbm:1")
    ledger.gauge_sync("disk_bytes", {"a@1": 4000.0}, owner="disk:1")
    for i in range(30):
        clock.t += 0.05
        tenant = ("a@1", "b@1", "c@2")[i % 3]
        ledger.note_step(tenant, "continuous", prefill_s=0.001 * (i % 4),
                         decode_s=0.002 * (i % 5), tokens_in=7 * (i % 2),
                         tokens_out=3 + i % 4, queue_depth=i % 2)
        ledger.gauge_set(tenant, "kv_pages", float(i % 6))
        ledger.note_arena(i % 9)
    ledger.note_load("a@1", "store", 1.25)
    ledger.note_load("a@1", "hbm", 0.0001)
    ledger.note_load("c@2", "disk", 0.5)
    clock.t += 1.0
    # b evicted from the device: the owner-scoped sync zeroes it
    ledger.gauge_sync("hbm_bytes", {"a@1": 1000.0}, owner="hbm:1")
    ledger.gauge_sync("hbm_bytes", {"x@9": 5.0}, owner="hbm:other")
    clock.t += 2.0


@pytest.mark.parametrize("kwargs", [
    {}, {"top": 2}, {"top": 1, "dim": "tokens_out"}, {"dim": "kv_page_seconds"},
    {"model": "b@1"}, {"model": "nope@1"}, {"reset": True},
])
def test_snapshot_matches_the_reference(clocks, kwargs):
    snaps = {}
    for name, mod in PACKAGES.items():
        ledger = mod.TenantLedger()
        _drive(ledger, clocks[name])
        snaps[name] = (ledger.snapshot(**kwargs), ledger.snapshot(), ledger.summary(),
                       ledger.summary(max_tenants=1), ledger.arena_page_seconds())
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"][0]["dimensions"] == list(jaccounting.DIMENSIONS)


def test_disabled_ledger_records_nothing(clocks):
    for name, mod in PACKAGES.items():
        ledger = mod.TenantLedger(enabled=False)
        _drive(ledger, clocks[name])
        assert ledger.snapshot()["tenants"] == {}


def _samples(text: bytes) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text.decode()):
        if fam.name.startswith("tpusc_tenant_") and not fam.name.endswith("_created"):
            for s in fam.samples:
                if not s.name.endswith("_created"):
                    out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


@pytest.mark.parametrize("model_labels", [False, True])
def test_publish_writes_the_reference_tenant_samples(clocks, model_labels):
    got = {}
    for name, mod, mmod in (("jax", jaccounting, jmetrics), ("port", accounting, metrics)):
        ledger = mod.TenantLedger()
        m = mmod.Metrics(model_labels=model_labels)
        _drive(ledger, clocks[name])
        ledger.publish(m)
        clocks[name].t += 1.0
        ledger.note_step("a@1", "continuous", decode_s=0.5, tokens_out=9)
        ledger.publish(m)  # deltas since the last publish
        got[name] = _samples(m.render())
    assert got["port"] == pytest.approx(got["jax"], rel=1e-12)
    if model_labels:
        assert got["port"][("tpusc_tenant_tokens_total",
                            (("direction", "out"), ("model", "a:1")))] > 0
    else:
        assert got["port"] == {}


def test_noisy_neighbour_dump_lands_in_the_flight_dir(tmp_path, clocks):
    """One tenant holding the step window while another has rows queued
    fires one ``noisy_neighbor`` dump through the recorder (its cooldown
    turns the stream of exceedances into one file), in both packages."""
    got = {}
    for name, mod, rec in (("jax", jaccounting, jflight.RECORDER),
                           ("port", accounting, flight_recorder.RECORDER)):
        rec.configure(flight_dir=str(tmp_path / name))
        ledger = mod.TenantLedger(noisy_share=0.8, noisy_window_s=5.0, noisy_min_step_s=0.25)
        for _ in range(10):
            clocks[name].t += 0.1
            ledger.note_step("b@1", "continuous", decode_s=0.001, queue_depth=3)
            ledger.note_step("a@1", "continuous", decode_s=0.2)
        files = sorted(os.listdir(tmp_path / name))
        got[name] = [f.split("_", 3)[-1] for f in files]
        payload = json.loads((tmp_path / name / files[0]).read_text())
        got[name].append((payload["model"], sorted(payload["context"])))
    assert got["port"] == got["jax"]
    assert got["port"][0] == "noisy_neighbor.json" and len(got["port"]) == 2
    assert got["port"][1][0] == "a@1"
