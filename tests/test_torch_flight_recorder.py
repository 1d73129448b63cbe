"""The port's engine flight recorder (tfservingcache_tpu_torch/utils/
flight_recorder.py) against the JAX package's: the same ``record`` /
``note_phases`` / ``observe_watermark`` calls give the same snapshot (apart
from the wall-clock stamps), the same reset-on-scrape marks, and dumps with
the same dedup, cooldown and spool bound, written only into the test's own
directory. The reference's ``tools/engine_dump.py`` renders a port dump."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tfservingcache_tpu.utils import flight_recorder as jflight
from tfservingcache_tpu_torch.utils import flight_recorder

from torch_obs_globals import confined_globals

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jflight, "port": flight_recorder}


@pytest.fixture(autouse=True)
def _clean_globals():
    with confined_globals():
        yield


def _strip_wall(obj):
    """Drop every ``t_wall`` / ``time_s`` stamp, recursively."""
    if isinstance(obj, dict):
        return {k: _strip_wall(v) for k, v in obj.items() if k not in ("t_wall", "time_s")}
    if isinstance(obj, list):
        return [_strip_wall(v) for v in obj]
    return obj


def _drive(rec) -> None:
    """Two models' rings (one wraps), spec and shared-prefix fields, phase
    notes and watermarks."""
    for i in range(40):
        rec.record("lm@1", "continuous", step_ms=1.23456 + i, chunk=8 if i % 5 else 0,
                   active=i % 4, admitted=i % 3, retired=i % 2, pages_used=i, pages_free=64 - i,
                   wasted=i % 3, queue_depth=i % 7, oldest_wait_ms=0.1234 * i,
                   pages_shared=i % 5, prefix_hits=i % 2, drafted=4 * (i % 2),
                   accepted=3 * (i % 2))
    for i in range(5):
        rec.record("draft@2", "coalesce", step_ms=2.0, chunk=4, active=2, admitted=1, retired=0)
    for i in range(3):
        rec.note_phases("lm@1", "continuous",
                        {"queue": 0.0012345678, "prefill": 0.02, "decode": 0.3 + i,
                         "respond": 1e-7}, trace_id=f"t{i}" if i else None)
    rec.note_phases("draft@2", "continuous", {"preempt_park": 0.004})
    assert rec.observe_watermark("gen_kv_pages_used", 12) == 12.0
    assert rec.observe_watermark("gen_kv_pages_used", 5) == 12.0
    assert rec.observe_watermark("hbm_bytes:g0", 1 << 30) == float(1 << 30)
    rec.note_conversation_kv({"host_conversations": 2, "hits": 1})


@pytest.mark.parametrize("kwargs", [
    {}, {"tail": 8}, {"tail": 0}, {"model": "lm@1"}, {"model": "nope@1"},
    {"tail": 64, "row_budget": 16}, {"tail": 1000, "row_budget": None},
])
def test_snapshot_matches_the_reference(kwargs):
    snaps = {}
    for name, mod in PACKAGES.items():
        rec = mod.FlightRecorder(ring_entries=32)
        _drive(rec)
        snaps[name] = _strip_wall(rec.snapshot(**kwargs))
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]["ring_entries"] == 32
    if "model" not in kwargs:
        assert snaps["port"]["models"]["lm@1"]["recorded_steps"] == 40


def test_ring_fields_and_window_math():
    rec = flight_recorder.FlightRecorder(ring_entries=16)
    _drive(rec)
    steps = rec.snapshot(tail=16)["models"]["lm@1"]["steps"]
    assert len(steps) == 16
    assert list(steps[0]) == list(flight_recorder.STEP_FIELDS) == list(jflight.STEP_FIELDS)
    assert len(flight_recorder.STEP_FIELDS) == 16
    assert [s["pages_used"] for s in steps] == list(range(24, 40))  # the last 16, oldest first


def test_watermarks_reset_on_scrape_like_the_reference():
    marks = {}
    for name, mod in PACKAGES.items():
        rec = mod.FlightRecorder()
        _drive(rec)
        peek = rec.snapshot(reset_watermarks=False)["watermarks"]
        consumed = rec.snapshot(reset_watermarks=True)["watermarks"]
        after = rec.snapshot()["watermarks"]
        rec.observe_watermark("gen_kv_pages_used", 3)
        marks[name] = (peek, consumed, after, rec.watermarks())
    assert marks["port"] == marks["jax"]
    assert marks["port"][0] == {"gen_kv_pages_used": 12.0, "hbm_bytes:g0": float(1 << 30)}
    assert marks["port"][2] == {} and marks["port"][3] == {"gen_kv_pages_used": 3.0}


def _dump_run(mod, flight_dir: Path):
    """Dumps off, then on: dedup by key, cooldown by (reason, model) and
    the spool bound."""
    rec = mod.FlightRecorder(ring_entries=16, max_dumps=3, dump_cooldown_s=3600.0)
    _drive(rec)
    results = [rec.dump("engine_crash", model="lm@1")]  # dumps off: None
    assert rec.list_dumps() == []
    rec.configure(flight_dir=str(flight_dir))
    results += [
        rec.dump("engine_crash", model="lm@1", error="boom"),
        rec.dump("engine_crash", model="lm@1"),               # cooling down
        rec.dump("page_exhaustion", model="lm@1", needed_pages=9),
        rec.dump("slo_breach", dedup_key=("slo", "t1")),
        rec.dump("slo_breach", dedup_key=("slo", "t1")),       # deduped
        rec.dump("slo_breach", dedup_key=("slo", "t2")),
    ]
    return rec, [r is not None for r in results]


def test_dumps_dedup_cooldown_and_spool_bound_like_the_reference(tmp_path):
    got = {}
    for name, mod in PACKAGES.items():
        flight_dir = tmp_path / name
        rec, wrote = _dump_run(mod, flight_dir)
        names = rec.list_dumps()
        assert sorted(os.listdir(flight_dir)) == names  # no tmp file left behind
        got[name] = (wrote, [n.split("_", 3)[-1] for n in names])
    assert got["port"] == got["jax"]
    wrote, kept = got["port"]
    assert wrote == [False, True, False, True, True, False, True]
    # four written, the spool keeps the newest three
    assert kept == ["page_exhaustion.json", "slo_breach.json", "slo_breach.json"]
    payload = json.loads((tmp_path / "port" / rec_name(tmp_path / "port", "page")).read_text())
    assert payload["reason"] == "page_exhaustion" and payload["model"] == "lm@1"
    assert payload["context"] == {"needed_pages": 9}
    assert len(payload["models"]["lm@1"]["steps"]) == 16  # the full ring, no row budget


def rec_name(flight_dir: Path, part: str) -> str:
    return next(n for n in sorted(os.listdir(flight_dir)) if part in n)


def test_slow_hook_dumps_one_slo_breach_per_trace(tmp_path):
    from tfservingcache_tpu_torch.utils.tracing import Tracer

    rec = flight_recorder.FlightRecorder(flight_dir=str(tmp_path))
    tracer = Tracer(slow_threshold_s=1e-9)
    rec.install_slow_hook(tracer)
    with tracer.span("rest", route="local"):
        pass
    rec._on_slow_trace(tracer._traces[0])  # the same trace again: deduped
    assert [n.split("_", 3)[-1] for n in rec.list_dumps()] == ["slo_breach.json"]
    ctx = json.loads((tmp_path / rec.list_dumps()[0]).read_text())["context"]
    assert ctx["root_span"] == "rest" and ctx["attrs"] == {"route": "local"}
    assert ctx["trace_id"] == tracer._traces[0].trace_id


def test_engine_dump_tool_renders_a_port_dump(tmp_path):
    """The reference's postmortem tool reads the port's dump format."""
    rec = flight_recorder.FlightRecorder(ring_entries=16, flight_dir=str(tmp_path))
    _drive(rec)
    path = rec.dump("engine_crash", model="lm@1", error="RuntimeError('x')")
    assert path is not None
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "engine_dump.py"), "--latest",
                        str(tmp_path)], capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "flight dump: engine_crash" in r.stdout
    assert "goodput=" in r.stdout and "lm@1" in r.stdout
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "engine_dump.py"), "--latest",
                        str(tmp_path / "empty")], capture_output=True, text=True, timeout=60)
    assert r.returncode == 1
