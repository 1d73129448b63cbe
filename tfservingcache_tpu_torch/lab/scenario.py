"""Scenario x fault cell runner: replay a compiled schedule, emit an SLO
scorecard row (counterpart of ``tfservingcache_tpu/lab/scenario.py``: the
same schema, percentile rule and counter diffs).

``run_cell`` is harness-agnostic: the caller supplies a
``generate_fn(ScheduledRequest) -> dict`` closure over whatever stack it
built (an engine alone in the tests, a manager + runtime on the card in
``chip_smoke.py``'s ``lab`` phase), plus optional ``Metrics`` and census
hooks. The runner owns only the open-loop replay (one thread per request,
sleeping to its compiled arrival offset), the fault arming and the
scorecard math.

Every row stamps ``kernel_active`` and ``platform``, so a row that ran the
plain path cannot pass for one that ran the card's kernels.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

from tfservingcache_tpu_torch.lab import faults as lab_faults
from tfservingcache_tpu_torch.lab.workload import ScheduledRequest, WorkloadSpec
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER
from tfservingcache_tpu_torch.utils.logging import get_logger

log = get_logger("lab.scenario")

__all__ = [
    "default_scenarios",
    "default_faults",
    "run_cell",
    "SCORECARD_FIELDS",
]

# the scorecard schema, in render order (the reference's, key for key)
SCORECARD_FIELDS = (
    "scenario", "fault", "requests", "completed", "lost", "recovered",
    "p50_ttft_ms", "p95_ttft_ms", "p99_ttft_ms", "tok_s", "wall_s",
    "tokens_out", "goodput", "cold_miss_rate", "fault_injections",
    "preemptions", "conservation_ok", "kernel_active", "platform",
)


def default_scenarios(
    tenants: tuple[str, ...] = ("lm",), requests: int = 16, max_new: int = 10,
) -> list[WorkloadSpec]:
    """The standard 4-scenario row set."""
    multi = tenants if len(tenants) > 1 else tenants * 2
    return [
        WorkloadSpec(
            name="steady_poisson", tenants=tenants[:1], arrival="poisson",
            rate_rps=24.0, requests=requests, max_new=max_new,
            prompt_lens=(6, 12, 24),
        ),
        WorkloadSpec(
            name="zipf_burst", tenants=multi, zipf_s=1.1, arrival="burst",
            burst_size=max(2, requests // 4), burst_gap_s=0.3,
            requests=requests, max_new=max_new, prompt_lens=(8, 16),
        ),
        WorkloadSpec(
            name="flash_crowd", tenants=multi, zipf_s=0.8,
            arrival="flash_crowd", rate_rps=12.0, flash_at_s=0.4,
            flash_width_s=0.05, flash_share=0.6, requests=requests,
            max_new=max_new, prompt_lens=(6, 12),
        ),
        WorkloadSpec(
            name="multi_turn", tenants=tenants[:1], arrival="poisson",
            rate_rps=16.0, requests=requests, max_new=max_new, turns=4,
            turn_gap_s=0.15, prompt_lens=(8,), turn_suffix_tokens=8,
        ),
    ]


def default_faults(duration_s: float = 0.4) -> list[lab_faults.FaultSpec | None]:
    """The standard fault columns: a no-fault baseline plus one spec per
    armed kind. ``after`` puts a firing mid-run, not at t=0: a kill before
    any admission exercises nothing."""
    return [
        None,
        lab_faults.FaultSpec(kind="kill_engine", after=3, count=1),
        lab_faults.FaultSpec(
            kind="freeze_scheduler", after=2, count=1, duration_s=duration_s
        ),
        lab_faults.FaultSpec(
            kind="stall_store", after=0, count=1, duration_s=duration_s
        ),
        lab_faults.FaultSpec(kind="drop_peer", after=0, count=0),
    ]


def _family_sum(metrics: Any, family: str) -> float:
    """A counter's or gauge's samples summed over every label set."""
    if metrics is None:
        return 0.0
    return metrics.registry.family_total(family)


def _pct(sorted_ms: list[float], q: float) -> float:
    if not sorted_ms:
        return 0.0
    i = min(len(sorted_ms) - 1, int(round(q * (len(sorted_ms) - 1))))
    return sorted_ms[i]


def _default_platform() -> str:
    """The reference's ``jax.default_backend()`` in the port's words: "gpu"
    on a CUDA build with a card, else "cpu" (never "cuda")."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def run_cell(
    schedule: list[ScheduledRequest],
    generate_fn: Callable[[ScheduledRequest], dict],
    *,
    scenario_name: str = "",
    fault: "lab_faults.FaultSpec | None" = None,
    metrics: Any = None,
    census_fn: Callable[[], bool] | None = None,
    kernel_active: bool = False,
    platform: str | None = None,
) -> dict[str, Any]:
    """Run one scenario x fault cell and return its scorecard row.

    ``generate_fn`` must return ``{"ok": bool, "ttft_s": float | None,
    "tokens": int, "error": str | None}`` a request and never raise (a lost
    request is a measurement, not a harness crash; one that raises is
    counted lost). ``census_fn`` returns the page-conservation verdict after
    the replay (None in the row when the stack has no paged state).
    ``platform`` defaults to the process's ("gpu" or "cpu"); a caller that
    holds a runtime passes its device's.
    """
    if platform is None:
        platform = _default_platform()

    base_recovered = _family_sum(metrics, "tpusc_requests_recovered")
    base_preempted = _family_sum(metrics, "tpusc_gen_preemptions")
    base_injected = _family_sum(metrics, "tpusc_fault_injected")
    base_lookups = _family_sum(metrics, "tfservingcache_cache")
    base_misses = _family_sum(metrics, "tfservingcache_cache_misses")
    base_faults = RECORDER.fault_counts()

    results: list[dict | None] = [None] * len(schedule)

    def _one(i: int, sr: ScheduledRequest, t0: float) -> None:
        delay = t0 + sr.at_s - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            results[i] = generate_fn(sr)
        except Exception as e:  # noqa: BLE001 - a lost request is data
            results[i] = {"ok": False, "ttft_s": None, "tokens": 0,
                          "error": repr(e)}

    if fault is not None:
        # arm a fresh copy: a FaultSpec's visits/fired tallies are runtime
        # state, and a spec reused across a matrix must fire in every cell
        lab_faults.arm(
            [dataclasses.replace(fault, visits=0, fired=0)], metrics=metrics
        )
    try:
        t0 = time.monotonic()
        threads: list[threading.Thread] = []
        for i, sr in enumerate(schedule):
            t = threading.Thread(target=_one, args=(i, sr, t0), daemon=True)
            threads.append(t)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
    finally:
        if fault is not None:
            lab_faults.disarm()

    rows = [r if r is not None else
            {"ok": False, "ttft_s": None, "tokens": 0, "error": "no result"}
            for r in results]
    ok_rows = [r for r in rows if r.get("ok")]
    ttfts = sorted(
        r["ttft_s"] * 1e3 for r in ok_rows if r.get("ttft_s") is not None
    )
    tokens_out = sum(int(r.get("tokens", 0)) for r in ok_rows)
    lookups = _family_sum(metrics, "tfservingcache_cache") - base_lookups
    misses = _family_sum(metrics, "tfservingcache_cache_misses") - base_misses
    injected = sum(RECORDER.fault_counts().values()) - sum(base_faults.values())
    if metrics is not None:
        # the counter when a registry is in play (it survives a recorder
        # shared by concurrent cells)
        injected = int(
            _family_sum(metrics, "tpusc_fault_injected") - base_injected
        ) or injected
    engine = RECORDER.engine_stats()
    row = {
        "scenario": scenario_name,
        "fault": fault.kind if fault is not None else "none",
        "requests": len(schedule),
        "completed": len(ok_rows),
        "lost": len(rows) - len(ok_rows),
        "recovered": int(
            _family_sum(metrics, "tpusc_requests_recovered") - base_recovered
        ),
        "p50_ttft_ms": round(_pct(ttfts, 0.50), 1),
        "p95_ttft_ms": round(_pct(ttfts, 0.95), 1),
        "p99_ttft_ms": round(_pct(ttfts, 0.99), 1),
        "tok_s": round(tokens_out / wall, 1) if wall > 0 else 0.0,
        "wall_s": round(wall, 2),
        "tokens_out": tokens_out,
        "goodput": round(float(engine.get("goodput", 1.0)), 4),
        "cold_miss_rate": round(misses / lookups, 4) if lookups else 0.0,
        "fault_injections": int(injected),
        "preemptions": int(
            _family_sum(metrics, "tpusc_gen_preemptions") - base_preempted
        ),
        "conservation_ok": census_fn() if census_fn is not None else None,
        "kernel_active": bool(kernel_active),
        "platform": platform,
    }
    errs = sorted({str(r.get("error")) for r in rows if not r.get("ok")})
    if errs:
        row["errors"] = errs[:4]
    log.info(
        "cell %s x %s: %d/%d ok, p95 ttft %.0f ms, %d recovered",
        row["scenario"], row["fault"], row["completed"], row["requests"],
        row["p95_ttft_ms"], row["recovered"],
    )
    return row
