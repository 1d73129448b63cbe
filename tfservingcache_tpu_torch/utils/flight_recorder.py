"""Engine flight recorder: always-on per-step telemetry + anomaly dumps
(counterpart of ``tfservingcache_tpu/utils/flight_recorder.py``; its dumps
keep the reference's layout, so ``tools/engine_dump.py`` renders them).

The continuous engine (runtime/batcher.py) is a black box between
"admitted" and "retired": the SLO histograms say a request was slow, the
traces say which request, but neither says what the ENGINE was doing —
queue depth, lane occupancy, page pressure, wasted steps — at the moment
it went wrong. This module is the box's flight recorder:

- **Step ring**: one fixed-size record per engine boundary (a decode
  chunk or speculative round, or a prefill-only boundary) into a per-model
  ring buffer, ~4096 entries by default. Writes are lock-free on the hot
  path: a preallocated list, an ``itertools.count`` (atomic under the GIL)
  for slot assignment, and one tuple build.
- **Phase notes**: the per-request phase clocks (queue -> prefill ->
  decode -> respond) that also feed ``tpusc_request_phase_seconds`` are
  mirrored here (bounded deque per model) so a dump carries the exact
  per-request attribution for the window that triggered it.
- **Watermarks**: high-water marks (HBM in use, host-tier bytes, KV arena
  pages) observed at the existing gauge-update sites. Reset-on-scrape:
  ``GET /monitoring/engine`` returns them and zeroes the marks, so each
  scrape interval reports its own peak (pass ``reset=0`` to peek).
- **Anomaly dumps**: SLO breach (hooked into the tracer's slow-trace
  retention path), page-exhaustion blocking, and engine-thread crash each
  write the full ring + engine state to a bounded spool dir
  (``observability.flight_dir``). Dumps are deduplicated (per trace id)
  and rate-limited (per reason+model cooldown) so one incident is one
  file, not a disk-filling stream. ``tools/engine_dump.py`` pretty-prints
  them for postmortems.

Like the tracer (utils/tracing.py) the recorder is a process-wide default
instance: diagnostics are write-mostly and bounded, so a global keeps
every call site plumbing-free; tests construct their own instances or
clear the global. Rings record from construction; dumps stay OFF
until ``configure(flight_dir=...)`` (server startup) so bare components in
tests never touch the filesystem.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any

from tfservingcache_tpu_torch.utils.logging import get_logger

from tfservingcache_tpu_torch.utils.lockcheck import lockchecked

log = get_logger("flight_recorder")

# One record per dispatched chunk / batch drain. Fixed tuple layout (not a
# dict) keeps the hot-path write a single list-slot assignment; the names
# are the serialization contract for snapshots, dumps, and
# tools/engine_dump.py.
STEP_FIELDS = (
    "t_wall",          # epoch seconds at record time
    "engine",          # "continuous" | "coalesce"
    "step_ms",         # wall time of this chunk boundary / batch drain
    "chunk",           # decode steps computed per lane this dispatch
    "active",          # lanes (rows) the dispatch computed for
    "admitted",        # rows admitted at this boundary
    "retired",         # rows retired at this boundary
    "pages_used",      # KV arena pages reserved after this step (0 = dense)
    "pages_free",      # KV arena pages free after this step
    "wasted",          # steps computed for already-finished rows this step
    "queue_depth",     # rows still waiting for admission
    "oldest_wait_ms",  # age of the oldest queued row (0 when queue empty)
    # appended fields (shared-prefix KV) — new names go at the END so the
    # positional indices older dumps/tools rely on stay valid
    "pages_shared",    # arena pages referenced by >1 owner after this step
    "prefix_hits",     # admissions this boundary that reused prefix KV
    # appended fields (in-engine speculative decoding)
    "drafted",         # draft tokens proposed this step (0 = plain chunk)
    "accepted",        # tokens emitted by the verify round this step
)

DEFAULT_RING_ENTRIES = 4096
_PHASE_NOTES_PER_MODEL = 64


def _step_dict(e: tuple) -> dict[str, Any]:
    """One ring tuple -> the serialization dict. record() always writes
    full-width tuples, so the common case is a literal build (cheaper than
    dict(zip); snapshot() materializes tail*models of these); short tuples (deserialized
    from dumps older than the shared-prefix fields) fall back to zip."""
    if len(e) == 16:
        return {
            "t_wall": e[0], "engine": e[1], "step_ms": e[2], "chunk": e[3],
            "active": e[4], "admitted": e[5], "retired": e[6],
            "pages_used": e[7], "pages_free": e[8], "wasted": e[9],
            "queue_depth": e[10], "oldest_wait_ms": e[11],
            "pages_shared": e[12], "prefix_hits": e[13],
            "drafted": e[14], "accepted": e[15],
        }
    return dict(zip(STEP_FIELDS, e))


class _Ring:
    """Lock-free fixed-size ring of step tuples: one writer-side atomic
    counter hands out slots, so concurrent writers (coalescer leaders of
    the same model) never block each other; a torn read during snapshot
    costs at most one misordered diagnostic row, never a crash."""

    def __init__(self, entries: int) -> None:
        self.entries = entries
        self.buf: list[tuple | None] = [None] * entries
        self._ctr = itertools.count()
        self.written = 0  # monotonic-ish total (racy, diagnostics only)

    def append(self, rec: tuple) -> None:
        i = next(self._ctr)
        self.buf[i % self.entries] = rec
        self.written = i + 1

    def tail(self, n: int) -> list[tuple]:
        """Last ``n`` records, oldest first. Copies only the requested
        window (one or two list slices), not the whole ring, so a snapshot
        over many tenant rings stays cheap. Slices are GIL-atomic reference
        copies; a concurrent writer costs at most one misordered row."""
        w = self.written
        n = max(0, min(n, w, self.entries))
        if n == 0:
            return []
        start = (w - n) % self.entries
        stop = w % self.entries
        if start >= stop:  # window wraps (or spans the full ring)
            part = self.buf[start:] + self.buf[:stop]
        else:
            part = self.buf[start:stop]
        return [rec for rec in part if rec is not None]


@lockchecked
class FlightRecorder:
    # Registry entries are checked statically AND dynamically; _rings/_phases
    # carry static-only "# guarded-by:" comments instead because their hot-path
    # readers are deliberately lock-free (see waivers.txt).
    _tpusc_guarded = {
        "_dumped_keys": "_lock",
        "_last_dump": "_lock",
    }

    def __init__(
        self,
        ring_entries: int = DEFAULT_RING_ENTRIES,
        flight_dir: str | None = None,
        max_dumps: int = 16,
        dump_cooldown_s: float = 60.0,
    ) -> None:
        self.ring_entries = max(16, int(ring_entries))
        self.flight_dir = flight_dir
        self.max_dumps = max(1, int(max_dumps))
        self.dump_cooldown_s = float(dump_cooldown_s)
        self._lock = threading.Lock()        # structure mutations only
        self._rings: dict[str, _Ring] = {}  # guarded-by: _lock
        self._phases: dict[str, collections.deque] = {}  # guarded-by: _lock
        self._marks: dict[str, float] = {}
        self._dump_seq = itertools.count()
        self._dumped_keys: collections.deque = collections.deque(maxlen=256)
        self._last_dump: dict[tuple, float] = {}
        # latest conversation-KV tier stats (cache/conversation_kv.py
        # _update_gauges): parked counts/bytes/hit-rate. Rides the recorder
        # so /monitoring/engine and tools/engine_dump.py surface the tier
        # without a separate endpoint.
        self._conversation_kv: dict[str, Any] | None = None

    def configure(
        self,
        flight_dir: str | None = None,
        ring_entries: int | None = None,
        max_dumps: int | None = None,
        dump_cooldown_s: float | None = None,
    ) -> None:
        """Apply config to the process-wide recorder (server startup). An
        empty/None ``flight_dir`` keeps dumps disabled; existing rings keep
        their size (resizing would drop the history worth keeping)."""
        with self._lock:
            if flight_dir is not None:
                self.flight_dir = flight_dir or None
            if ring_entries is not None:
                self.ring_entries = max(16, int(ring_entries))
            if max_dumps is not None:
                self.max_dumps = max(1, int(max_dumps))
            if dump_cooldown_s is not None:
                self.dump_cooldown_s = float(dump_cooldown_s)

    def install_slow_hook(self, tracer: Any) -> None:
        """Hook the tracer's slow-trace retention path: every root span
        that crosses ``slow_threshold_s`` (the same tail-sampling gate that
        keeps the trace findable) also triggers one engine dump, deduped by
        trace id so one breached request is exactly one file."""
        tracer.slow_hook = self._on_slow_trace

    def _on_slow_trace(self, span: Any) -> None:
        self.dump(
            "slo_breach",
            dedup_key=("slo", span.trace_id),
            trace_id=span.trace_id,
            root_span=span.name,
            duration_s=round(span.duration_s, 6),
            attrs=dict(span.attrs),
        )

    # -- hot path ------------------------------------------------------------
    def _ring(self, model: str) -> _Ring:
        ring = self._rings.get(model)
        if ring is None:
            with self._lock:
                ring = self._rings.setdefault(model, _Ring(self.ring_entries))
        return ring

    def record(
        self,
        model: str,
        engine: str,
        step_ms: float,
        chunk: int,
        active: int,
        admitted: int,
        retired: int,
        pages_used: int = 0,
        pages_free: int = 0,
        wasted: int = 0,
        queue_depth: int = 0,
        oldest_wait_ms: float = 0.0,
        pages_shared: int = 0,
        prefix_hits: int = 0,
        drafted: int = 0,
        accepted: int = 0,
    ) -> None:
        self._ring(model).append((
            time.time(), engine, round(step_ms, 4), chunk, active, admitted,
            retired, pages_used, pages_free, wasted, queue_depth,
            round(oldest_wait_ms, 3), pages_shared, prefix_hits,
            drafted, accepted,
        ))

    def note_phases(
        self,
        model: str,
        engine: str,
        phases: dict[str, float],
        trace_id: str | None = None,
    ) -> None:
        """Mirror one request's phase clocks (the same values observed into
        ``tpusc_request_phase_seconds``) so dumps carry exact per-request
        attribution for the triggering window."""
        dq = self._phases.get(model)
        if dq is None:
            with self._lock:
                dq = self._phases.setdefault(
                    model, collections.deque(maxlen=_PHASE_NOTES_PER_MODEL)
                )
        dq.append({
            "t_wall": time.time(),
            "engine": engine,
            "trace_id": trace_id or "",
            "phases": {k: round(v, 6) for k, v in phases.items()},
        })

    def observe_watermark(self, key: str, value: float) -> float:
        """Track a high-water mark; returns the current peak so the call
        site can mirror it into its Prometheus peak gauge."""
        cur = self._marks.get(key, 0.0)
        if value > cur:
            self._marks[key] = value
            return float(value)
        return float(cur)

    # -- read side -----------------------------------------------------------
    def watermarks(self, reset: bool = False) -> dict[str, float]:
        with self._lock:
            out = dict(self._marks)
            if reset:
                self._marks.clear()
        return out

    @staticmethod
    def _window(entries: list[tuple]) -> dict[str, Any]:
        """Aggregate a step window: goodput = useful / total computed
        step-slots (useful = active*chunk - wasted), the one-number answer
        to "is the engine's compute going to live requests"."""
        # single pass (not one generator sweep per aggregate): this runs
        # per model per snapshot, so at 128 tenant rings the constant matters
        total = wasted = admitted = hits = 0
        drafted = accepted = spec_slots = 0
        step_ms = 0.0
        max_depth = 0
        max_wait = 0.0
        max_shared = 0
        for e in entries:
            total += e[4] * e[3]                        # active * chunk
            wasted += e[9]
            admitted += e[5]
            step_ms += e[2]
            if e[10] > max_depth:
                max_depth = e[10]
            if e[11] > max_wait:
                max_wait = e[11]
            # appended fields may be absent in entries deserialized from old
            # dumps — treat short tuples as zero, same as a dense engine
            if len(e) > 12 and e[12] > max_shared:
                max_shared = e[12]
            if len(e) > 13:
                hits += e[13]
            if len(e) > 15 and e[14]:
                # speculative steps only: acceptance = emitted tokens over
                # the round's emission capacity (active * (spec+1) slots)
                drafted += e[14]
                accepted += e[15]
                spec_slots += e[4] * e[3]
        return {
            "steps": len(entries),
            "step_slots": total,
            "wasted_steps": wasted,
            "goodput": round((total - wasted) / total, 6) if total else 1.0,
            "step_ms_sum": round(step_ms, 3),
            "max_queue_depth": max_depth,
            "max_oldest_wait_ms": max_wait,
            "admitted": admitted,
            "prefix_hits": hits,
            "prefix_hit_rate": round(hits / admitted, 6) if admitted else 0.0,
            "max_pages_shared": max_shared,
            "drafted": drafted,
            "accepted": accepted,
            "spec_acceptance": (
                round(accepted / spec_slots, 6) if spec_slots else 0.0
            ),
        }

    def note_conversation_kv(self, stats: dict[str, Any]) -> None:
        """Record the conversation-KV tier's latest stats row (called by
        the tier on every put/evict/promote — a dict swap, not a merge, so
        the cost is one assignment under the lock)."""
        with self._lock:
            self._conversation_kv = dict(stats)

    def conversation_kv_stats(self) -> dict[str, Any] | None:
        with self._lock:
            return dict(self._conversation_kv) if self._conversation_kv else None

    def engine_stats(self, tail: int = 32) -> dict[str, float]:
        """Cheap cross-model aggregate for the fleet status plane
        (cluster/status.py): goodput over the last ``tail`` ring entries,
        the summed current queue depth and the worst current oldest wait.
        Builds no per-step dicts, so a status collection stays cheap."""
        total = wasted = depth = spec_slots = accepted = 0
        wait_ms = 0.0
        for ring in list(self._rings.values()):
            entries = ring.tail(tail)
            if not entries:
                continue
            for e in entries:
                total += e[4] * e[3]                     # active * chunk
                wasted += e[9]
                if len(e) > 15 and e[14]:
                    spec_slots += e[4] * e[3]
                    accepted += e[15]
            last = entries[-1]
            depth += last[10]
            wait_ms = max(wait_ms, last[11])
        return {
            "goodput": (total - wasted) / total if total else 1.0,
            "queue_depth": depth,
            "oldest_wait_ms": wait_ms,
            # emitted tokens over speculative emission capacity in the
            # window; 0.0 when no spec round ran
            "spec_acceptance": accepted / spec_slots if spec_slots else 0.0,
        }

    def snapshot(
        self,
        tail: int = 64,
        reset_watermarks: bool = False,
        model: str | None = None,
        row_budget: int | None = 2048,
    ) -> dict[str, Any]:
        """JSON-ready engine state: per-model step window + aggregates,
        phase notes, watermarks. The ``/monitoring/engine`` payload.
        ``model`` (the "name@version" ring key) restricts the per-model
        sections to one tenant — the multi-tenant ?model= filter; an
        unknown model yields empty sections plus an explicit
        ``model_found: false`` marker (tools/engine_dump.py renders it), so
        a typo'd tenant is distinguishable from a quiet engine.

        ``row_budget`` caps the TOTAL step rows materialized across models:
        past budget/tail tenants the per-model tail shrinks (floor 8), so
        the payload — and the work — does not scale linearly with tenant
        count. Anomaly dumps pass
        ``row_budget=None``: a postmortem wants the full rings."""
        with self._lock:
            rings = dict(self._rings)
            phases = {m: list(dq) for m, dq in self._phases.items()}
        found = model is None or model in rings or model in phases
        if model is not None:
            rings = {m: r for m, r in rings.items() if m == model}
            phases = {m: p for m, p in phases.items() if m == model}
        if row_budget is not None and rings:
            tail = max(8, min(tail, row_budget // len(rings)))
        models: dict[str, Any] = {}
        for name, ring in rings.items():
            entries = ring.tail(tail)
            models[name] = {
                "recorded_steps": ring.written,
                "window": self._window(entries),
                "steps": [_step_dict(e) for e in entries],
            }
        out: dict[str, Any] = {
            "ring_entries": self.ring_entries,
            "models": models,
            "phases": phases,
            "watermarks": self.watermarks(reset=reset_watermarks),
        }
        ckv = self.conversation_kv_stats()
        if ckv is not None:
            out["conversation_kv"] = ckv
        if model is not None:
            out["model_filter"] = model
            out["model_found"] = found
        return out

    # -- anomaly dumps -------------------------------------------------------
    def dump(
        self,
        reason: str,
        dedup_key: tuple | None = None,
        model: str | None = None,
        **context: Any,
    ) -> str | None:
        """Write the full ring + engine state to the spool dir. Returns the
        file path, or None when dumps are disabled / deduped / cooling
        down. Never raises: a failing dump must not fail the request or
        kill the scheduler thread that tripped it."""
        if self.flight_dir is None:
            return None
        now = time.monotonic()
        with self._lock:
            if dedup_key is not None:
                if dedup_key in self._dumped_keys:
                    return None
                self._dumped_keys.append(dedup_key)
            else:
                cool_key = (reason, model or "")
                last = self._last_dump.get(cool_key)
                if last is not None and now - last < self.dump_cooldown_s:
                    return None
                self._last_dump[cool_key] = now
            seq = next(self._dump_seq)
        try:
            payload = self.snapshot(tail=self.ring_entries, row_budget=None)
            payload.update(
                reason=reason,
                model=model or "",
                time_s=time.time(),
                context=context,
            )
            os.makedirs(self.flight_dir, exist_ok=True)
            fname = (
                f"flight_{time.strftime('%Y%m%dT%H%M%S', time.gmtime())}"
                f"_{seq:06d}_{reason}.json"
            )
            path = os.path.join(self.flight_dir, fname)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, separators=(",", ":"), default=str)
            os.replace(tmp, path)
            self._prune_dumps()
            log.warning("flight recorder dumped %s -> %s", reason, path)
            return path
        except Exception as e:  # noqa: BLE001 — diagnostics must stay non-fatal
            log.warning("flight dump for %s failed: %s", reason, e)
            return None

    def list_dumps(self) -> list[str]:
        if self.flight_dir is None or not os.path.isdir(self.flight_dir):
            return []
        return sorted(
            f for f in os.listdir(self.flight_dir)
            if f.startswith("flight_") and f.endswith(".json")
        )

    def _prune_dumps(self) -> None:
        """Bound the spool dir: names embed (utc timestamp, global seq) so
        lexical order IS write order — delete oldest beyond max_dumps."""
        files = self.list_dumps()
        for f in files[: max(0, len(files) - self.max_dumps)]:
            try:
                os.remove(os.path.join(self.flight_dir, f))
            except OSError:
                pass

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._phases.clear()
            self._marks.clear()
            self._dumped_keys.clear()
            self._last_dump.clear()


# Process-wide default (same rationale as utils/tracing.TRACER): recording
# is always on and bounded; dumps arm only when server startup configures a
# flight_dir. Tests snapshot/clear or construct their own instances.
RECORDER = FlightRecorder()
