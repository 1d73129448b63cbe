"""The batchers of the port (counterpart of
``tfservingcache_tpu/runtime/batcher.py``).

``MicroBatcher`` (``:predict``) and ``GenerateCoalescer`` (``:generate`` on
the solo path) run when ``serving.batch_window_ms > 0``, as in the
reference (:69-697): concurrent requests with one key coalesce into one
runtime call while earlier calls of that key hold its gate.

``ContinuousGenerateEngine`` is iteration-level continuous batching for
``:generate`` (the reference's engine and its per-model scheduler,
:692-2284), selected with ``serving.generate_engine: "continuous"``. Each
model gets a scheduler thread over a fixed number of lanes (the runtime's
``SlotDecodeState``). At every chunk boundary it:
  - admits pending rows into free lanes by (priority class, submit order):
    traffic of one class is exact FIFO. A whole-prompt prefill samples the
    row's first token; on a paged arena the row's prompt + max_new budget is
    reserved first, a row that needs more pages than the arena has fails,
    and a row the free list cannot cover yet waits at the head of the queue.
    A row of a higher class that cannot reserve its pages preempts instead:
    the lowest-class, newest decoding lane is parked (its pages copied to
    host) and requeued, up to ``preempt_limit`` times a row. An admitted
    row resumes from parked pages where it can, in this order: its own
    preemption park, then the conversation tier (``conversation_id`` with
    ``serving.conversation_kv_bytes``), then the arena's radix index
    (``serving.kv_share_prefix_bytes``: an indexed prefix mapped read-only,
    an exact repeat not prefilled at all), and only the suffix is
    prefilled. With ``serving.prefill_chunk_tokens`` a cold prompt longer
    than the chunk enters a PREFILLING lane instead, and every such lane
    advances one chunk per boundary (B3 at T = chunk) while the others
    decode;
  - advances every active lane by one decode chunk, clamped to
    ``max(1, min(chunk_tokens, next_bucket(max_remaining)))`` — or, with a
    draft model attached (``serving.spec_draft_model``), by one speculative
    draft/verify round in which each lane accepts a variable-length prefix;
  - retires rows the moment they emit EOS or reach their max_new, at the
    prefill and inside a chunk or round; a row with a conversation id parks
    its pages in the engine's tier, then every row gives its pages back.
Each emitted token goes to the row's ``on_token`` callback (the SSE stream).
When a step raises, the slot state is dropped and, with
``serving.generate_recovery``, the in-flight and queued rows move to a fresh
scheduler (each re-prefills its prompt + the tokens it emitted) until a row
has survived ``serving.generate_max_recoveries`` crashes; without it every
row fails. ``lab.faults`` fires its ``engine_step`` hook at the top of each
step (``kill_engine``, ``freeze_scheduler``).
Seeded and malformed requests go to ``runtime.generate`` (the solo path).

Observability, at the reference's sites: one flight-recorder ring entry per
boundary (``RECORDER.record`` with all 16 ``STEP_FIELDS``; ``step_ms`` is the
boundary's host wall time, and a prefill-only boundary records chunk 0),
``LEDGER.note_step`` and the page/arena levels, the per-row phase clocks
(queue, prefill, decode, respond) into ``tpusc_request_phase_seconds`` and
the recorder's phase notes at the end of a generate, and the
``tpusc_gen_*`` families (slots, admission wait, oldest queued age, wasted
steps, KV pages with their watermark, page waste, prefix hits by kind,
preemptions, prefill chunks), ``tpusc_batcher_queue_depth{generate}`` and
``tpusc_requests_recovered{reason}``. An engine crash and a row blocked on
page exhaustion each write a flight dump (when dumps are configured). A row
that finishes is released after its boundary is recorded. Each decode chunk
and speculative round runs inside a ``torch.profiler.record_function`` range
(``tpusc.decode_chunk``, ``tpusc.spec_round``), so a profile ties its
kernels to the boundary.
"""

from __future__ import annotations

import collections
import logging
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np
import torch

from tfservingcache_tpu_torch.cache.conversation_kv import ConversationKVTier
from tfservingcache_tpu_torch.lab import faults as lab_faults
from tfservingcache_tpu_torch.runtime.base import BaseRuntime, ModelNotLoadedError, RuntimeError_
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime, next_bucket
from tfservingcache_tpu_torch.types import ModelId
from tfservingcache_tpu_torch.utils.accounting import LEDGER
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER
from tfservingcache_tpu_torch.utils.lockcheck import lockchecked
from tfservingcache_tpu_torch.utils.tracing import TRACER, current_ids

log = logging.getLogger("tpusc_torch.batcher")


# -- micro-batching on :predict and coalescing on :generate -------------------
# (reference batcher.py:69-697; serving.batch_window_ms > 0 turns both on)


@lockchecked
class _Gate:
    """A counted gate admitting up to ``limit`` concurrent holders: leaders
    block once ``limit`` batches of a key are in flight, and arrivals join
    the blocked leader's batch, while ``limit`` batches overlap host codec,
    transfer and compute."""

    _tpusc_guarded = {"in_use": "_count"}

    def __init__(self, limit: int) -> None:
        self._sem = threading.BoundedSemaphore(limit)
        self._count = threading.Lock()
        self.in_use = 0

    def __enter__(self) -> "_Gate":
        self._sem.acquire()
        with self._count:
            self.in_use += 1
        return self

    def __exit__(self, *exc) -> None:
        with self._count:
            self.in_use -= 1
        self._sem.release()


@lockchecked
class _GateMap:
    """Per-key device gates with bounded growth (shared by MicroBatcher and
    GenerateCoalescer). Pruning keeps only in-use gates; losing an idle gate
    costs a coalescing opportunity, never correctness."""

    _tpusc_guarded = {"_gates": "_lock"}

    def __init__(self, max_entries: int = 4096, limit: int = 4) -> None:
        self._lock = threading.Lock()
        self._gates: dict[tuple, _Gate] = {}
        self._max = max_entries
        self._limit = max(1, limit)

    def get(self, key: tuple) -> _Gate:
        with self._lock:
            gate = self._gates.get(key)
            if gate is None:
                if len(self._gates) > self._max:
                    self._gates = {k: g for k, g in self._gates.items() if g.in_use}
                gate = self._gates.setdefault(key, _Gate(self._limit))
            return gate


@dataclass
class _Slot:
    inputs: Mapping[str, np.ndarray]
    rows: int
    done: threading.Event = field(default_factory=threading.Event)
    result: dict[str, np.ndarray] | None = None
    error: BaseException | None = None


@dataclass
class _Pending:
    slots: list[_Slot] = field(default_factory=list)
    rows: int = 0
    closed: bool = False                  # no further joiners


@lockchecked
class MicroBatcher:
    """Continuous micro-batching for ``:predict``. Batches of one (model,
    non-batch shape, filter) key pass a per-key gate; the first arrival
    leads the next batch, and while earlier batches hold the gate later
    arrivals join the leader's pending batch. When the gate admits the
    leader, the batch closes and runs as ONE ``runtime.predict``, its
    outputs split back by each caller's row count. So the accumulation
    window is the device's own busy time: sequential traffic passes an idle
    gate at once, and saturating traffic coalesces without a timed window.

    Models whose inputs lack a named "batch" axis, or with an output reduced
    over the batch, run solo. ``max_batch`` is a hard cap on a batch's
    rows; a request of ``max_batch`` rows or more runs solo."""

    _tpusc_guarded = {
        "_pending": "_lock",
        "_axes_cache": "_lock",
        "_out_axes_cache": "_lock",
    }

    def __init__(
        self,
        runtime: BaseRuntime,
        max_batch: int = 64,
        wait_timeout_s: float = 600.0,
        metrics=None,
        max_inflight: int = 4,
    ) -> None:
        self.runtime = runtime
        self.max_batch = max_batch
        # generous: a follower may sit behind the leader's cold load
        self.wait_timeout_s = wait_timeout_s
        self.metrics = metrics
        self._lock = threading.Lock()
        self._pending: dict[tuple, _Pending] = {}
        self._gates = _GateMap(limit=max_inflight)
        # signature() is static per loaded model: the derived axis maps are
        # cached so the hot path does not rebuild them per request
        self._axes_cache: dict[ModelId, dict[str, int] | None] = {}
        self._out_axes_cache: dict[ModelId, dict[str, int | None]] = {}
        self.batches = 0
        self.batched_requests = 0

    # -- key/axis helpers ---------------------------------------------------
    def _batch_axes(self, model_id: ModelId) -> dict[str, int] | None:
        """Input name -> axis index of its named "batch" axis; None when any
        input OR output lacks one. An output with no batch axis is reduced
        over the batch: coalescing would compute it across other callers'
        rows (a wrong answer and a cross-request leak), so such models run
        solo."""
        with self._lock:
            if model_id in self._axes_cache:
                return self._axes_cache[model_id]
        input_spec, output_spec, _ = self.runtime.signature(model_id)
        axes: dict[str, int] | None = {}
        for name, spec in input_spec.items():
            ax = [i for i, n in spec.dynamic_axes() if n == "batch"]
            if not ax:
                axes = None
                break
            axes[name] = ax[0]
        if axes is not None:
            for spec in output_spec.values():
                if not any(n == "batch" for _, n in spec.dynamic_axes()):
                    axes = None
                    break
        out_axes: dict[str, int | None] = {}
        for name, spec in output_spec.items():
            batch_axes = [a for a, n in spec.dynamic_axes() if n == "batch"]
            out_axes[name] = batch_axes[0] if batch_axes else None
        with self._lock:
            if len(self._axes_cache) > 4096:  # bound growth across tenants
                self._axes_cache.clear()
                self._out_axes_cache.clear()
            self._axes_cache[model_id] = axes
            self._out_axes_cache[model_id] = out_axes
        return axes

    def _key(
        self,
        model_id: ModelId,
        inputs: Mapping[str, np.ndarray],
        axes: Mapping[str, int],
        output_filter: list[str] | None,
    ) -> tuple | None:
        """Batchable only when every input's batch-axis row count agrees and
        all non-batch dims match across joiners (exact-shape coalescing)."""
        if set(inputs) != set(axes):
            return None  # wrong input set: runtime.predict raises cleanly
        rows = None
        sig = []
        for name in sorted(inputs):
            arr = np.asarray(inputs[name])
            ax = axes.get(name)
            if ax is None or arr.ndim <= ax:
                return None
            if rows is None:
                rows = arr.shape[ax]
            elif arr.shape[ax] != rows:
                return None
            rest = tuple(d for i, d in enumerate(arr.shape) if i != ax)
            sig.append((name, str(arr.dtype), rest))
        return (model_id, tuple(sig), tuple(output_filter or ()))

    def _gate(self, key: tuple) -> _Gate:
        return self._gates.get(key)

    # -- core ---------------------------------------------------------------
    def predict(
        self,
        model_id: ModelId,
        inputs: Mapping[str, np.ndarray],
        output_filter: list[str] | None = None,
    ) -> dict[str, np.ndarray]:
        axes = self._batch_axes(model_id)
        key = self._key(model_id, inputs, axes, output_filter) if axes else None
        if key is None:
            return self.runtime.predict(model_id, inputs, output_filter)

        first = sorted(inputs)[0]
        rows = int(np.asarray(inputs[first]).shape[axes[first]])
        if rows >= self.max_batch:
            # at or over the cap on its own: run solo, never join a batch
            return self.runtime.predict(model_id, inputs, output_filter)
        slot = _Slot(inputs=inputs, rows=rows)
        with self._lock:
            pend = self._pending.get(key)
            if pend is not None and pend.rows + rows > self.max_batch:
                # the cap is hard: the full batch keeps its leader, and this
                # request starts (and leads) a fresh one
                pend.closed = True
                self._pending.pop(key, None)
                pend = None
            leader = pend is None
            if leader:
                pend = _Pending()
                self._pending[key] = pend
            pend.slots.append(slot)
            pend.rows += rows
            if pend.rows >= self.max_batch:
                pend.closed = True
                self._pending.pop(key, None)
        if self.metrics is not None:
            self.metrics.batcher_queue_depth.labels("predict").inc()

        if not leader:
            if not slot.done.wait(self.wait_timeout_s):
                raise TimeoutError(f"batched predict for {model_id} timed out")
            if slot.error is not None:
                raise slot.error
            assert slot.result is not None
            return slot.result

        # the leader takes the per-key gate: while earlier batches hold it,
        # every arrival joins THIS batch; an idle gate passes at once
        with self._gate(key):
            with self._lock:
                if not pend.closed:
                    pend.closed = True
                    self._pending.pop(key, None)
            slots = pend.slots
            # the batch leaves the queue the moment its leader holds the gate
            if self.metrics is not None:
                self.metrics.batcher_queue_depth.labels("predict").dec(len(slots))
            try:
                if len(slots) == 1:
                    out = self.runtime.predict(model_id, slot.inputs, output_filter)
                    slot.result = out
                    return out
                with TRACER.span("microbatch", model=str(model_id), requests=len(slots),
                                 rows=pend.rows):
                    cat = {
                        name: np.concatenate(
                            [np.asarray(s.inputs[name]) for s in slots], axis=axes[name])
                        for name in slots[0].inputs
                    }
                    out = self.runtime.predict(model_id, cat, output_filter)
                    self.batches += 1
                    self.batched_requests += len(slots)
                    if self.metrics is not None:
                        self.metrics.coalesced_batches.labels("predict").inc()
                        self.metrics.coalesced_requests.labels("predict").inc(len(slots))
                    self._scatter(model_id, slots, out)
                assert slot.result is not None
                return slot.result
            except BaseException as e:
                for s in slots:
                    if s is not slot and s.result is None and s.error is None:
                        s.error = e
                        s.done.set()
                raise
            finally:
                for s in slots:
                    if s is not slot:
                        s.done.set()

    def _scatter(self, model_id: ModelId, slots: list[_Slot],
                 out: dict[str, np.ndarray]) -> None:
        """Split batched outputs back per caller by row ranges. An output
        without its batch axis, or whose batch length disagrees with the
        total row count, means the model's spec lies about its output: the
        whole batch fails rather than hand callers each other's rows."""
        with self._lock:
            out_axes = dict(self._out_axes_cache.get(model_id, {}))
        offsets = []
        start = 0
        for s in slots:
            offsets.append((start, start + s.rows))
            start += s.rows

        for name, arr in out.items():
            ax = out_axes.get(name)
            a = np.asarray(arr)
            if ax is None or a.ndim <= ax or a.shape[ax] != start:
                raise ValueError(
                    f"batched output {name!r} of {model_id} has shape {a.shape}, "
                    f"expected batch axis {ax} of length {start}; refusing to "
                    f"scatter (would leak rows across requests)"
                )

        for i, s in enumerate(slots):
            lo, hi = offsets[i]
            s.result = {
                name: np.take(arr, range(lo, hi), axis=out_axes[name])
                for name, arr in out.items()
            }


@dataclass
class _GenSlot:
    ids: np.ndarray                       # (rows, s_i) int32 prompts
    lengths: np.ndarray                   # (rows,) true prompt lengths
    max_new: int
    enqueue_t: float = field(default_factory=time.monotonic)
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    error: BaseException | None = None


@dataclass
class _GenPending:
    slots: list[_GenSlot] = field(default_factory=list)
    rows: int = 0
    closed: bool = False


@lockchecked
class GenerateCoalescer:
    """Coalescing for ``:generate`` (the solo path's engine when
    ``serving.batch_window_ms > 0``): MicroBatcher's gate design, so
    sequential traffic pays nothing and concurrent traffic coalesces into
    one solo-path ``runtime.generate`` a batch.

    Key: (model, prompt-seq bucket, new-token bucket, temperature, top_k):
    the runtime pads to the same buckets, and one call samples every row
    with one temperature/top_k. Requests with an explicit ``seed`` never
    coalesce (their contract is a reproducible solo stream), nor do non-
    ``transformer_lm`` families (``moe_lm``'s expert capacity is computed
    over the whole batch) or malformed ``prompt_lengths`` (the runtime's
    error must fail only that request)."""

    _tpusc_guarded = {"_pending": "_lock"}

    def __init__(
        self,
        runtime: BaseRuntime,
        max_batch: int = 32,
        wait_timeout_s: float = 600.0,
        metrics=None,
        max_inflight: int = 2,
    ) -> None:
        self.runtime = runtime
        self.max_batch = max_batch
        self.wait_timeout_s = wait_timeout_s
        self.metrics = metrics
        self._lock = threading.Lock()
        self._pending: dict[tuple, _GenPending] = {}
        # a generate runs long: 2 in flight overlap host prep with decode
        # without piling long jobs behind each other
        self._gates = _GateMap(limit=max_inflight)
        self.batches = 0
        self.batched_requests = 0

    def _gate(self, key: tuple) -> _Gate:
        return self._gates.get(key)

    def generate(
        self,
        model_id: ModelId,
        input_ids: np.ndarray,
        prompt_lengths: list[int] | None = None,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int | None = None,
    ) -> np.ndarray:
        ids = np.asarray(input_ids, np.int32)
        family = getattr(self.runtime, "family_of", lambda _m: None)(model_id)
        if ids.ndim == 2 and family == "transformer_lm":
            # an oversized prompt fails AT SUBMIT (as the continuous engine
            # does), not in the leader's drain after its joiners waited
            max_seq = getattr(self.runtime, "max_seq_of", lambda _m: None)(model_id)
            if max_seq is not None and ids.shape[1] + max_new_tokens > max_seq:
                raise ValueError(
                    f"prompt {ids.shape[1]} + max_new_tokens "
                    f"{max_new_tokens} exceeds max_seq {max_seq}"
                )
        if (
            seed is not None
            or ids.ndim != 2
            or ids.shape[0] >= self.max_batch
            or family != "transformer_lm"
        ):
            # seeded: a reproducible solo stream; malformed shapes: the
            # runtime raises its own clean error; other families never
            # co-batch
            return self.runtime.generate(
                model_id, ids, prompt_lengths=prompt_lengths,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, seed=seed if seed is not None else secrets.randbits(31),
            )
        rows, s = ids.shape
        if prompt_lengths is None:
            lengths = np.full((rows,), s, np.int32)
        else:
            lengths = np.asarray(prompt_lengths, np.int32)
            if lengths.shape != (rows,) or (lengths < 1).any() or (lengths > s).any():
                # invalid per-request params fail ONLY this request
                return self.runtime.generate(
                    model_id, ids, prompt_lengths=prompt_lengths,
                    max_new_tokens=max_new_tokens, temperature=temperature,
                    top_k=top_k, seed=secrets.randbits(31),
                )
        key = (
            model_id, next_bucket(s), next_bucket(max_new_tokens),
            float(temperature), int(top_k),
        )
        slot = _GenSlot(ids=ids, lengths=lengths, max_new=max_new_tokens)
        with self._lock:
            pend = self._pending.get(key)
            if pend is not None and pend.rows + rows > self.max_batch:
                pend.closed = True
                self._pending.pop(key, None)
                pend = None
            leader = pend is None
            if leader:
                pend = _GenPending()
                self._pending[key] = pend
            pend.slots.append(slot)
            pend.rows += rows
            if pend.rows >= self.max_batch:
                pend.closed = True
                self._pending.pop(key, None)
        if self.metrics is not None:
            self.metrics.batcher_queue_depth.labels("generate").inc()

        if not leader:
            if not slot.done.wait(self.wait_timeout_s):
                raise TimeoutError(f"batched generate for {model_id} timed out")
            if slot.error is not None:
                raise slot.error
            assert slot.result is not None
            return slot.result

        with self._gate(key):
            with self._lock:
                if not pend.closed:
                    pend.closed = True
                    self._pending.pop(key, None)
            slots = pend.slots
            if self.metrics is not None:
                self.metrics.batcher_queue_depth.labels("generate").dec(len(slots))
                # the head-of-line stall, on the metric the continuous
                # engine records its slot wait on: decoding starts for every
                # joiner the moment its leader holds the gate
                now = time.monotonic()
                for sl in slots:
                    self.metrics.gen_admission_wait.labels("coalesce").observe(
                        max(0.0, now - sl.enqueue_t))
            try:
                if len(slots) == 1:
                    dev_t0 = time.monotonic()
                    out = self.runtime.generate(
                        model_id, slot.ids, prompt_lengths=list(slot.lengths),
                        max_new_tokens=slot.max_new, temperature=temperature,
                        top_k=top_k, seed=secrets.randbits(31),
                    )
                    dev_t1 = time.monotonic()
                    slot.result = out
                    wasted = self._observe_waste(model_id, [slot], slot.max_new)
                    self._finish_drain(model_id, [slot], slot.max_new, dev_t0, dev_t1, wasted)
                    return out
                with TRACER.span("generate_coalesce", model=str(model_id),
                                 requests=len(slots), rows=pend.rows):
                    s_max = max(sl.ids.shape[1] for sl in slots)
                    cat = np.concatenate(
                        [np.pad(sl.ids, ((0, 0), (0, s_max - sl.ids.shape[1]))) for sl in slots])
                    cat_len = np.concatenate([sl.lengths for sl in slots])
                    batch_max_new = max(sl.max_new for sl in slots)
                    dev_t0 = time.monotonic()
                    toks = self.runtime.generate(
                        model_id, cat, prompt_lengths=list(cat_len),
                        max_new_tokens=batch_max_new, temperature=temperature,
                        top_k=top_k, seed=secrets.randbits(31),
                    )
                    dev_t1 = time.monotonic()
                    self.batches += 1
                    self.batched_requests += len(slots)
                    if self.metrics is not None:
                        self.metrics.coalesced_batches.labels("generate").inc()
                        self.metrics.coalesced_requests.labels("generate").inc(len(slots))
                    lo = 0
                    for sl in slots:
                        hi = lo + sl.ids.shape[0]
                        sl.result = toks[lo:hi, : sl.max_new]
                        lo = hi
                    wasted = self._observe_waste(model_id, slots, batch_max_new)
                    self._finish_drain(model_id, slots, batch_max_new, dev_t0, dev_t1, wasted)
                assert slot.result is not None
                return slot.result
            except BaseException as e:
                for sl in slots:
                    if sl is not slot and sl.result is None and sl.error is None:
                        sl.error = e
                        sl.done.set()
                raise
            finally:
                for sl in slots:
                    if sl is not slot:
                        sl.done.set()

    def _observe_waste(self, model_id: ModelId, slots: list[_GenSlot],
                       batch_max_new: int) -> int:
        """Padded-step accounting after the drain: the batch decoded
        ``next_bucket(batch_max_new)`` steps for EVERY row, so a row past
        its EOS (when the model declares one) or its own max_new burned
        steps until the drain. An estimate where the runtime fell back to
        exact sizes on a bucket overshoot. -> the wasted steps (the flight
        ring records them too)."""
        eos = getattr(self.runtime, "eos_id_of", lambda _m: None)(model_id)
        steps = next_bucket(batch_max_new)
        wasted = 0
        for sl in slots:
            if sl.result is None:
                continue
            for row in np.asarray(sl.result):
                useful = row.shape[0]
                if eos is not None:
                    hits = np.flatnonzero(row == eos)
                    if hits.size:
                        useful = int(hits[0]) + 1
                wasted += steps - useful
        if wasted > 0 and self.metrics is not None:
            self.metrics.gen_wasted_steps.labels("coalesce").inc(wasted)
        return wasted

    def _finish_drain(self, model_id: ModelId, slots: list[_GenSlot], batch_max_new: int,
                      dev_t0: float, dev_t1: float, wasted: int) -> None:
        """The flight-ring entry, ledger step and phase clocks of one batch
        drain, the coalescer's counterpart of the continuous engine's chunk
        boundary: every member admits at the gate and retires at the drain.
        Phases: queue = the gate stall, decode = the batched generate
        (prefill is not separable inside it), respond = the scatter."""
        end_t = time.monotonic()
        rows = sum(sl.ids.shape[0] for sl in slots)
        # the batched call's wall time lands on the tenant as decode;
        # tokens_out leaves out the padded-step waste
        LEDGER.note_step(
            str(model_id), "coalesce",
            decode_s=max(0.0, dev_t1 - dev_t0),
            tokens_in=sum(sl.ids.shape[0] * sl.ids.shape[1] for sl in slots),
            tokens_out=max(0, rows * next_bucket(batch_max_new) - wasted),
        )
        RECORDER.record(
            str(model_id), "coalesce",
            step_ms=(dev_t1 - dev_t0) * 1e3,
            chunk=next_bucket(batch_max_new),
            active=rows, admitted=len(slots), retired=len(slots),
            wasted=wasted,
        )
        ids_ctx = current_ids()
        for sl in slots:
            phases = {
                "queue": max(0.0, dev_t0 - sl.enqueue_t),
                "decode": dev_t1 - dev_t0,
                "respond": max(0.0, end_t - dev_t1),
            }
            if self.metrics is not None:
                for ph, v in phases.items():
                    # the coalescer has no priority classes: class normal
                    self.metrics.observe_phase(ph, "coalesce", "normal", v)
            RECORDER.note_phases(str(model_id), "coalesce", phases,
                                 trace_id=ids_ctx[0] if ids_ctx else None)
        first_t = min(sl.enqueue_t for sl in slots)
        TRACER.annotate_root(
            priority="normal",
            # the first token materializes when the whole batch lands
            ttft_ms=round(max(0.0, dev_t1 - first_t) * 1e3, 3),
            phase_queue_ms=round(max(0.0, dev_t0 - first_t) * 1e3, 3),
            phase_decode_ms=round((dev_t1 - dev_t0) * 1e3, 3),
            phase_respond_ms=round(max(0.0, end_t - dev_t1) * 1e3, 3),
        )

# priority classes (REST "priority", default normal): admission and
# preemption compare ranks, and the smaller rank wins pages
PRIORITY_RANKS = {"high": 0, "normal": 1, "low": 2}


@dataclass
class _ContinuousReq:
    """One ROW of a continuous generate: rows admit and retire on their own."""

    prompt: np.ndarray                    # (P,) true prompt tokens
    max_new: int
    temperature: float
    top_k: int
    enqueue_t: float = field(default_factory=time.monotonic)
    done: threading.Event = field(default_factory=threading.Event)
    tokens: list[int] = field(default_factory=list)
    error: BaseException | None = None
    admitted_t: float | None = None
    first_tok_t: float | None = None
    finish_t: float | None = None
    prefill_s: float = 0.0                # prefill seconds, the phase clock's
    prefix_hit: bool = False              # the last admission reused parked or shared KV
    # crashes this row survived (scheduler thread only); past the engine's
    # max_recoveries it fails
    recoveries: int = 0
    # park at retirement, resume at admission (None = neither)
    conversation_id: str | None = None
    # tokens run through prefill over the row's life, every admission
    # (resumes and crash replays) included
    prefill_tokens: int = 0
    resumes: int = 0                      # admissions that resumed from parked pages
    # admission order: min (rank, seq); seq is engine-monotonic and survives
    # preemption and crash requeues
    priority: str = "normal"
    rank: int = 1
    seq: int = 0
    # per-token stream callback (single-row requests); one that raises is
    # dropped, never kills the scheduler
    on_token: Callable[[int], None] | None = None
    preemptions: int = 0                  # times parked off its lane
    # the ParkedConversation of a preemption, checked at re-admission before
    # the conversation tier
    preempt_parked: Any = None
    # chunked-prefill carry (reference :749): tokens of pf_prompt written so
    # far (None = not PREFILLING), the prompt being written (a recovered
    # row's emitted tokens included) and the first-token seed drawn at
    # admission
    pf_pos: int | None = None
    pf_prompt: np.ndarray | None = None
    pf_seed: int = 0


def _history(req: _ContinuousReq) -> np.ndarray:
    """The tokens whose K/V rows a retiring or preempted lane holds: the
    prompt + every emitted token but the last (the step that emits token j
    writes the row of token j - 1, so the last one's row was never
    written)."""
    if len(req.tokens) > 1:
        return np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
    return req.prompt


class _ContinuousScheduler:
    """One model's decode loop on a dedicated thread."""

    def __init__(self, engine: "ContinuousGenerateEngine", model_id: ModelId) -> None:
        self.engine = engine
        self.model_id = model_id
        self.cv = threading.Condition()
        self.pending: collections.deque[_ContinuousReq] = collections.deque()  # guarded-by: cv
        self.stopped = False  # guarded-by: cv
        self._spec_broken = False  # the configured draft cannot pair: stay plain
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name=f"tpusc-cdecode-{model_id.name}"
        )
        self.thread.start()

    def submit(self, reqs: list[_ContinuousReq]) -> None:
        with self.cv:
            if self.stopped:
                raise RuntimeError_("continuous generate engine is closed")
            self.pending.extend(reqs)
            if self.engine.metrics is not None:
                self.engine.metrics.batcher_queue_depth.labels("generate").inc(len(reqs))
            self.cv.notify()

    @staticmethod
    def _fail(reqs: list[_ContinuousReq], err: BaseException) -> None:
        for r in reqs:
            if r.error is None and not r.done.is_set():
                r.error = err
                r.done.set()

    def _triage(self, inflight: list[_ContinuousReq], queued: list[_ContinuousReq],
                err: BaseException) -> list[_ContinuousReq]:
        """Crash triage (reference :803): survivors (requeued into the
        replacement scheduler, interrupted rows first, so their order holds)
        and doomed rows (recovery off, or past a row's recovery budget),
        which fail with ``err``. Each survivor counts once in
        ``engine.recovered`` and in ``tpusc_requests_recovered{reason}``
        (``mid_decode`` for an interrupted row, ``queued`` for a row that
        only changes queues)."""
        eng = self.engine
        if queued and eng.metrics is not None:
            # survivors count again at their re-submit
            eng.metrics.batcher_queue_depth.labels("generate").dec(len(queued))
        if not eng.recovery:
            self._fail(inflight + queued, err)
            return []
        survivors: list[_ContinuousReq] = []
        doomed: list[_ContinuousReq] = []
        for reason, rows in (("mid_decode", inflight), ("queued", queued)):
            for r in rows:
                if r.done.is_set():
                    continue
                r.recoveries += 1
                if r.recoveries > eng.max_recoveries:
                    doomed.append(r)
                    continue
                # a row caught mid chunked prefill restarts from chunk 0 (the
                # crashed state's pages are gone)
                r.pf_pos = None
                r.pf_prompt = None
                survivors.append(r)
                if eng.metrics is not None:
                    eng.metrics.requests_recovered.labels(reason).inc()
        eng.recovered += len(survivors)
        self._fail(doomed, err)
        return survivors

    def _resolve_draft_id(self, rt: TorchModelRuntime, name: str) -> ModelId | None:
        """The ``spec_draft_model`` knob ("name" or "name@version") as a
        RESIDENT ModelId, newest version first for a bare name; None when
        nothing resident matches (reference :847)."""
        if "@" in name:
            base, _, ver = name.rpartition("@")
            try:
                want = ModelId(base, int(ver))
            except ValueError:
                return None
            return want if rt.is_loaded(want) else None
        best = None
        for mid in rt.resident_models():
            if mid.name == name and (best is None or mid.version > best.version):
                best = mid
        return best

    def _spec_setup(self, rt: TorchModelRuntime, state, lanes: list) -> None:
        """Attach (or detach) the configured draft on this scheduler's slot
        state (reference :866-920). Attach only with every lane idle: rows
        admitted while a draft is attached reserve and prefill BOTH arenas,
        so a mid-flight attach would leave live lanes without draft pages.
        A draft that is no longer resident detaches (plain chunks follow);
        a model never drafts for itself."""
        eng = self.engine
        if state.spec_draft is not None:
            if not rt.is_loaded(state.spec_draft_id):
                _detach(state)
            return
        if self._spec_broken or not state.paged:
            return
        name = eng.spec_draft_model
        if name is None:
            name = str(rt.cfg.spec_draft_model or "")
        if not name or any(r is not None for r in lanes):
            return
        draft_id = self._resolve_draft_id(rt, name)
        if draft_id is None or draft_id == self.model_id:
            return
        spec = eng.spec_tokens if eng.spec_tokens is not None else int(rt.cfg.spec_tokens)
        try:
            rt.slot_attach_draft(state, draft_id, spec)
            log.info("continuous spec attach model=%s draft=%s spec_tokens=%d",
                     self.model_id, draft_id, state.spec_tokens)
        except ModelNotLoadedError:
            pass  # evicted between resolve and attach: retry at a later boundary
        except RuntimeError_ as e:
            self._spec_broken = True
            log.warning("continuous spec disabled model=%s draft=%s: %s",
                        self.model_id, draft_id, e)

    def _loop(self) -> None:
        rt = self.engine.runtime
        lanes: list[_ContinuousReq | None] = [None] * self.engine.slots
        state = None
        while True:
            with self.cv:
                while (not self.pending and all(r is None for r in lanes)
                       and not self.stopped):
                    self.cv.wait()
                if self.stopped:
                    doomed = [r for r in lanes if r is not None] + list(self.pending)
                    self.pending.clear()
                    break
            try:
                state = self._step(rt, state, lanes)
            except Exception as e:  # noqa: BLE001 - triage the rows
                # eviction mid-decode, a device failure or an injected kill:
                # the slot state may hold poisoned K/V, so it is dropped.
                # With recovery on, the in-flight and queued rows move to a
                # FRESH scheduler, where admission re-prefills prompt +
                # tokens emitted so far; the rest fail with the error.
                log.exception("continuous scheduler for %s failed", self.model_id)
                with self.cv:
                    inflight = [r for r in lanes if r is not None]
                    queued = list(self.pending)
                    self.pending.clear()
                lanes = [None] * self.engine.slots
                survivors = self._triage(inflight, queued, e)
                RECORDER.dump(
                    "engine_crash", model=str(self.model_id), error=repr(e),
                    failed_rows=len(inflight) + len(queued) - len(survivors),
                    recovered_rows=len(survivors),
                )
                rt.drop_slot_state(self.model_id)
                state = None
                self.engine._set_active(self.model_id, 0)
                self.engine._set_pages(self.model_id, 0, 0)
                if survivors:
                    if self.engine._respawn(self, survivors) is not None:
                        return  # the replacement owns the model and the rows
                    self._fail(survivors, e)  # engine closing: nowhere to requeue
        self._fail(doomed, RuntimeError_("continuous generate engine closed"))
        self.engine._set_active(self.model_id, 0)
        self.engine._set_pages(self.model_id, 0, 0)

    def _pop_next(self) -> _ContinuousReq | None:
        """The pending row with the least (rank, seq): class first, FIFO
        inside a class (reference :1005). One class is the queue's head."""
        with self.cv:
            if not self.pending:
                return None
            best, req = min(enumerate(self.pending), key=lambda e: (e[1].rank, e[1].seq))
            del self.pending[best]
            if self.engine.metrics is not None:
                self.engine.metrics.batcher_queue_depth.labels("generate").dec()
            return req

    def _step(self, rt: TorchModelRuntime, state, lanes: list):
        """One chunk boundary: admit into free lanes, advance every
        PREFILLING lane by one prefill chunk, then advance all decoding
        lanes by one chunk or one speculative round. Runs only on
        self.thread. The rows that finish are released after the boundary
        is recorded (or fails), so a client that has its answer finds its
        last boundary in the flight recorder and the gauges."""
        finished: list[_ContinuousReq] = []
        try:
            return self._advance(rt, state, lanes, finished)
        finally:
            for r in finished:
                r.done.set()

    def _advance(self, rt: TorchModelRuntime, state, lanes: list,
                 finished: list[_ContinuousReq]):
        eng = self.engine
        # kill_engine raises here (the organic failure path through _loop);
        # freeze_scheduler sleeps this thread. Disarmed: one bool read.
        lab_faults.fire("engine_step", model=str(self.model_id))
        step_t0 = time.monotonic()
        eos = rt.eos_id_of(self.model_id)
        free = [i for i, r in enumerate(lanes) if r is None]
        # this boundary's tallies, for the ring entry and the ledger
        admitted_n = retired_n = prefix_hits_n = tokens_in_n = 0
        prefill_s_sum = 0.0
        if state is not None:
            # attach/detach before admission, so every row admitted below
            # sees the final spec configuration (its budget has the
            # draft's headroom iff the draft is on)
            self._spec_setup(rt, state, lanes)
        while free:
            req = self._pop_next()
            if req is None:
                break
            reserved = None
            d_st = None
            try:
                if state is None:
                    state = rt.slot_decode_state(self.model_id, eng.slots, **eng.state_knobs)
                    # fresh state: every lane is idle, the draft can attach now
                    self._spec_setup(rt, state, lanes)
                d_st = state.spec_draft
                prompt = req.prompt
                remaining = req.max_new - len(req.tokens)
                if req.tokens:
                    # a crash-recovered or preempted row: re-prefill prompt +
                    # the tokens emitted so far, so the next token continues
                    # the stream where it broke
                    prompt = np.concatenate([prompt, np.asarray(req.tokens, np.int32)])
                p = prompt.shape[0]
                if p + remaining > state.max_seq:
                    req.error = RuntimeError_(
                        f"prompt {p} + max_new_tokens {remaining} exceeds max_seq {state.max_seq}"
                    )
                    req.done.set()
                    continue
                plan = None
                resume = None  # (parked, covered, n_pages)
                share = state.prefix_index is not None
                if state.paged:
                    # the whole prompt + max_new budget up front, so a
                    # decoding row never starves for a page; with a draft
                    # the budget grows by spec_tokens of headroom (a round
                    # started one token short of max_new still writes rows
                    # at pos..pos+spec, on pages this row owns)
                    headroom = state.spec_tokens if d_st is not None else 0
                    budget = min(p + remaining + headroom,
                                 state.pages_per_slot * state.page_tokens)
                    need = state.pages_needed(budget)
                    if need > state.arena_pages:
                        req.error = RuntimeError_(
                            f"request needs {need} KV pages ({budget} tokens) but the "
                            f"arena has only {state.arena_pages}"
                        )
                        req.done.set()
                        continue
                    idx = free[-1]  # the lane free.pop() hands out below
                    t0 = time.monotonic()
                    resume = self._resume_plan(rt, state, req, prompt)
                    eng.resume_s += time.monotonic() - t0
                    shared_pages: list[int] = []
                    cow_headroom = 0
                    if share and resume is None:
                        plan = rt.shared_prefix_plan(state, prompt)
                        if plan is not None:
                            # map the indexed prefix read-only, reserve only
                            # the private rest; an exact hit with a mid-page
                            # tail also needs one page in hand for the CoW of
                            # its boundary page (its first decode write)
                            shared_pages = plan.mapped_pages()
                            if plan.kind == "exact" and plan.tail_len > 0:
                                cow_headroom = 1
                    ok = self._reserve(state, d_st, idx, budget, shared_pages, cow_headroom)
                    if not ok and share:
                        # page pressure: cold index-only pages lose to a live
                        # admission (the plan's own pages protected), or
                        # sharing would turn blocking into a deadlock
                        want = (max(0, need - len(shared_pages)) + cow_headroom
                                - len(state.free_pages))
                        if want > 0 and rt.reclaim_prefix_pages(state, want, shared_pages):
                            ok = self._reserve(state, d_st, idx, budget, shared_pages,
                                               cow_headroom)
                    while not ok:
                        # priority preemption: a higher class that still
                        # cannot reserve parks the lowest-class decoding lane
                        # and requeues it, then retries; one victim may not
                        # free enough
                        vidx = self._pick_victim(lanes, req)
                        if vidx is None or not self._preempt(rt, state, lanes, vidx):
                            break
                        free.insert(0, vidx)  # free[-1] (the lane reserved) stays
                        ok = self._reserve(state, d_st, idx, budget, shared_pages,
                                           cow_headroom)
                    if not ok:
                        # arena exhausted: the row waits at the head of its
                        # class (its seq keeps its place); retirements free
                        # pages for the next boundary. need <= arena_pages,
                        # and an idle engine's pages are free or
                        # reclaimable, so it always admits it.
                        with self.cv:
                            self.pending.appendleft(req)
                            if eng.metrics is not None:
                                eng.metrics.batcher_queue_depth.labels("generate").inc()
                        RECORDER.dump(
                            "page_exhaustion", model=str(self.model_id),
                            needed_pages=need, free_pages=len(state.free_pages),
                            arena_pages=state.arena_pages,
                        )
                        break
                    reserved = idx
                pf0 = time.monotonic()
                seed = secrets.randbits(31)
                if (reserved is not None and eng.prefill_chunk_tokens > 0 and resume is None
                        and plan is None and d_st is None and p > eng.prefill_chunk_tokens):
                    # chunked prefill (reference :1227-1263): pages reserved,
                    # nothing written yet. The lane sits inactive with pos
                    # past its table, so a decode chunk's frozen rewrite of
                    # it lands on the trash page, never on the rows the
                    # chunks fill; _prefill_phase advances it one chunk per
                    # boundary. Resumes, shared hits and draft engines keep
                    # the one-dispatch prefill.
                    idx = free.pop()
                    req.pf_prompt = prompt
                    req.pf_pos = 0
                    req.pf_seed = seed
                    now = time.monotonic()
                    req.admitted_t = now
                    state.active[idx] = False
                    state.pos[idx] = state.pages_per_slot * state.page_tokens
                    state.temps[idx] = req.temperature
                    state.topks[idx] = req.top_k
                    lanes[idx] = req
                    eng.admitted += 1
                    admitted_n += 1
                    if eng.metrics is not None:
                        eng.metrics.gen_admission_wait.labels("continuous").observe(
                            max(0.0, now - req.enqueue_t))
                    continue
                if resume is not None:
                    # suffix-only prefill over the re-imported parked pages
                    t0 = time.monotonic()
                    tok, pk, pv, last = rt.slot_resume_prefill(
                        self.model_id, state, reserved, prompt, resume[0], resume[1],
                        resume[2], req.temperature, req.top_k, seed,
                    )
                    eng.resume_s += time.monotonic() - t0
                    kind = "resume"
                    req.preempt_parked = None
                else:
                    tok, pk, pv, kind, last = rt.slot_prefill_shared(
                        self.model_id, state, prompt, req.temperature, req.top_k, seed, plan,
                    )
                d_pk = d_pv = None
                if d_st is not None and reserved is not None:
                    # greedy draft prefill: only the draft's K/V rows matter
                    # (on an exact or resumed target too: the draft has
                    # neither an index nor parked pages)
                    _, d_pk, d_pv = rt.slot_prefill(state.spec_draft_id, prompt, 0.0, 0,
                                                    seed=seed)
            except BaseException as e:  # noqa: BLE001 - out of pending, not yet in lanes
                if reserved is not None:
                    _release(state, d_st, reserved)
                self._fail([req], e)
                raise
            now = time.monotonic()
            req.prefill_s = now - pf0
            req.admitted_t = now
            if req.first_tok_t is None:
                # a recovered row keeps its first-token stamp: the client saw
                # its first token before the crash
                req.first_tok_t = now
            req.prefix_hit = kind != "miss"
            self._emit(req, int(tok))
            eng.admitted += 1
            admitted_n += 1
            prefill_s_sum += req.prefill_s
            tokens_in_n += p
            m = eng.metrics
            if req.prefix_hit:
                prefix_hits_n += 1
                if m is not None:
                    # exact = no prefill; resume = parked pages re-imported;
                    # shared = a radix partial hit or a prefix-cache reuse
                    m.gen_prefix_hits.labels(
                        "continuous", kind if kind in ("exact", "resume") else "shared").inc()
            if m is not None:
                m.gen_admission_wait.labels("continuous").observe(max(0.0, now - req.enqueue_t))
            if kind == "exact":
                eng.prefix_hits_exact += 1  # no prefill at all
                n_pf = 0
            elif kind == "resume":
                eng.resumes += 1
                req.resumes += 1
                n_pf = p - resume[1]
            elif kind == "shared":
                eng.prefix_hits_shared += 1
                n_pf = p - plan.covered
            else:  # "dense" (a prefix-cache hit; counted whole, as the reference does) or "miss"
                if kind == "dense":
                    eng.prefix_hits_dense += 1
                n_pf = p
            req.prefill_tokens += n_pf
            eng.prefill_tokens += n_pf
            if (eos is not None and int(tok) == eos) or remaining <= 1:
                # done at prefill: the lane was never used, and its pages
                # hold no K/V of this row (the insert comes below), so
                # nothing is parked
                if reserved is not None:
                    self._observe_waste(state, reserved, req)
                    _release(state, d_st, reserved)
                req.finish_t = now
                finished.append(req)
                retired_n += 1
                continue
            idx = free.pop()
            if pk is None:
                # exact hit: the prompt's K/V is in the mapped pages, nothing
                # to insert. Its first decode write (pos = p) lands inside
                # the SHARED boundary page, which is copied now, while the
                # headroom page reserved for it is still free
                if plan.tail_len > 0:
                    rt.slot_cow(state, idx, plan.n_full)
            elif kind == "resume":
                # suffix-only insert: the rows below the resume boundary hold
                # the parked bytes already
                rt.slot_admit(state, idx, pk, pv, base_tokens=resume[1])
            elif kind == "shared":
                # suffix-only insert: rows below the boundary stay in the
                # read-only mapped pages (their scatter goes to the trash page)
                rt.slot_admit(state, idx, pk, pv, base_tokens=plan.covered)
            else:
                rt.slot_admit(state, idx, pk, pv)
            if share and pk is not None:
                # publish this lane's prompt pages for later same-prefix
                # admissions (an exact hit is indexed already)
                rt.shared_prefix_publish(state, idx, prompt, last)
            if d_pk is not None:
                rt.slot_admit(d_st, idx, d_pk, d_pv)  # the draft lane rides the same index
            state.tok[idx] = int(tok)
            state.pos[idx] = p
            state.active[idx] = True
            state.temps[idx] = req.temperature
            state.topks[idx] = req.top_k
            lanes[idx] = req
        if admitted_n:
            eng._set_active(self.model_id, sum(r is not None for r in lanes))
        pf_chunks = 0
        if state is not None and eng.prefill_chunk_tokens > 0:
            pf_chunks, pf_toks, pf_s, pf_retired = self._prefill_phase(rt, state, lanes, eos,
                                                                       finished)
            retired_n += pf_retired
            prefill_s_sum += pf_s
            tokens_in_n += pf_toks
            if pf_retired:
                eng._set_active(self.model_id, sum(r is not None for r in lanes))
        self._update_page_gauge(state)
        live = [r for r in lanes if r is not None and r.pf_pos is None]
        if not live:
            if admitted_n or retired_n or pf_chunks:
                # a prefill-only boundary (every admitted row done at its
                # first token, or every lane still PREFILLING): a ring entry
                # with no chunk dispatched
                self._record_step(state, 0, 0, admitted_n, retired_n, 0, step_t0,
                                  prefix_hits_n, prefill_s_sum, tokens_in_n)
            return state
        # the pow2 cover of the largest remaining budget trims the overshoot
        max_remaining = max(r.max_new - len(r.tokens) for r in live)
        chunk = max(1, min(eng.chunk_tokens, next_bucket(max_remaining)))
        d_st = state.spec_draft
        use_spec = (
            d_st is not None
            and rt.is_loaded(state.spec_draft_id)
            and rt._spec_admit(self.model_id, state.spec_draft_id)
            # a round without a greedy lane is pure draft overhead (every
            # sampled lane accepts 0): decode plain instead
            and any(r is not None and float(state.temps[i]) <= 0.0
                    for i, r in enumerate(lanes))
        )
        if state.paged:
            # copy-on-write safety net (reference :1448-1469): no lane may
            # write a page it does not own alone. Admission already copied
            # the one shareable write target (an exact hit's boundary page)
            # and a chunk only advances into the lane's private pages, so
            # this never fires by design; a spec round writes rows at
            # pos..pos+spec, so every page of that span is covered
            span = state.spec_tokens if use_spec else 0
            for cidx, creq in enumerate(lanes):
                if creq is None:
                    continue
                first = int(state.pos[cidx]) // state.page_tokens
                last = min((int(state.pos[cidx]) + span) // state.page_tokens,
                           state.pages_per_slot - 1)
                for slot in range(first, last + 1):
                    pg = int(state.block_tables[cidx, slot])
                    if pg and int(state.page_refs[pg]) > 1:
                        rt.slot_cow(state, cidx, slot)
        accept = None
        if use_spec:
            try:
                with torch.profiler.record_function("tpusc.spec_round"):
                    toks, accept = rt.slot_decode_spec_round(state)
            except ModelNotLoadedError as e:
                if not rt.is_loaded(self.model_id):
                    raise
                # the draft was evicted since the residency check: detach
                # and decode plain (the round failed before any update)
                log.info("continuous spec detach model=%s (%s)", self.model_id, e)
                _detach(state)
        if accept is None:
            with torch.profiler.record_function("tpusc.decode_chunk"):
                toks = rt.slot_decode_chunk(state, chunk)
            eng.decode_steps += chunk
            eng.lane_steps += chunk * len(live)
        else:
            eng.spec_rounds += 1
            eng.drafted += state.spec_tokens * len(live)
            eng.accepted += int(accept.sum())
            # a round emits up to spec_tokens + 1 tokens a lane: that is its chunk
            chunk = state.spec_tokens + 1
        eng.chunks += 1
        now = time.monotonic()
        wasted = 0
        drafted = state.spec_tokens * len(live) if accept is not None else 0
        accepted = int(accept.sum()) if accept is not None else 0
        for idx, req in enumerate(lanes):
            if req is None or req.pf_pos is not None:
                continue
            # a round emits a variable prefix per lane (the accepted draft
            # run + the verify's correction token); a chunk emits `chunk`
            n_emit = chunk if accept is None else int(accept[idx])
            for j in range(n_emit):
                t = int(toks[idx, j])
                self._emit(req, t)
                if (eos is not None and t == eos) or len(req.tokens) >= req.max_new:
                    # retire now: the chunk's later steps for this row were
                    # overshoot (< chunk, the waste continuous batching
                    # bounds); under spec this drops accepted tokens past a
                    # mid-round EOS
                    wasted += n_emit - (j + 1)
                    state.active[idx] = False
                    lanes[idx] = None
                    if state.paged:
                        self._retire_pages(rt, state, idx, req)
                    req.finish_t = now
                    finished.append(req)
                    retired_n += 1
                    break
        if wasted and eng.metrics is not None:
            eng.metrics.gen_wasted_steps.labels("continuous").inc(wasted)
        if accept is not None:
            # acceptance health: one verify round per active lane
            rt._spec_observe(self.model_id, state.spec_draft_id, accepted, len(live),
                             engine="continuous")
        eng._set_active(self.model_id, sum(r is not None for r in lanes))
        self._update_page_gauge(state)
        self._record_step(state, chunk, len(live), admitted_n, retired_n, wasted, step_t0,
                          prefix_hits_n, prefill_s_sum, tokens_in_n, drafted=drafted,
                          accepted=accepted, emitted=accepted if accept is not None else None)
        return state

    def _record_step(self, state, chunk: int, active: int, admitted: int, retired: int,
                     wasted: int, step_t0: float, prefix_hits: int = 0, prefill_s: float = 0.0,
                     tokens_in: int = 0, drafted: int = 0, accepted: int = 0,
                     emitted: int | None = None) -> None:
        """One flight-recorder ring entry per boundary, the ledger's step,
        and the oldest-queued-age gauge (reference :1543-1597; admission
        wait is observed only at admission, so a row starving behind page
        exhaustion shows here first). ``step_ms`` is the boundary's host
        wall time, from the fault hook's return to now."""
        eng = self.engine
        with self.cv:
            depth = len(self.pending)
            oldest_t = self.pending[0].enqueue_t if depth else None
        wait_ms = 0.0 if oldest_t is None else max(0.0, (time.monotonic() - oldest_t) * 1e3)
        if eng.metrics is not None:
            eng.metrics.gen_oldest_queued_age.labels("continuous").set(wait_ms / 1e3)
        paged = state is not None and state.paged
        shared = state.page_stats()["shared"] if paged else 0
        now = time.monotonic()
        # the whole boundary lands on this tenant (a scheduler is
        # single-model); tokens_out = one first token per admission + the
        # tokens that reached live rows (the overshoot is the engine's cost)
        LEDGER.note_step(
            str(self.model_id), "continuous",
            prefill_s=prefill_s,
            decode_s=max(0.0, (now - step_t0) - prefill_s),
            tokens_in=tokens_in,
            tokens_out=admitted + max(0, (active * chunk if emitted is None else emitted) - wasted),
            queue_depth=depth,
        )
        RECORDER.record(
            str(self.model_id), "continuous",
            step_ms=(now - step_t0) * 1e3,
            chunk=chunk, active=active, admitted=admitted, retired=retired,
            pages_used=state.arena_pages - len(state.free_pages) if paged else 0,
            pages_free=len(state.free_pages) if paged else 0,
            wasted=wasted, queue_depth=depth, oldest_wait_ms=wait_ms,
            pages_shared=shared, prefix_hits=prefix_hits,
            drafted=drafted, accepted=accepted,
        )

    def _update_page_gauge(self, state) -> None:
        """Distinct pages held (shared + private: a prefix page mapped by
        N lanes counts once, index-only pages are reclaimable and left out)."""
        if state is not None and state.paged:
            ps = state.page_stats()
            self.engine._set_pages(self.model_id, ps["shared"] + ps["private"],
                                   state.arena_pages, ps["shared"])

    def _observe_waste(self, state, idx: int, req: _ContinuousReq) -> None:
        """``tpusc_gen_kv_page_waste_tokens`` of a retiring row: reserved
        capacity minus the tokens that occupied it (prompt + emitted)."""
        if self.engine.metrics is not None and state.paged:
            cap = state.lane_capacity(idx)
            used = req.prompt.shape[0] + len(req.tokens)
            self.engine.metrics.gen_kv_page_waste.observe(max(0, cap - min(used, cap)))

    def _resume_plan(self, rt: TorchModelRuntime, state, req: _ContinuousReq,
                     prompt: np.ndarray) -> tuple | None:
        """(parked, covered, n_pages) when ``req`` can resume from parked
        pages (reference :1100-1129): its own preemption park first (it
        covers prompt + every emitted token but the last), then its
        conversation's parked turn. The tier lookup peeks, so a lane that
        crashes mid-decode can resume again from the same ancestor."""
        eng = self.engine
        if req.preempt_parked is not None:
            plan = rt.plan_conversation_resume(state, prompt, req.preempt_parked)
            if plan is not None:
                return (req.preempt_parked, *plan)
        if req.conversation_id and eng.conversation_tier is not None:
            parked, _outcome = eng.conversation_tier.get(req.conversation_id,
                                                         str(self.model_id))
            if parked is not None:
                plan = rt.plan_conversation_resume(state, prompt, parked)
                if plan is not None:
                    return (parked, *plan)
        return None

    @staticmethod
    def _reserve(state, d_st, idx: int, budget: int, shared_pages: list,
                 cow_headroom: int) -> bool:
        """Reserve ``idx``'s pages, and the draft arena's mirror of them (its
        pages all private, capped at its own table; its auto-sized arena
        covers every lane's table, so that succeeds whenever the lane is
        free). False with nothing held when either cannot."""
        if not state.reserve_pages(idx, budget, shared_pages, cow_headroom):
            return False
        if d_st is not None and not d_st.reserve_pages(
                idx, min(budget, d_st.pages_per_slot * d_st.page_tokens)):
            state.release_pages(idx)
            return False
        return True

    def _retire_pages(self, rt: TorchModelRuntime, state, idx: int,
                      req: _ContinuousReq) -> None:
        """Give a retiring row's pages back (the draft lane's too), parking
        them first when the row carries a conversation id and the engine has
        a tier (reference :1599): the export needs the lane's mapping. A
        failed park logs and goes on."""
        eng = self.engine
        self._observe_waste(state, idx, req)
        if req.conversation_id and eng.conversation_tier is not None:
            t0 = time.monotonic()
            try:
                parked = rt.park_lane(state, idx, _history(req))
                if parked is not None:
                    eng.conversation_tier.put(req.conversation_id, parked)
                    eng.parks += 1
            except Exception:  # noqa: BLE001 - parking is best-effort
                eng.park_failures += 1
                log.warning("conversation park failed for %s", req.conversation_id,
                            exc_info=True)
            eng.park_s += time.monotonic() - t0
        _release(state, state.spec_draft, idx)

    @staticmethod
    def _emit(req: _ContinuousReq, tok: int) -> None:
        """Append one emitted token and fire the row's stream callback. A
        callback that raises is dropped after one failure: a dead client
        connection must not take the scheduler thread down."""
        req.tokens.append(tok)
        cb = req.on_token
        if cb is not None:
            try:
                cb(tok)
            except Exception:  # noqa: BLE001 - client callback, not engine state
                req.on_token = None

    def _pick_victim(self, lanes: list, req: _ContinuousReq) -> int | None:
        """The preemption target for ``req`` (reference :1722): the
        decoding lane of the largest rank strictly above the arrival's, the
        newest submit of it — admission's order reversed. PREFILLING lanes
        and lanes out of preemption budget are exempt."""
        best = None
        for li, lreq in enumerate(lanes):
            if lreq is None or lreq.pf_pos is not None or lreq.rank <= req.rank:
                continue
            if lreq.preemptions >= self.engine.preempt_limit:
                continue
            if best is None or (lreq.rank, lreq.seq) > (lanes[best].rank, lanes[best].seq):
                best = li
        return best

    def _preempt(self, rt: TorchModelRuntime, state, lanes: list, vidx: int) -> bool:
        """Park one decoding lane and requeue its row (reference :1745). The
        parked pages are COPIES: the lane releases its pages through the
        free list as at retirement, so the census stays exact. False when
        the lane cannot be parked (a dense state, a failed export): the
        caller stops hunting victims."""
        eng = self.engine
        victim = lanes[vidx]
        t0 = time.monotonic()
        try:
            parked = rt.park_lane(state, vidx, _history(victim))
        except Exception:  # noqa: BLE001 - the lane keeps running
            eng.park_failures += 1
            log.warning("preemption park failed for lane %d of %s", vidx, self.model_id,
                        exc_info=True)
            return False
        if parked is None:
            return False
        victim.preempt_parked = parked
        victim.preemptions += 1
        state.active[vidx] = False
        _release(state, state.spec_draft, vidx)
        lanes[vidx] = None
        with self.cv:
            self.pending.append(victim)
            if eng.metrics is not None:
                eng.metrics.batcher_queue_depth.labels("generate").inc()
        if eng.metrics is not None:
            eng.metrics.gen_preemptions.labels(victim.priority).inc()
        eng.preemptions += 1
        eng.preempt_park_s += time.monotonic() - t0
        # every preemption leaves a phase note with its park's cost
        RECORDER.note_phases(str(self.model_id), "continuous",
                             {"preempt_park": time.monotonic() - t0})
        log.info("preempted lane %d of %s (class=%s, %d tokens emitted, preemption %d/%d)",
                 vidx, self.model_id, victim.priority, len(victim.tokens), victim.preemptions,
                 eng.preempt_limit)
        return True

    def _prefill_phase(self, rt: TorchModelRuntime, state, lanes: list, eos,
                       finished: list[_ContinuousReq]) -> tuple[int, int, float, int]:
        """Advance every PREFILLING lane by exactly ONE chunk (reference
        :1658-1720). The last chunk samples the row's first token under the
        seed drawn at admission (a monolithic prefill's draw), publishes
        the prompt's pages when sharing is on, and activates the lane for
        the next decode chunk, or retires it on EOS / its last token.
        -> (chunks run, tokens written, prefill seconds, rows retired)."""
        eng = self.engine
        size = eng.prefill_chunk_tokens
        chunks = toks_in = retired = 0
        prefill_s = 0.0
        for idx, req in enumerate(lanes):
            if req is None or req.pf_pos is None:
                continue
            prompt = req.pf_prompt
            p = prompt.shape[0]
            t0 = time.monotonic()
            n = min(size, p - req.pf_pos)
            last = rt.slot_prefill_chunk(self.model_id, state, idx,
                                         prompt[req.pf_pos:req.pf_pos + n], req.pf_pos, size)
            req.pf_pos += n
            dt = time.monotonic() - t0
            req.prefill_s += dt
            prefill_s += dt
            toks_in += n
            chunks += 1
            eng.prefill_chunks += 1
            if eng.metrics is not None:
                eng.metrics.gen_prefill_chunks.inc()
            if req.pf_pos < p:
                continue
            tok = rt.sample_first_token(last, req.temperature, req.top_k, req.pf_seed)
            now = time.monotonic()
            if req.first_tok_t is None:
                req.first_tok_t = now
            req.prefill_tokens += p
            eng.prefill_tokens += p
            req.pf_pos = None
            req.pf_prompt = None
            remaining = req.max_new - len(req.tokens)
            self._emit(req, int(tok))
            if state.prefix_index is not None:
                # the publish a one-dispatch cold prefill makes, at the last chunk
                rt.shared_prefix_publish(state, idx, prompt, last)
            if (eos is not None and int(tok) == eos) or remaining <= 1:
                lanes[idx] = None
                self._retire_pages(rt, state, idx, req)
                req.finish_t = now
                finished.append(req)
                retired += 1
                continue
            state.tok[idx] = int(tok)
            state.pos[idx] = p
            state.active[idx] = True
        return chunks, toks_in, prefill_s, retired


def _detach(state) -> None:
    """Drop the draft from a slot state: plain chunks from here on."""
    state.spec_draft = None
    state.spec_draft_id = None
    state.spec_tokens = 0


def _release(state, d_st, idx: int) -> None:
    """Give a lane's pages back, the draft lane's too."""
    state.release_pages(idx)
    if d_st is not None:
        d_st.release_pages(idx)


class ContinuousGenerateEngine:
    """Continuous batching for ``:generate`` (``serving.generate_engine:
    "continuous"``): one scheduler thread and one slot state per model, and
    one conversation tier for the engine (parked turns survive scheduler
    crashes). Explicitly seeded requests (a reproducible solo stream),
    non-LM families and malformed parameters go to ``runtime.generate``."""

    def __init__(
        self,
        runtime: TorchModelRuntime,
        slots: int = 8,
        chunk_tokens: int = 8,
        wait_timeout_s: float = 600.0,
        page_tokens: int | None = None,
        arena_pages: int | None = None,
        arena_dtype: str | None = None,
        paged_kernel: bool | None = None,
        spec_draft_model: str | None = None,
        spec_tokens: int | None = None,
        share_prefix_bytes: int | None = None,
        prefill_chunk_tokens: int | None = None,
        metrics: Any = None,
    ) -> None:
        self.runtime = runtime
        self.metrics = metrics
        cfg = runtime.cfg
        self.slots = max(1, int(slots))
        self.chunk_tokens = max(1, int(chunk_tokens))
        self.wait_timeout_s = wait_timeout_s
        # slot_decode_state's knobs; one left None defers to the runtime's
        # ServingConfig (kv_page_tokens, kv_arena_pages, kv_arena_dtype,
        # kv_paged_kernel, kv_share_prefix_bytes: 0 = sharing off)
        knobs = {"page_tokens": page_tokens, "arena_pages": arena_pages,
                 "arena_dtype": arena_dtype, "paged_kernel": paged_kernel,
                 "share_prefix_bytes": share_prefix_bytes}
        self.state_knobs = {k: v for k, v in knobs.items() if v is not None}
        # in-engine speculative decoding: None defers to the ServingConfig
        # (serving.spec_draft_model / serving.spec_tokens), "" = off; the
        # draft is "name" (newest resident version) or "name@version"
        self.spec_draft_model = None if spec_draft_model is None else str(spec_draft_model)
        self.spec_tokens = None if spec_tokens is None else int(spec_tokens)
        # chunked prefill: None defers to serving.prefill_chunk_tokens, 0 =
        # off; clamped UP to a power of two (reference :1948)
        pf = (int(cfg.prefill_chunk_tokens) if prefill_chunk_tokens is None
              else int(prefill_chunk_tokens))
        self.prefill_chunk_tokens = next_bucket(pf) if pf > 0 else 0
        # crash recovery (serving.generate_recovery / generate_max_recoveries,
        # read from the ServingConfig only): the budget is per row
        self.recovery = bool(cfg.generate_recovery)
        self.max_recoveries = max(0, int(cfg.generate_max_recoveries))
        # the conversation tier (serving.conversation_kv_bytes & co., read
        # from the ServingConfig only; 0 bytes = off)
        self.conversation_tier = None
        if int(cfg.conversation_kv_bytes) > 0:
            self.conversation_tier = ConversationKVTier(
                int(cfg.conversation_kv_bytes),
                disk_capacity_bytes=int(cfg.conversation_kv_disk_bytes),
                disk_dir=str(cfg.conversation_kv_dir),
                metrics=metrics,
            )
        # preemptions a row may take; past it the row decodes to its end
        # whatever class arrives (bounded starvation)
        self.preempt_limit = 2
        self._lock = threading.Lock()
        self._scheds: dict[ModelId, _ContinuousScheduler] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # engine-monotonic submit sequence: the FIFO half of (rank, seq)
        self._seq = 0  # guarded-by: _lock
        # occupied lanes and (used, total, shared) pages per model, summed
        # into the node-wide gauges
        self._active: dict[ModelId, int] = {}  # guarded-by: _lock
        self._pages: dict[ModelId, tuple[int, int, int]] = {}  # guarded-by: _lock
        self.peak_active = 0
        # counters (scheduler threads write, tests and chip_smoke.py read)
        self.admitted = 0
        self.chunks = 0
        self.decode_steps = 0  # sum of every plain chunk's size
        self.lane_steps = 0    # sum over plain chunks of chunk size x active lanes
        self.spec_rounds = 0   # speculative rounds (each also counts in chunks)
        self.drafted = 0       # spec_tokens x active lanes, summed over rounds
        self.accepted = 0      # tokens the rounds emitted (accepted + correction)
        self.prefill_chunks = 0      # chunked-prefill chunks run (each n_layers B3 launches)
        self.prefill_tokens = 0      # prompt tokens prefilled (hits and resumes skip theirs)
        self.prefix_hits_exact = 0   # radix hits of a whole prompt: no prefill
        self.prefix_hits_shared = 0  # radix hits of a page-aligned prefix: suffix prefill
        self.prefix_hits_dense = 0   # prefix-cache (serving.prefix_cache_bytes) hits
        self.resumes = 0             # admissions from parked pages (preemption or tier)
        self.parks = 0               # conversations parked at retirement
        self.park_failures = 0       # parks (retirement or preemption) that raised
        self.preemptions = 0         # lanes parked off for a higher class
        self.preempt_park_s = 0.0    # host seconds in preemption parks
        # host seconds the scheduler thread spends, every lane waiting, in
        # retirement parks (the copy to host and the tier's put, with any
        # spill it makes) and in resumes (the plan with the tier's lookup
        # and any read-back from disk, and the import with the suffix
        # prefill's launch)
        self.park_s = 0.0
        self.resume_s = 0.0
        self.recovered = 0           # rows requeued by crash recovery (once a crash)

    def _set_active(self, model_id: ModelId, n: int) -> None:
        with self._lock:
            if n:
                self._active[model_id] = n
            else:
                self._active.pop(model_id, None)
            total = sum(self._active.values())
            self.peak_active = max(self.peak_active, total)
        if self.metrics is not None:
            # per model with model_labels, one all_models total otherwise
            label = self.metrics.model_label(model_id.name, model_id.version)
            self.metrics.gen_slots_active.labels(label).set(
                n if self.metrics.model_labels else total)

    def _set_pages(self, model_id: ModelId, used: int, total: int, shared: int = 0) -> None:
        with self._lock:
            if total:
                self._pages[model_id] = (used, total, shared)
            else:
                self._pages.pop(model_id, None)
            used_sum = sum(u for u, _, _ in self._pages.values())
            total_sum = sum(t for _, t, _ in self._pages.values())
            shared_sum = sum(sh for _, _, sh in self._pages.values())
        peak = RECORDER.observe_watermark("gen_kv_pages_used", float(used_sum))
        # the tenant's distinct-page level and the arena's, stamped together
        LEDGER.gauge_set(str(model_id), "kv_pages", used)
        LEDGER.note_arena(used_sum)
        if self.metrics is not None:
            self.metrics.gen_kv_pages_used.set(used_sum)
            self.metrics.gen_kv_pages_total.set(total_sum)
            self.metrics.gen_kv_pages_used_peak.set(peak)
            self.metrics.gen_kv_pages_shared.set(shared_sum)

    def _sched(self, model_id: ModelId) -> _ContinuousScheduler:
        with self._lock:
            if self._closed:
                raise RuntimeError_("continuous generate engine is closed")
            s = self._scheds.get(model_id)
            if s is None or not s.thread.is_alive():
                s = self._scheds[model_id] = _ContinuousScheduler(self, model_id)
            return s

    def _respawn(self, old: _ContinuousScheduler,
                 survivors: list[_ContinuousReq]) -> _ContinuousScheduler | None:
        """Crash recovery, from ``old``'s dying thread (reference :2031):
        swap in a fresh scheduler for the model and requeue the surviving
        rows in order. None when the engine is closing or ``old`` was
        already replaced; the caller then fails the rows."""
        with self._lock:
            if self._closed or self._scheds.get(old.model_id) is not old:
                return None
            fresh = self._scheds[old.model_id] = _ContinuousScheduler(self, old.model_id)
        with old.cv:
            # a submit that raced the swap through a stale reference may
            # have queued rows on the corpse: carry them over, and stop it
            # so that later stale submits raise
            old.stopped = True
            late = list(old.pending)
            old.pending.clear()
        if late and self.metrics is not None:
            # counted at their first submit; fresh.submit counts them again
            self.metrics.batcher_queue_depth.labels("generate").dec(len(late))
        rows = survivors + late
        try:
            fresh.submit(rows)
        except RuntimeError_ as e:  # closed between the swap and the submit
            fresh._fail(rows, e)
            return None
        log.warning("continuous scheduler for %s respawned after a crash: %d rows requeued "
                    "(%d interrupted mid-decode)", old.model_id, len(rows),
                    sum(1 for r in survivors if r.tokens))
        return fresh

    def generate(
        self,
        model_id: ModelId,
        input_ids: np.ndarray,
        prompt_lengths: list[int] | None = None,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int | None = None,
        return_stats: bool = False,
        conversation_id: str | None = None,
        priority: str = "normal",
        on_token: Callable[[int], None] | None = None,
    ):
        """(rows, max_new_tokens) int32, rows zero-padded after an EOS
        (reference batcher.py:2070). ``return_stats`` also returns a dict a
        row: ttft_s, admission_wait_s, tokens, prefill_tokens, priority,
        preemptions (the reference's) and resumes.

        ``priority`` ("high" | "normal" | "low") orders admission by class,
        then FIFO, and lets a higher class preempt a lower decoding lane
        when the arena is full; ignored on the solo path. ``on_token`` gets
        each emitted token the moment the scheduler appends it (single-row
        requests only; on the solo path the finished row is replayed through
        it). ``conversation_id`` parks the row's decode state at retirement
        and resumes the conversation's next turn from it; a multi-row call
        parks row r under ``"{id}#r{r}"``. A no-op without the tier, and on
        the solo path."""
        rank = PRIORITY_RANKS.get(str(priority or "normal"))
        if rank is None:
            raise ValueError(f"unknown priority {priority!r} (expected high|normal|low)")
        ids = np.asarray(input_ids, np.int32)
        # a runtime on a device group is one process, so it runs this engine
        # on its group's slot state as one device does, unless the group is
        # lockstep (serving.mesh_fast_path off): then every request runs
        # solo (the reference's rule, batcher.py:2117-2128)
        solo = (
            seed is not None
            or getattr(self.runtime, "mesh_lockstep", False)
            or ids.ndim != 2
            or not ids.size
            or self.runtime.family_of(model_id) != "transformer_lm"
        )
        lengths = None
        if not solo:
            rows, s = ids.shape
            if prompt_lengths is None:
                lengths = np.full((rows,), s, np.int32)
            else:
                lengths = np.asarray(prompt_lengths, np.int32)
                if lengths.shape != (rows,) or (lengths < 1).any() or (lengths > s).any():
                    solo = True  # the runtime raises its own clean error
            if not solo and (
                max_new_tokens < 1
                or not np.isfinite(temperature)
                or temperature < 0.0
                or top_k < 0
            ):
                solo = True
        if solo:
            out = self.runtime.generate(
                model_id, ids, prompt_lengths=prompt_lengths,
                max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
                seed=seed if seed is not None else secrets.randbits(31),
            )
            if on_token is not None and out.ndim == 2 and out.shape[0] == 1:
                # the stream's frames on the solo path: the finished row
                # replayed (a solo dispatch has no per-token boundary)
                for t in out[0, :max_new_tokens].tolist():
                    try:
                        on_token(int(t))
                    except Exception:  # noqa: BLE001 - client callback
                        break
            return (out, None) if return_stats else out
        cid = str(conversation_id) if conversation_id else None
        with self._lock:
            seq0 = self._seq
            self._seq += rows
        reqs = [
            _ContinuousReq(
                prompt=ids[r, : lengths[r]].copy(),
                max_new=int(max_new_tokens),
                temperature=float(temperature),
                top_k=int(top_k),
                conversation_id=None if cid is None else (cid if rows == 1 else f"{cid}#r{r}"),
                priority=str(priority or "normal"),
                rank=rank,
                seq=seq0 + r,
                on_token=on_token if rows == 1 else None,
            )
            for r in range(rows)
        ]
        self._sched(model_id).submit(reqs)
        deadline = time.monotonic() + self.wait_timeout_s
        for r in reqs:
            if not r.done.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(f"continuous generate for {model_id} timed out")
        for r in reqs:
            if r.error is not None:
                raise r.error
        out = np.zeros((rows, max_new_tokens), np.int32)
        for i, r in enumerate(reqs):
            t = np.asarray(r.tokens[:max_new_tokens], np.int32)
            out[i, : t.shape[0]] = t
        self._observe_phases(model_id, reqs, str(priority or "normal"))
        if not return_stats:
            return out
        stats = [
            {
                "ttft_s": (r.first_tok_t or r.enqueue_t) - r.enqueue_t,
                "admission_wait_s": (r.admitted_t or r.enqueue_t) - r.enqueue_t,
                "tokens": len(r.tokens[:max_new_tokens]),
                "prefill_tokens": r.prefill_tokens,
                "priority": r.priority,
                "preemptions": r.preemptions,
                "resumes": r.resumes,
            }
            for r in reqs
        ]
        return out, stats

    def _observe_phases(self, model_id: ModelId, reqs: list[_ContinuousReq],
                        priority: str) -> None:
        """Each row's phase clocks (reference :2207-2260), from the caller's
        thread once every row is done: queue ends where the row's prefill
        starts, decode runs first token -> finish, respond is the wait for
        batch-mates plus the output's assembly. They go into
        ``tpusc_request_phase_seconds`` and the recorder's phase notes; the
        worst row's land on the request's trace root."""
        end_t = time.monotonic()
        ids_ctx = current_ids()
        worst: dict[str, float] = {}
        for r in reqs:
            admitted = r.admitted_t or r.enqueue_t
            finish = r.finish_t or admitted
            phases = {
                "queue": max(0.0, admitted - r.enqueue_t - r.prefill_s),
                "prefill": r.prefill_s,
                "decode": max(0.0, finish - (r.first_tok_t or admitted)),
                "respond": max(0.0, end_t - finish),
            }
            if self.metrics is not None:
                for ph, v in phases.items():
                    self.metrics.observe_phase(ph, "continuous", r.priority, v)
            for ph, v in phases.items():
                if v > worst.get(ph, -1.0):
                    worst[ph] = v
            RECORDER.note_phases(str(model_id), "continuous", phases,
                                 trace_id=ids_ctx[0] if ids_ctx else None)
        TRACER.annotate(
            gen_engine="continuous",
            gen_admission_wait_ms=round(
                1e3 * max((r.admitted_t or r.enqueue_t) - r.enqueue_t for r in reqs), 3),
            gen_prefix_hits=sum(1 for r in reqs if r.prefix_hit),
        )
        TRACER.annotate_root(
            priority=priority,
            ttft_ms=round(1e3 * max((r.first_tok_t or r.enqueue_t) - r.enqueue_t for r in reqs), 3),
            **{f"phase_{ph}_ms": round(v * 1e3, 3) for ph, v in worst.items()},
        )

    def close(self) -> None:
        """Fail the pending rows, join the scheduler threads and drop the
        conversation tier."""
        with self._lock:
            self._closed = True
            scheds = list(self._scheds.values())
            self._scheds.clear()
        for s in scheds:
            with s.cv:
                s.stopped = True
                s.cv.notify_all()
        for s in scheds:
            s.thread.join(timeout=30.0)
        if self.conversation_tier is not None:
            self.conversation_tier.close()
