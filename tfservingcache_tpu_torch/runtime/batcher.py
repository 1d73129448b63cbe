"""Iteration-level continuous batching for ``:generate``.

Counterpart of the base protocol of ``tfservingcache_tpu/runtime/batcher.py``
(``ContinuousGenerateEngine`` and its per-model scheduler, :699-1543 and
:1820-2272), selected with ``serving.generate_engine: "continuous"``. Each
model gets a scheduler thread over a fixed number of lanes (the runtime's
``SlotDecodeState``). At every chunk boundary it:
  - admits pending rows FIFO into free lanes: a whole-prompt
    ``slot_prefill`` samples the row's first token; on a paged arena the
    row's prompt + max_new budget is reserved first, a row that needs more
    pages than the arena has fails, and a row the free list cannot cover
    yet waits at the head of the queue;
  - advances every active lane by one decode chunk, clamped to
    ``max(1, min(chunk_tokens, next_bucket(max_remaining)))``;
  - retires rows the moment they emit EOS or reach their max_new, at the
    prefill and inside a chunk, and gives their pages back.
Seeded and malformed requests go to ``runtime.generate`` (the solo path).

Not ported yet: chunked prefill, shared-prefix KV, conversation KV,
speculative decoding, priority classes and preemption, crash recovery
(a scheduler exception fails the in-flight and queued rows and drops the
slot state), token streaming, metrics and the flight recorder.
"""

from __future__ import annotations

import collections
import logging
import secrets
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime, next_bucket
from tfservingcache_tpu_torch.types import ModelId

log = logging.getLogger("tpusc_torch.batcher")


@dataclass
class _ContinuousReq:
    """One ROW of a continuous generate: rows admit and retire on their own."""

    prompt: np.ndarray                    # (P,) true prompt tokens
    max_new: int
    temperature: float
    top_k: int
    done: threading.Event = field(default_factory=threading.Event)
    tokens: list[int] = field(default_factory=list)
    error: BaseException | None = None


class _ContinuousScheduler:
    """One model's decode loop on a dedicated thread."""

    def __init__(self, engine: "ContinuousGenerateEngine", model_id: ModelId) -> None:
        self.engine = engine
        self.model_id = model_id
        self.cv = threading.Condition()
        self.pending: collections.deque[_ContinuousReq] = collections.deque()  # guarded-by: cv
        self.stopped = False  # guarded-by: cv
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name=f"tpusc-cdecode-{model_id.name}"
        )
        self.thread.start()

    def submit(self, reqs: list[_ContinuousReq]) -> None:
        with self.cv:
            if self.stopped:
                raise RuntimeError_("continuous generate engine is closed")
            self.pending.extend(reqs)
            self.cv.notify()

    @staticmethod
    def _fail(reqs: list[_ContinuousReq], err: BaseException) -> None:
        for r in reqs:
            if r.error is None and not r.done.is_set():
                r.error = err
                r.done.set()

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
            except Exception as e:  # noqa: BLE001 - the rows get the error
                # eviction mid-decode or a device failure: the slot state may
                # hold poisoned K/V, so it is dropped, and every in-flight
                # and queued row fails with the error (no respawn here)
                log.exception("continuous scheduler for %s failed", self.model_id)
                with self.cv:
                    failed = [r for r in lanes if r is not None] + list(self.pending)
                    self.pending.clear()
                lanes = [None] * self.engine.slots
                self._fail(failed, e)
                rt.drop_slot_state(self.model_id)
                state = None
        self._fail(doomed, RuntimeError_("continuous generate engine closed"))

    def _step(self, rt: TorchModelRuntime, state, lanes: list):
        """One chunk boundary: admit into free lanes, then advance all
        active lanes by one chunk. Runs only on self.thread."""
        eng = self.engine
        eos = rt.eos_id_of(self.model_id)
        free = [i for i, r in enumerate(lanes) if r is None]
        while free:
            with self.cv:
                if not self.pending:
                    break
                req = self.pending.popleft()
            reserved = None
            try:
                if state is None:
                    state = rt.slot_decode_state(self.model_id, eng.slots, **eng.state_knobs)
                prompt = req.prompt
                p = prompt.shape[0]
                remaining = req.max_new
                if p + remaining > state.max_seq:
                    req.error = RuntimeError_(
                        f"prompt {p} + max_new_tokens {remaining} exceeds max_seq {state.max_seq}"
                    )
                    req.done.set()
                    continue
                if state.paged:
                    # the whole prompt + max_new budget up front: a decoding
                    # row never starves for a page
                    budget = min(p + remaining, state.pages_per_slot * state.page_tokens)
                    need = state.pages_needed(budget)
                    if need > state.arena_pages:
                        req.error = RuntimeError_(
                            f"request needs {need} KV pages ({budget} tokens) but the "
                            f"arena has only {state.arena_pages}"
                        )
                        req.done.set()
                        continue
                    idx = free[-1]  # the lane free.pop() hands out below
                    if not state.reserve_pages(idx, budget):
                        # arena exhausted: the row waits at the head of the
                        # queue (FIFO kept); retirements below free pages for
                        # the next boundary. need <= arena_pages, so an idle
                        # engine always admits it.
                        with self.cv:
                            self.pending.appendleft(req)
                        break
                    reserved = idx
                tok, pk, pv = rt.slot_prefill(
                    self.model_id, prompt, req.temperature, req.top_k,
                    seed=secrets.randbits(31),
                )
            except BaseException as e:  # noqa: BLE001 - out of pending, not yet in lanes
                if reserved is not None:
                    state.release_pages(reserved)
                self._fail([req], e)
                raise
            req.tokens.append(int(tok))
            eng.admitted += 1
            if (eos is not None and int(tok) == eos) or remaining <= 1:
                # done at prefill: the lane was never used
                if reserved is not None:
                    state.release_pages(reserved)
                req.done.set()
                continue
            idx = free.pop()
            rt.slot_admit(state, idx, pk, pv)
            state.tok[idx] = int(tok)
            state.pos[idx] = p
            state.active[idx] = True
            state.temps[idx] = req.temperature
            state.topks[idx] = req.top_k
            lanes[idx] = req
        live = [r for r in lanes if r is not None]
        if not live:
            return state
        # the pow2 cover of the largest remaining budget trims the overshoot
        max_remaining = max(r.max_new - len(r.tokens) for r in live)
        chunk = max(1, min(eng.chunk_tokens, next_bucket(max_remaining)))
        toks = rt.slot_decode_chunk(state, chunk)
        eng.chunks += 1
        eng.decode_steps += chunk
        eng.lane_steps += chunk * len(live)
        for idx, req in enumerate(lanes):
            if req is None:
                continue
            for j in range(chunk):
                t = int(toks[idx, j])
                req.tokens.append(t)
                if (eos is not None and t == eos) or len(req.tokens) >= req.max_new:
                    # retire now: the chunk's later steps for this row were
                    # overshoot (< chunk, the waste continuous batching bounds)
                    state.active[idx] = False
                    lanes[idx] = None
                    if state.paged:
                        state.release_pages(idx)
                    req.done.set()
                    break
        return state


class ContinuousGenerateEngine:
    """Continuous batching for ``:generate`` (``serving.generate_engine:
    "continuous"``): one scheduler thread and one slot state per model.
    Explicitly seeded requests (a reproducible solo stream), non-LM
    families and malformed parameters go to ``runtime.generate``."""

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
    ) -> None:
        self.runtime = runtime
        self.slots = max(1, int(slots))
        self.chunk_tokens = max(1, int(chunk_tokens))
        self.wait_timeout_s = wait_timeout_s
        # slot_decode_state's knobs; one left None defers to the runtime's
        # ServingConfig (kv_page_tokens, kv_arena_pages, kv_arena_dtype,
        # kv_paged_kernel)
        knobs = {"page_tokens": page_tokens, "arena_pages": arena_pages,
                 "arena_dtype": arena_dtype, "paged_kernel": paged_kernel}
        self.state_knobs = {k: v for k, v in knobs.items() if v is not None}
        self._lock = threading.Lock()
        self._scheds: dict[ModelId, _ContinuousScheduler] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # counters (scheduler threads write, tests and chip_smoke.py read)
        self.admitted = 0
        self.chunks = 0
        self.decode_steps = 0  # sum of every chunk's size
        self.lane_steps = 0    # sum over chunks of chunk size x active lanes

    def _sched(self, model_id: ModelId) -> _ContinuousScheduler:
        with self._lock:
            if self._closed:
                raise RuntimeError_("continuous generate engine is closed")
            s = self._scheds.get(model_id)
            if s is None or not s.thread.is_alive():
                s = self._scheds[model_id] = _ContinuousScheduler(self, model_id)
            return s

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
        """(rows, max_new_tokens) int32, rows zero-padded after an EOS
        (reference batcher.py:2070)."""
        ids = np.asarray(input_ids, np.int32)
        solo = (
            seed is not None
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
            return self.runtime.generate(
                model_id, ids, prompt_lengths=prompt_lengths,
                max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
                seed=seed if seed is not None else secrets.randbits(31),
            )
        reqs = [
            _ContinuousReq(
                prompt=ids[r, : lengths[r]].copy(),
                max_new=int(max_new_tokens),
                temperature=float(temperature),
                top_k=int(top_k),
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
        return out

    def close(self) -> None:
        """Fail the pending rows and join the scheduler threads."""
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
