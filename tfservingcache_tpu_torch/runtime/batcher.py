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
    ``max(1, min(chunk_tokens, next_bucket(max_remaining)))`` — or, with a
    draft model attached (``serving.spec_draft_model``), by one speculative
    draft/verify round in which each lane accepts a variable-length prefix;
  - retires rows the moment they emit EOS or reach their max_new, at the
    prefill and inside a chunk or round, and gives their pages back.
Seeded and malformed requests go to ``runtime.generate`` (the solo path).

Not ported yet: chunked prefill, shared-prefix KV, conversation KV,
priority classes and preemption, crash recovery (a scheduler exception
fails the in-flight and queued rows and drops the slot state), token
streaming, metrics and the flight recorder.
"""

from __future__ import annotations

import collections
import logging
import secrets
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from tfservingcache_tpu_torch.runtime.base import ModelNotLoadedError, RuntimeError_
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
            self.cv.notify()

    @staticmethod
    def _fail(reqs: list[_ContinuousReq], err: BaseException) -> None:
        for r in reqs:
            if r.error is None and not r.done.is_set():
                r.error = err
                r.done.set()

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
        active lanes by one chunk or one speculative round. Runs only on
        self.thread."""
        eng = self.engine
        eos = rt.eos_id_of(self.model_id)
        free = [i for i, r in enumerate(lanes) if r is None]
        if state is not None:
            # attach/detach before admission, so every row admitted below
            # sees the final spec configuration (its budget has the
            # draft's headroom iff the draft is on)
            self._spec_setup(rt, state, lanes)
        while free:
            with self.cv:
                if not self.pending:
                    break
                req = self.pending.popleft()
            reserved = None
            d_st = None
            try:
                if state is None:
                    state = rt.slot_decode_state(self.model_id, eng.slots, **eng.state_knobs)
                    # fresh state: every lane is idle, the draft can attach now
                    self._spec_setup(rt, state, lanes)
                d_st = state.spec_draft
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
                    ok = state.reserve_pages(idx, budget)
                    if ok and d_st is not None:
                        # the draft arena mirrors the reservation, capped at
                        # its own table (its auto-sized arena covers every
                        # lane's full table, so this succeeds whenever the
                        # lane is free)
                        d_budget = min(budget, d_st.pages_per_slot * d_st.page_tokens)
                        if not d_st.reserve_pages(idx, d_budget):
                            state.release_pages(idx)
                            ok = False
                    if not ok:
                        # arena exhausted: the row waits at the head of the
                        # queue (FIFO kept); retirements below free pages for
                        # the next boundary. need <= arena_pages, so an idle
                        # engine always admits it.
                        with self.cv:
                            self.pending.appendleft(req)
                        break
                    reserved = idx
                seed = secrets.randbits(31)
                tok, pk, pv = rt.slot_prefill(
                    self.model_id, prompt, req.temperature, req.top_k, seed=seed,
                )
                d_pk = d_pv = None
                if d_st is not None and reserved is not None:
                    # greedy draft prefill: only the draft's K/V rows matter
                    _, d_pk, d_pv = rt.slot_prefill(state.spec_draft_id, prompt, 0.0, 0,
                                                    seed=seed)
            except BaseException as e:  # noqa: BLE001 - out of pending, not yet in lanes
                if reserved is not None:
                    _release(state, d_st, reserved)
                self._fail([req], e)
                raise
            req.tokens.append(int(tok))
            eng.admitted += 1
            if (eos is not None and int(tok) == eos) or remaining <= 1:
                # done at prefill: the lane was never used
                if reserved is not None:
                    _release(state, d_st, reserved)
                req.done.set()
                continue
            idx = free.pop()
            rt.slot_admit(state, idx, pk, pv)
            if d_pk is not None:
                rt.slot_admit(d_st, idx, d_pk, d_pv)  # the draft lane rides the same index
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
        accept = None
        if use_spec:
            try:
                toks, accept = rt.slot_decode_spec_round(state)
            except ModelNotLoadedError as e:
                if not rt.is_loaded(self.model_id):
                    raise
                # the draft was evicted since the residency check: detach
                # and decode plain (the round failed before any update)
                log.info("continuous spec detach model=%s (%s)", self.model_id, e)
                _detach(state)
        if accept is None:
            toks = rt.slot_decode_chunk(state, chunk)
            eng.decode_steps += chunk
            eng.lane_steps += chunk * len(live)
        else:
            eng.spec_rounds += 1
            eng.drafted += state.spec_tokens * len(live)
            eng.accepted += int(accept.sum())
        eng.chunks += 1
        for idx, req in enumerate(lanes):
            if req is None:
                continue
            # a round emits a variable prefix per lane (the accepted draft
            # run + the verify's correction token); a chunk emits `chunk`
            n_emit = chunk if accept is None else int(accept[idx])
            for j in range(n_emit):
                t = int(toks[idx, j])
                req.tokens.append(t)
                if (eos is not None and t == eos) or len(req.tokens) >= req.max_new:
                    # retire now: the chunk's later steps for this row were
                    # overshoot (< chunk, the waste continuous batching
                    # bounds); under spec this drops accepted tokens past a
                    # mid-round EOS
                    state.active[idx] = False
                    lanes[idx] = None
                    if state.paged:
                        _release(state, state.spec_draft, idx)
                    req.done.set()
                    break
        if accept is not None:
            # acceptance health: one verify round per active lane
            rt._spec_observe(self.model_id, state.spec_draft_id, int(accept.sum()), len(live),
                             engine="continuous")
        return state


def _detach(state) -> None:
    """Drop the draft from a slot state: plain chunks from here on."""
    state.spec_draft = None
    state.spec_draft_id = None
    state.spec_tokens = 0


def _release(state, d_st, idx: int) -> None:
    """Give a retired or failed lane's pages back, the draft lane's too."""
    state.release_pages(idx)
    if d_st is not None:
        d_st.release_pages(idx)


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
        spec_draft_model: str | None = None,
        spec_tokens: int | None = None,
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
        # in-engine speculative decoding: None defers to the ServingConfig
        # (serving.spec_draft_model / serving.spec_tokens), "" = off; the
        # draft is "name" (newest resident version) or "name@version"
        self.spec_draft_model = None if spec_draft_model is None else str(spec_draft_model)
        self.spec_tokens = None if spec_tokens is None else int(spec_tokens)
        self._lock = threading.Lock()
        self._scheds: dict[ModelId, _ContinuousScheduler] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # counters (scheduler threads write, tests and chip_smoke.py read)
        self.admitted = 0
        self.chunks = 0
        self.decode_steps = 0  # sum of every plain chunk's size
        self.lane_steps = 0    # sum over plain chunks of chunk size x active lanes
        self.spec_rounds = 0   # speculative rounds (each also counts in chunks)
        self.drafted = 0       # spec_tokens x active lanes, summed over rounds
        self.accepted = 0      # tokens the rounds emitted (accepted + correction)

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
