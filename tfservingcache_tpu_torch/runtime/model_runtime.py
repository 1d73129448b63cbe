"""The PyTorch model runtime: artifact -> pinned host tensors -> GPU module.

Counterpart of ``tfservingcache_tpu/runtime/model_runtime.py`` for the
``:predict`` and ``:generate`` paths: the solo ``generate`` (greedy
speculative with ``draft_model_id``) and the slot surface the continuous
engine (``runtime/batcher.py``) drives, over a dense slot array or a paged
KV arena (``SlotDecodeState``), with an optional draft state for
speculative rounds (``slot_attach_draft`` / ``slot_decode_spec_round``).
A load reads ``params.bin`` in one sequential read into page-locked host
memory, copies every leaf to the device and wraps them in
the family's ``nn.Module``; resident models live in a byte-budgeted LRU
(capped at ``serving.max_concurrent_models``) whose eviction drops the
module so its device memory is freed. Variable request shapes are padded to
power-of-two buckets per named axis, as in the reference, so each model sees
O(log) distinct shapes.

The runtime runs on ``cuda`` unless constructed with ``device="cpu"``; with
no card and no explicit device it raises. Forwards run eagerly under
``torch.inference_mode()``.

A runtime constructed with ``devices=[...]`` is bound to that device group
(the reference's runtime on a chip-group mesh). ``devices[0]`` is the
leader: params load onto it alone, and a family with a ``bind_group``
factory (a ``"ring"`` transformer_lm) builds its module bound to the group,
so that each forward splits attention's sequence over the group's devices.
The reference replicates a ring model's weights on every chip of the group
(partition rule ``{".*": ()}``) and computes the projections redundantly on
each; the port computes them once on the leader and shards only attention,
with the same output. Everything else (``:generate``, the slot surface)
runs on the leader as before: the reference's generation never rings. A
family whose partition rules shard a weight (tensor parallelism) is refused
on a group of more than one device.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from tfservingcache_tpu_torch.cache.lru import LRUEntry, LRUCache
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models.registry import ModelDef, TensorSpec, load_artifact
from tfservingcache_tpu_torch.runtime.base import (
    BaseRuntime,
    ModelNotLoadedError,
    RuntimeError_,
)
from tfservingcache_tpu_torch.types import Model, ModelId, ModelState

log = logging.getLogger("tpusc_torch.runtime")

# Speculative-decoding health gate (reference :56-65): at acceptance ~0 every
# verify round still pays spec_tokens draft forwards + one chunked target
# forward to emit ONE token — more target work per token than plain decode.
# Below this tokens-per-round a sustained run of generates disables the
# (target, draft) pair; disabled pairs re-audition periodically.
SPEC_MIN_TOKENS_PER_ROUND = 1.5
SPEC_DISABLE_AFTER = 8      # consecutive low-acceptance generates
SPEC_REPROBE_EVERY = 64     # every Nth gated request runs the draft again
SPEC_TOKENS_MAX = 8         # spec_tokens clamps to a power of two <= this


def next_bucket(n: int) -> int:
    """Smallest power of two >= n (padding bucket)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_nbytes(tree: Any) -> int:
    total = 0

    def add(t: torch.Tensor) -> None:
        nonlocal total
        total += t.numel() * t.element_size()

    _tree_map(add, tree)
    return total


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the current CUDA device; without a card that raises
    instead of quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError_(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError_(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError_(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@dataclass
class LoadedModel:
    model_def: ModelDef
    module: torch.nn.Module
    nbytes: int


@dataclass
class SlotDecodeState:
    """Device + host state of one model's continuous-decode lanes
    (reference model_runtime.py:650-846). Dense mode (``page_tokens == 0``):
    ``k``/``v`` are the slot array ``(layers, S, n_kv, max_seq, hd)``, one
    lane per slot. Paged mode: ``k``/``v`` are the shared arena
    ``(layers, arena_pages + 1, n_kv, page_tokens, hd)`` — page 0 is the
    trash page — and each lane reads and writes through its
    ``block_tables`` row; the free list hands pages out at admission and
    takes them back at retirement. The host mirrors (tok/pos/active/temps/
    topks, block tables, free list) belong to the engine's scheduler
    thread; the runtime copies them to the device once per chunk."""

    model_id: ModelId
    slots: int
    max_seq: int
    k: torch.Tensor                  # slot array or paged arena, updated in place
    v: torch.Tensor
    tok: np.ndarray                  # (S,) i32 last sampled token per lane
    pos: np.ndarray                  # (S,) i32 next write position
    active: np.ndarray               # (S,) bool
    temps: np.ndarray                # (S,) f32 per-lane temperature
    topks: np.ndarray                # (S,) i32 per-lane top_k
    chunk_counter: int = 0           # seeds each chunk's generator
    page_tokens: int = 0
    arena_pages: int = 0             # usable pages (excludes trash page 0)
    pages_per_slot: int = 0          # ceil(max_seq / page_tokens)
    # int8 arena: per-row f32 scale buffers {"k", "v"} (None otherwise)
    scales: dict | None = None
    arena_dtype: str = ""            # "" = model dtype; "int8" = quantized
    kernel: bool = True              # serving.kv_paged_kernel
    block_tables: np.ndarray | None = None   # (S, pages_per_slot) i32
    free_pages: list = field(default_factory=list)
    lane_pages: dict = field(default_factory=dict)  # lane -> [page ids]
    page_refs: np.ndarray | None = None      # (arena_pages + 1,) i32 owners per page
    # in-engine speculative decoding (reference :703-712): the draft model's
    # own SlotDecodeState rides on the target's — same slot count and
    # page_tokens, its own arena/tables/free list/census — so every
    # scheduler reserve/release mirrors 1:1 onto the draft arena. Its
    # tok/pos/active host mirrors alias the target's (both caches advance
    # through the same accepted positions). None = spec off.
    spec_draft_id: ModelId | None = None
    spec_draft: SlotDecodeState | None = None
    spec_tokens: int = 0             # draft proposals per verify round

    @property
    def paged(self) -> bool:
        return self.page_tokens > 0

    def pages_needed(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_tokens)

    def reserve_pages(self, lane: int, tokens: int) -> bool:
        """Reserve pages for ``tokens`` (the row's prompt + max_new budget,
        so a decoding row never starves) and point the lane's block table
        at them. False when the free list cannot cover it: the caller
        blocks admission and retries after retirements."""
        need = self.pages_needed(tokens)
        if need > len(self.free_pages):
            return False
        pages = [self.free_pages.pop() for _ in range(need)]
        for pg in pages:
            self.page_refs[pg] += 1
        self.lane_pages[lane] = pages
        self.block_tables[lane, :] = 0
        self.block_tables[lane, :len(pages)] = pages
        return True

    def release_pages(self, lane: int) -> None:
        """Drop a retired or failed lane's pages back on the free list and
        park the lane on the trash page (zeroed table row), so its frozen
        in-chunk rewrites never touch a recycled page's next owner."""
        for pg in self.lane_pages.pop(lane, None) or ():
            n = int(self.page_refs[pg]) - 1
            self.page_refs[pg] = max(n, 0)
            if n <= 0:
                self.free_pages.append(pg)
        if self.block_tables is not None:
            self.block_tables[lane, :] = 0

    def page_stats(self) -> dict:
        """Distinct-page split of the arena (trash page 0 excluded). Without
        shared prefixes every referenced page is private to one lane."""
        used = {pg for pages in self.lane_pages.values() for pg in pages}
        return {"free": len(self.free_pages), "cached": 0, "shared": 0, "private": len(used)}

    def check_page_conservation(self) -> None:
        """Assert the refcount invariant over the whole arena: every usable
        page is exactly one of free or referenced, ``page_refs`` agrees with
        the lanes' census, page 0 is never handed out. Host-only."""
        if not self.paged:
            return
        census = np.zeros(self.arena_pages + 1, np.int64)
        for pages in self.lane_pages.values():
            for pg in pages:
                census[pg] += 1
        free = set(self.free_pages)
        assert len(free) == len(self.free_pages), "duplicate free-list pages"
        assert 0 not in free, "trash page on the free list"
        assert census[0] == 0, "trash page is referenced"
        for pg in range(1, self.arena_pages + 1):
            refs = int(census[pg])
            if pg in free:
                assert refs == 0, f"page {pg} free but referenced {refs}x"
            else:
                assert refs > 0, f"page {pg} leaked (not free, unreferenced)"
            got = int(self.page_refs[pg])
            assert got == refs, f"page {pg}: page_refs says {got}, census says {refs}"


# TPUSC_PAGECHECK=1: assert before every paged decode chunk that no live
# lane's block table maps the trash page below its visible position — the
# plain path and the kernel read whatever the table points at, so such an
# entry would attend over junk K/V with no error anywhere.
_PAGECHECK = os.environ.get("TPUSC_PAGECHECK", "") == "1"


def _check_trash_unreachable(state: SlotDecodeState) -> None:
    """Raise if an active lane's block-table row maps page 0 in a slot its
    attention window reaches (pages covering tokens 0..pos inclusive)
    (reference :858). Host-only, O(slots x pages_per_slot)."""
    for lane in range(state.slots):
        if not bool(state.active[lane]):
            continue
        live = state.pages_needed(int(state.pos[lane]) + 1)
        row = state.block_tables[lane, :live]
        if (row == 0).any():
            bad = int(np.argmax(row == 0))
            raise AssertionError(
                f"TPUSC_PAGECHECK: lane {lane} maps trash page 0 at block-table slot "
                f"{bad} below pos={int(state.pos[lane])} (live pages={live}) — attention "
                "would read junk KV"
            )


def _arena(state: SlotDecodeState) -> dict:
    """The paged arena of ``state`` as generation's ``{"k", "v"[, "k_scale",
    "v_scale"]}`` dict (the same tensors, updated in place)."""
    arena = {"k": state.k, "v": state.v}
    if state.scales is not None:
        arena["k_scale"], arena["v_scale"] = state.scales["k"], state.scales["v"]
    return arena


def _shards_weights(rules: Mapping[str, tuple]) -> bool:
    """Do partition rules place any weight axis on a mesh axis (tensor
    parallelism), rather than replicate everything?"""
    return any(any(ax is not None for ax in axes) for axes in rules.values())


class TorchModelRuntime(BaseRuntime):
    def __init__(
        self,
        cfg: ServingConfig | None = None,
        device: str | torch.device | None = None,
        devices: list[str | torch.device] | None = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg or ServingConfig()
        # the device group (None = one device); its first device leads
        self.group: tuple[torch.device, ...] | None = None
        if devices is not None:
            group = tuple(resolve_device(d) for d in devices)
            if not group:
                raise RuntimeError_("a device group needs at least one device")
            if device is not None and resolve_device(device) != group[0]:
                raise RuntimeError_(
                    f"device {device!r} is not the group's leader {group[0]} (devices[0])"
                )
            self.group = group
            device = group[0]
        self.device = resolve_device(device)
        self._resident: LRUCache[ModelId, LoadedModel] = LRUCache(
            self.cfg.hbm_capacity_bytes,
            on_evict=self._on_evict,
            max_items=self.cfg.max_concurrent_models,
        )
        self._load_locks: dict[ModelId, threading.Lock] = {}  # guarded-by: _load_locks_guard
        self._load_locks_guard = threading.Lock()
        self._slot_states: dict[ModelId, SlotDecodeState] = {}  # guarded-by: _slot_lock
        self._slot_init_guards: dict[ModelId, threading.Lock] = {}  # guarded-by: _slot_lock
        self._slot_lock = threading.Lock()
        # speculative decoding: acceptance health per (target, draft) pair,
        # and cumulative verify rounds / emitted tokens per engine label
        # ("solo", "continuous") in place of the reference's gauges
        self._spec_health: dict[tuple[ModelId, ModelId], dict] = {}  # guarded-by: _spec_lock
        self.spec_rounds: collections.Counter = collections.Counter()  # guarded-by: _spec_lock
        self.spec_emitted: collections.Counter = collections.Counter()  # guarded-by: _spec_lock
        self._spec_lock = threading.Lock()

    # -- load ---------------------------------------------------------------
    def ensure_loaded(self, model: Model) -> str:
        """-> ``"hbm"`` (already resident) or ``"disk"`` (loaded now)."""
        mid = model.identifier
        if self.is_loaded(mid):
            return "hbm"
        with self._load_locks_guard:
            lock = self._load_locks.setdefault(mid, threading.Lock())
        try:
            with lock:
                if self.is_loaded(mid):  # singleflight: someone else finished it
                    return "hbm"
                self._load(model)
                return "disk"
        finally:
            if not self.is_loaded(mid):
                with self._load_locks_guard:
                    held = self._load_locks.get(mid)
                    if held is lock and not held.locked():
                        del self._load_locks[mid]

    def _load(self, model: Model) -> None:
        mid = model.identifier
        self._set_state(mid, ModelState.START)
        t0 = time.monotonic()
        try:
            self._set_state(mid, ModelState.LOADING)
            on_cuda = self.device.type == "cuda"
            model_def, host_params = load_artifact(model.path, pin_memory=on_cuda)
            grouped = self.group is not None and len(self.group) > 1
            if (grouped and model_def.bind_group is None
                    and _shards_weights(model_def.partition_rules)):
                raise RuntimeError_(
                    f"tensor parallelism over a group: later slice ({model_def.family} "
                    f"declares partition rules that shard its weights; this runtime's "
                    f"group has {len(self.group)} devices)"
                )
            # async copies out of the page-locked buffer, one sync at the end
            params = _tree_map(
                lambda t: t.to(self.device, non_blocking=True), host_params
            )
            if on_cuda:
                torch.cuda.current_stream(self.device).synchronize()
            del host_params
            if self.group is not None and model_def.bind_group is not None:
                module = model_def.bind_group(self.group)(params)
            else:
                module = model_def.make_module(params)
            loaded = LoadedModel(model_def, module.eval(), tree_nbytes(params))
            self._warmup(loaded)
            self._resident.put(mid, loaded.nbytes, loaded)
            self._set_state(mid, ModelState.AVAILABLE)
        except Exception as e:
            self._set_state(mid, ModelState.END)
            raise RuntimeError_(f"failed to load {mid}: {e}") from e
        log.info(
            "loaded %s in %.2fs (%d device bytes on %s)",
            mid, time.monotonic() - t0, loaded.nbytes, self.device,
        )

    def _warmup(self, loaded: LoadedModel) -> None:
        """One tiny forward at bucket 1 before AVAILABLE (library handles
        and allocator pools are set up before the first real request)."""
        inputs = {
            name: torch.zeros(self._concrete_shape(spec, 1), device=self.device,
                              dtype=getattr(torch, spec.dtype))
            for name, spec in loaded.model_def.input_spec.items()
        }
        with torch.inference_mode():
            loaded.module(inputs)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _concrete_shape(spec: TensorSpec, batch: int) -> tuple[int, ...]:
        return tuple(batch if isinstance(d, str) else d for d in spec.norm_shape())

    # -- predict ------------------------------------------------------------
    def predict(
        self,
        model_id: ModelId,
        inputs: Mapping[str, np.ndarray],
        output_filter: list[str] | None = None,
    ) -> dict[str, np.ndarray]:
        loaded = self._resident.get(model_id)
        if loaded is None:
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        model_def = loaded.model_def
        spec = model_def.input_spec
        missing = set(spec) - set(inputs)
        if missing:
            raise RuntimeError_(f"missing inputs {sorted(missing)} for {model_id}")
        unknown = set(inputs) - set(spec)
        if unknown:
            raise RuntimeError_(f"unknown inputs {sorted(unknown)} for {model_id}")

        dyn_sizes, padded = self._pad_to_bucket(spec, inputs)
        out_spec = model_def.output_spec
        derived = model_def.derived_outputs
        if output_filter:
            names = list(output_filter)
        elif model_def.default_outputs:
            names = list(model_def.default_outputs)
        else:
            names = list(out_spec)
        unknown_out = [n for n in names if n not in out_spec and n not in derived]
        if unknown_out:
            raise RuntimeError_(
                f"output_filter names unknown outputs {unknown_out} for {model_id} "
                f"(available: {sorted(out_spec) + sorted(derived)})"
            )
        with torch.inference_mode():
            dev_in = {
                name: torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
                for name, arr in padded.items()
            }
            dev_out = loaded.module(dev_in)
            # select + un-pad ON DEVICE so only the requested bytes cross
            # to the host (an LM ships (B, V), not the padded (B', S', V))
            selected: dict[str, torch.Tensor] = {}
            for name in names:
                if name in derived:
                    fn, _dspec = derived[name]
                    selected[name] = fn(dev_out, dyn_sizes)
                    continue
                arr = dev_out[name]
                for axis, axis_name in out_spec[name].dynamic_axes():
                    true = dyn_sizes.get(axis_name)
                    if true is not None and arr.dim() > axis and arr.shape[axis] > true:
                        arr = arr.narrow(axis, 0, true)
                selected[name] = arr
            return {name: t.contiguous().cpu().numpy() for name, t in selected.items()}

    def _pad_to_bucket(
        self, spec: Mapping[str, TensorSpec], inputs: Mapping[str, np.ndarray]
    ) -> tuple[dict[str, int], dict[str, np.ndarray]]:
        """-> (true size per named dynamic axis, padded inputs). Every named
        axis pads to its own power-of-two bucket; the same name must agree
        across inputs."""
        dyn_sizes: dict[str, int] = {}
        for name, s in spec.items():
            arr = np.asarray(inputs[name])
            for axis, axis_name in s.dynamic_axes():
                if arr.ndim <= axis:
                    raise RuntimeError_(
                        f"input {name!r} needs at least {axis + 1} dims, got shape {arr.shape}"
                    )
                size = arr.shape[axis]
                if axis_name in dyn_sizes and dyn_sizes[axis_name] != size:
                    raise RuntimeError_(
                        f"inconsistent {axis_name!r} dim: {dyn_sizes[axis_name]} vs "
                        f"{size} ({name!r})"
                    )
                dyn_sizes[axis_name] = size
        if not dyn_sizes:
            return {}, {k: np.asarray(v) for k, v in inputs.items()}
        buckets = {n: next_bucket(v) for n, v in dyn_sizes.items()}
        padded: dict[str, np.ndarray] = {}
        for name, s in spec.items():
            arr = np.asarray(inputs[name], dtype=s.np_dtype())
            pad = [(0, 0)] * arr.ndim
            changed = False
            for axis, axis_name in s.dynamic_axes():
                if buckets[axis_name] != arr.shape[axis]:
                    pad[axis] = (0, buckets[axis_name] - arr.shape[axis])
                    changed = True
            padded[name] = np.pad(arr, pad) if changed else arr
        return dyn_sizes, padded

    # -- generate -----------------------------------------------------------
    def _lm(self, model_id: ModelId) -> LoadedModel:
        loaded = self._resident.get(model_id)
        if loaded is None:
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        if loaded.model_def.family != "transformer_lm":
            raise RuntimeError_(
                "generate is supported for transformer_lm models, not "
                f"{loaded.model_def.family!r}"
            )
        return loaded

    def generate(
        self,
        model_id: ModelId,
        input_ids: np.ndarray,
        prompt_lengths: list[int] | None = None,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        draft_model_id: ModelId | None = None,
        spec_tokens: int = 4,
    ) -> np.ndarray:
        """KV-cached decoding (``models/generation.generate``) on the solo
        path (reference :1813-1993): the same validation; prompt seq,
        max_new_tokens and the batch axis padded to power-of-two buckets,
        with the exact sizes where the buckets would overshoot max_seq.
        -> (B, max_new_tokens) int32.

        ``draft_model_id`` switches to greedy speculative decoding
        (``models/speculative.py``): the draft proposes ``spec_tokens``
        tokens per round (clamped to a power of two <= 8), this model
        verifies them in one chunked forward; the output is its own greedy
        decode. Requires temperature 0 and a resident draft sharing the
        vocabulary. A pair the acceptance health gate disabled decodes plain
        (identical tokens) until it re-auditions."""
        from tfservingcache_tpu_torch.models import generation

        loaded = self._lm(model_id)
        draft = None
        if draft_model_id is not None:
            if temperature > 0.0:
                raise RuntimeError_(
                    "speculative decoding (draft_model) requires temperature 0 "
                    "— sampled acceptance is not implemented"
                )
            if spec_tokens < 1:
                raise RuntimeError_(f"spec_tokens must be >= 1, got {spec_tokens}")
            spec_tokens = next_bucket(min(spec_tokens, SPEC_TOKENS_MAX))
            draft = self._resident.get(draft_model_id)
            if draft is None:
                raise ModelNotLoadedError(f"draft model {draft_model_id} is not loaded")
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim != 2 or not ids.size:
            raise RuntimeError_(f"input_ids must be (batch, seq), got {ids.shape}")
        b, s = ids.shape
        if prompt_lengths is None:
            lengths = np.full((b,), s, np.int32)
        else:
            lengths = np.asarray(prompt_lengths, np.int32)
            if lengths.shape != (b,) or (lengths < 1).any() or (lengths > s).any():
                raise RuntimeError_(f"bad prompt_lengths {lengths!r} for shape {ids.shape}")
        if max_new_tokens < 1:
            raise RuntimeError_("max_new_tokens must be >= 1")
        if not math.isfinite(temperature) or temperature < 0.0:
            raise RuntimeError_(f"temperature must be a finite value >= 0, got {temperature}")
        if top_k < 0:
            raise RuntimeError_(f"top_k must be >= 0, got {top_k}")
        cfg = loaded.model_def.config
        max_seq = cfg["max_seq"]
        s_bucket = next_bucket(s)
        new_bucket = next_bucket(max_new_tokens)
        if s_bucket + new_bucket > max_seq:
            # bucket overshoot may exceed max_seq when the true request fits
            s_bucket, new_bucket = s, max_new_tokens
            if s + max_new_tokens > max_seq:
                raise RuntimeError_(
                    f"prompt {s} + max_new_tokens {max_new_tokens} exceeds max_seq {max_seq}"
                )
        if s_bucket != s:
            ids = np.pad(ids, ((0, 0), (0, s_bucket - s)))
        b_bucket = next_bucket(b)
        if b_bucket != b:  # padding rows decode junk that is sliced off
            ids = np.pad(ids, ((0, b_bucket - b), (0, 0)))
            lengths = np.pad(lengths, (0, b_bucket - b), constant_values=1)
        if draft is not None and not self._spec_admit(model_id, draft_model_id):
            # sustained low acceptance: the draft is pure overhead; plain
            # greedy decode gives the same tokens until the pair re-auditions
            draft = None
        dev_ids = torch.from_numpy(ids).to(self.device)
        if draft is not None:
            from tfservingcache_tpu_torch.models.speculative import speculative_generate

            toks, rounds = speculative_generate(
                loaded.model_def, loaded.module, draft.model_def, draft.module, dev_ids,
                prompt_lengths=torch.from_numpy(lengths), max_new_tokens=new_bucket,
                spec_tokens=spec_tokens, return_rounds=True,
            )
            self._spec_observe(model_id, draft_model_id, new_bucket, rounds)
        else:
            toks = generation.generate(
                loaded.module, cfg, dev_ids, torch.from_numpy(lengths), new_bucket,
                temperature=temperature, top_k=top_k, seed=seed,
            )
        return toks.cpu().numpy()[:b, :max_new_tokens]

    # -- continuous-decode slot surface (runtime/batcher.py) ----------------
    def eos_id_of(self, model_id: ModelId) -> int | None:
        """The model's ``eos_id`` config key, None when unset or not resident."""
        loaded = self._resident.get(model_id, touch=False)
        if loaded is None:
            return None
        eos = loaded.model_def.config.get("eos_id")
        return None if eos is None else int(eos)

    def max_seq_of(self, model_id: ModelId) -> int | None:
        loaded = self._resident.get(model_id, touch=False)
        if loaded is None:
            return None
        ms = loaded.model_def.config.get("max_seq")
        return None if ms is None else int(ms)

    def family_of(self, model_id: ModelId) -> str | None:
        loaded = self._resident.get(model_id, touch=False)
        return None if loaded is None else loaded.model_def.family

    def slot_decode_state(
        self,
        model_id: ModelId,
        slots: int,
        page_tokens: int | None = None,
        arena_pages: int | None = None,
        arena_dtype: str | None = None,
        paged_kernel: bool | None = None,
    ) -> SlotDecodeState:
        """Create-or-get the model's slot state (reference :2018). The knobs
        default to the ServingConfig's; ``page_tokens == 0`` keeps the dense
        slot array, ``> 0`` allocates the paged arena (``arena_pages == 0``
        auto-sizes to slots x ceil(max_seq / page_tokens); an int8 arena
        grows to the same byte budget). An existing state wins. Allocation
        runs under a per-model once-guard, not under the map lock."""
        self._lm(model_id)
        with self._slot_lock:
            st = self._slot_states.get(model_id)
            if st is not None:
                return st
            guard = self._slot_init_guards.setdefault(model_id, threading.Lock())
        with guard:
            with self._slot_lock:
                st = self._slot_states.get(model_id)
            if st is not None:
                return st
            st = self._build_slot_state(
                self._lm(model_id), model_id, slots, page_tokens, arena_pages,
                arena_dtype, paged_kernel,
            )
            with self._slot_lock:
                st = self._slot_states.setdefault(model_id, st)
                self._slot_init_guards.pop(model_id, None)
            return st

    def _build_slot_state(
        self,
        loaded: LoadedModel,
        model_id: ModelId,
        slots: int,
        page_tokens: int | None,
        arena_pages: int | None,
        arena_dtype: str | None,
        paged_kernel: bool | None,
    ) -> SlotDecodeState:
        from tfservingcache_tpu_torch.models import generation

        if page_tokens is None:
            page_tokens = int(self.cfg.kv_page_tokens)
        if arena_pages is None:
            arena_pages = int(self.cfg.kv_arena_pages)
        if arena_dtype is None:
            arena_dtype = str(self.cfg.kv_arena_dtype or "")
        if paged_kernel is None:
            paged_kernel = bool(self.cfg.kv_paged_kernel)
        cfg = loaded.model_def.config
        max_seq = int(cfg["max_seq"])
        common = dict(
            model_id=model_id,
            slots=slots,
            max_seq=max_seq,
            tok=np.zeros((slots,), np.int32),
            pos=np.zeros((slots,), np.int32),
            active=np.zeros((slots,), bool),
            temps=np.zeros((slots,), np.float32),
            topks=np.zeros((slots,), np.int32),
            kernel=bool(paged_kernel),
        )
        if page_tokens and page_tokens > 0:
            page_tokens = int(page_tokens)
            pps = -(-max_seq // page_tokens)
            usable = int(arena_pages) if arena_pages else slots * pps
            if not arena_pages and arena_dtype == "int8":
                # byte-matched auto-size: an int8 row is hd bytes + a 4-byte
                # f32 scale against hd * itemsize, so the same budget holds
                # more pages (reference :2129-2143)
                hd = int(cfg["d_model"]) // int(cfg["n_heads"])
                dense_item = torch.empty((), dtype=getattr(torch, cfg["dtype"])).element_size()
                usable = max(usable, (usable * hd * dense_item) // (hd + 4))
            # +1: page 0 is the trash page, permanently reserved
            arena = generation.init_paged_cache(
                cfg, usable + 1, page_tokens, arena_dtype, self.device
            )
            scales = None
            if "k_scale" in arena:
                scales = {"k": arena["k_scale"], "v": arena["v_scale"]}
            return SlotDecodeState(
                k=arena["k"], v=arena["v"], scales=scales, arena_dtype=arena_dtype,
                page_tokens=page_tokens, arena_pages=usable, pages_per_slot=pps,
                block_tables=np.zeros((slots, pps), np.int32),
                free_pages=list(range(1, usable + 1)),
                page_refs=np.zeros((usable + 1,), np.int32),
                **common,
            )
        cache = generation.init_cache(cfg, slots, max_seq, self.device)
        return SlotDecodeState(k=cache["k"], v=cache["v"], **common)

    def drop_slot_state(self, model_id: ModelId) -> None:
        with self._slot_lock:
            self._slot_states.pop(model_id, None)

    def slot_prefill(
        self, model_id: ModelId, prompt: np.ndarray, temperature: float, top_k: int,
        seed: int,
    ) -> tuple[int, torch.Tensor, torch.Tensor]:
        """Admission prefill of one request (reference :2232, no prefix
        cache): the prompt through a ``(1, P_bucket)`` prefill and its first
        token sampled from a generator seeded with ``seed``.
        -> (first token, k, v), k/v ready for slot_admit."""
        from tfservingcache_tpu_torch.models import generation

        loaded = self._lm(model_id)
        cfg = loaded.model_def.config
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = prompt.shape[0]
        s_pad = next_bucket(p)
        if s_pad > int(cfg["max_seq"]):
            s_pad = p  # bucket overshoot: exact size (same rule as generate)
        ids = np.zeros((1, s_pad), np.int32)
        ids[0, :p] = prompt
        tok, pk, pv, _last = generation.slot_prefill(
            loaded.module, cfg, torch.from_numpy(ids).to(self.device), p,
            temperature, top_k, seed,
        )
        return int(tok[0]), pk, pv

    def slot_admit(self, state: SlotDecodeState, idx: int, pk: torch.Tensor,
                   pv: torch.Tensor) -> None:
        """Copy an admitted request's prefill K/V into lane ``idx`` in place
        (reference :2737). A paged state must have the lane's pages reserved
        first: the insert scatters through the lane's block-table row."""
        from tfservingcache_tpu_torch.models import generation

        if state.paged:
            row = torch.from_numpy(state.block_tables[idx].copy()).to(self.device)
            generation.paged_insert(_arena(state), pk, pv, row, state.page_tokens)
            return
        generation.slot_insert(state.k, state.v, pk, pv, idx)

    def slot_decode_chunk(self, state: SlotDecodeState, chunk: int) -> np.ndarray:
        """Advance every active lane by ``chunk`` decode steps (reference
        :2765). The host mirrors are copied to the device once, the steps
        run without a host sync, and ``toks``/``tok``/``pos`` come back once
        at the end. Updates the state's K/V in place and its tok/pos
        mirrors; returns the (S, chunk) emitted tokens. Raises
        ModelNotLoadedError when the model was evicted mid-decode."""
        from tfservingcache_tpu_torch.models import generation

        loaded = self._resident.get(state.model_id)
        if loaded is None:
            raise ModelNotLoadedError(f"model {state.model_id} is not loaded")
        cfg = loaded.model_def.config
        state.chunk_counter += 1
        dev = self.device
        gen = None
        if (state.temps > 0).any():  # host mirror: every-lane-greedy draws nothing
            gen = torch.Generator(device=dev).manual_seed(state.chunk_counter)
        tok = torch.from_numpy(state.tok.astype(np.int64)).to(dev)
        active = torch.from_numpy(state.active.copy()).to(dev)
        temps = torch.from_numpy(state.temps.copy()).to(dev)
        topks = torch.from_numpy(state.topks.copy()).to(dev)
        if state.paged:
            if _PAGECHECK:
                _check_trash_unreachable(state)
            tables = torch.from_numpy(state.block_tables.copy()).to(dev)
            pos = torch.from_numpy(state.pos.copy()).to(dev)
            tok, pos, toks = generation.paged_decode_chunk(
                loaded.module, cfg, _arena(state), tables, tok, pos, active, gen, temps, topks,
                chunk, state.page_tokens, state.kernel,
            )
        else:
            pos = torch.from_numpy(state.pos.astype(np.int64)).to(dev)
            tok, pos, toks = generation.decode_chunk(
                loaded.module, cfg, state.k, state.v, tok, pos, active, gen, temps,
                topks, chunk,
            )
        # np.array (a writable copy): the scheduler writes these mirrors
        state.tok = np.array(tok.cpu().numpy(), dtype=np.int32)
        state.pos = np.array(pos.cpu().numpy(), dtype=np.int32)
        return toks.cpu().numpy().astype(np.int32)

    def slot_attach_draft(self, state: SlotDecodeState, draft_id: ModelId,
                          spec_tokens: int = 4) -> SlotDecodeState:
        """Attach ``draft_id``'s decode state to ``state`` for in-engine
        speculative rounds (reference :2811-2868): the draft's own paged
        arena with the target's slot count, page size, arena dtype and
        kernel flag (auto-sized like the target's), pinned on
        ``state.spec_draft`` so it lives and dies with the target state (it
        is NOT registered in ``_slot_states``). Idempotent for the same
        draft. The draft must be resident, a transformer_lm and share the
        target's vocabulary; the target state must be paged.
        ``spec_tokens`` is clamped to {1, 2, 4, 8}."""
        if state.spec_draft is not None and state.spec_draft_id == draft_id:
            return state.spec_draft
        if not state.paged:
            raise RuntimeError_(
                "in-engine speculation requires a paged slot state "
                "(serving.kv_page_tokens > 0)"
            )
        loaded = self._resident.get(state.model_id)
        draft = self._resident.get(draft_id)
        if loaded is None or draft is None:
            missing = state.model_id if loaded is None else draft_id
            raise ModelNotLoadedError(f"model {missing} is not loaded")
        if draft.model_def.family != "transformer_lm":
            raise RuntimeError_(
                "continuous speculation supports transformer_lm drafts "
                f"only, not {draft.model_def.family!r}"
            )
        if draft.model_def.config["vocab_size"] != loaded.model_def.config["vocab_size"]:
            raise RuntimeError_(
                "draft and target must share a vocabulary: "
                f"{draft.model_def.config['vocab_size']} vs "
                f"{loaded.model_def.config['vocab_size']}"
            )
        if spec_tokens < 1:
            raise RuntimeError_(f"spec_tokens must be >= 1, got {spec_tokens}")
        d_st = self._build_slot_state(
            draft, draft_id, state.slots, state.page_tokens, 0, state.arena_dtype, state.kernel,
        )
        # host mirrors alias the target's: both caches always sit at the
        # same accepted positions, so one array serves both censuses
        d_st.tok, d_st.pos, d_st.active = state.tok, state.pos, state.active
        state.spec_draft_id = draft_id
        state.spec_draft = d_st
        state.spec_tokens = next_bucket(min(int(spec_tokens), SPEC_TOKENS_MAX))
        return d_st

    def slot_decode_spec_round(self, state: SlotDecodeState) -> tuple[np.ndarray, np.ndarray]:
        """One speculative draft/verify round for every active lane — the
        spec counterpart of ``slot_decode_chunk`` (reference :2871-2928):
        host mirrors to the device once, one sync at the end. Requires an
        attached draft. -> (toks (S, spec+1), accept (S,)): lane ``s``
        emitted ``toks[s, :accept[s]]`` (0 for frozen lanes). Raises
        ModelNotLoadedError naming whichever half of the pair was evicted;
        then nothing was updated."""
        from tfservingcache_tpu_torch.models.speculative import paged_spec_round

        d_st = state.spec_draft
        if d_st is None:
            raise RuntimeError_("no draft attached (slot_attach_draft)")
        loaded = self._resident.get(state.model_id)
        if loaded is None:
            raise ModelNotLoadedError(f"model {state.model_id} is not loaded")
        d_loaded = self._resident.get(d_st.model_id)
        if d_loaded is None:
            raise ModelNotLoadedError(f"draft model {d_st.model_id} is not loaded")
        # admission may have rebound the target's mirrors: re-alias first
        d_st.tok, d_st.pos, d_st.active = state.tok, state.pos, state.active
        state.chunk_counter += 1
        if _PAGECHECK:
            _check_trash_unreachable(state)
            _check_trash_unreachable(d_st)
        dev = self.device
        gen = None
        if (state.temps > 0).any():  # host mirror: every-lane-greedy draws nothing
            gen = torch.Generator(device=dev).manual_seed(state.chunk_counter)
        tok, pos, toks, accept = paged_spec_round(
            loaded.module, loaded.model_def.config, d_loaded.module, d_loaded.model_def.config,
            _arena(state), _arena(d_st),
            torch.from_numpy(state.block_tables.copy()).to(dev),
            torch.from_numpy(d_st.block_tables.copy()).to(dev),
            torch.from_numpy(state.tok.astype(np.int64)).to(dev),
            torch.from_numpy(state.pos.copy()).to(dev),
            torch.from_numpy(state.active.copy()).to(dev), gen,
            torch.from_numpy(state.temps.copy()).to(dev),
            torch.from_numpy(state.topks.copy()).to(dev),
            state.spec_tokens, state.page_tokens, state.kernel,
        )
        # np.array (a writable copy): the scheduler writes these mirrors
        state.tok = np.array(tok.cpu().numpy(), dtype=np.int32)
        state.pos = np.array(pos.cpu().numpy(), dtype=np.int32)
        d_st.tok, d_st.pos = state.tok, state.pos
        return (toks.cpu().numpy().astype(np.int32),
                np.array(accept.cpu().numpy(), dtype=np.int32))

    # -- speculative health gate (reference :3105-3170) ---------------------
    def _spec_admit(self, target: ModelId, draft: ModelId) -> bool:
        """Should this request (or engine round) run its draft? False once
        sustained low acceptance disabled the pair; every
        SPEC_REPROBE_EVERY-th gated call re-auditions the draft."""
        with self._spec_lock:
            st = self._spec_health.get((target, draft))
            if st is None or not st["disabled"]:
                return True
            st["skipped"] += 1
            return st["skipped"] % SPEC_REPROBE_EVERY == 0

    def _spec_observe(self, target: ModelId, draft: ModelId, emitted: int, rounds: int,
                      engine: str = "solo") -> None:
        """Record one speculative generate's (or engine boundary's)
        acceptance and flip the pair's disabled flag on a sustained low
        streak. ``engine`` labels the cumulative counters."""
        tpr = emitted / max(1, rounds)
        with self._spec_lock:
            self.spec_rounds[engine] += int(rounds)
            self.spec_emitted[engine] += int(emitted)
        if not (self.is_loaded(target) and self.is_loaded(draft)):
            # either half unloaded mid-generate: recording would resurrect
            # the pair entry unload() just pruned
            return
        with self._spec_lock:
            st = self._spec_health.setdefault(
                (target, draft), {"low_streak": 0, "disabled": False, "skipped": 0})
            if tpr >= SPEC_MIN_TOKENS_PER_ROUND:
                if st["disabled"]:
                    log.info("draft %s re-enabled for %s (%.2f tokens/round)", draft, target, tpr)
                st.update(low_streak=0, disabled=False, skipped=0)
                return
            st["low_streak"] += 1
            if not st["disabled"] and st["low_streak"] >= SPEC_DISABLE_AFTER:
                st["disabled"] = True
                st["skipped"] = 0
                log.warning(
                    "draft %s auto-disabled for %s: %d consecutive generates below %.1f "
                    "tokens/round (last %.2f); falling back to plain decode (re-audition "
                    "every %d requests)", draft, target, SPEC_DISABLE_AFTER,
                    SPEC_MIN_TOKENS_PER_ROUND, tpr, SPEC_REPROBE_EVERY,
                )

    def _spec_forget(self, model_id: ModelId) -> None:
        """Drop the acceptance history of every pair ``model_id`` is in,
        in either role."""
        with self._spec_lock:
            for pair in [p for p in self._spec_health if model_id in p]:
                del self._spec_health[pair]

    # -- residency ----------------------------------------------------------
    def _on_evict(self, model_id: ModelId, entry: LRUEntry[LoadedModel]) -> None:
        self._set_state(model_id, ModelState.UNLOADING)
        # the slot state (and a draft state attached to it) goes with the model
        self.drop_slot_state(model_id)
        # acceptance history dies with either half of a pair
        self._spec_forget(model_id)
        # only the LRU's reference goes: an in-flight predict holding the
        # LoadedModel keeps its tensors alive until it finishes
        self._set_state(model_id, ModelState.END)
        with self._load_locks_guard:
            lock = self._load_locks.get(model_id)
            if lock is not None and not lock.locked():
                del self._load_locks[model_id]
        log.info("unloaded %s (freed %d device bytes)", model_id, entry.size_bytes)

    def unload(self, model_id: ModelId) -> None:
        self._resident.remove(model_id, run_callback=True)
        # _on_evict prunes the spec pairs only of a RESIDENT model; an
        # unload of a non-resident id must drop them too (reference :2986)
        self._spec_forget(model_id)

    def is_loaded(self, model_id: ModelId) -> bool:
        return self._resident.get(model_id, touch=False) is not None

    def resident_models(self) -> list[ModelId]:
        return self._resident.keys_mru_first()

    def signature(self, model_id: ModelId):
        loaded = self._resident.get(model_id, touch=False)
        if loaded is None:
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        d = loaded.model_def
        # derived outputs advertised beside the concrete ones
        out_spec = dict(d.output_spec)
        out_spec.update({name: spec for name, (_fn, spec) in d.derived_outputs.items()})
        return d.input_spec, out_spec, d.method_name

    def check(self) -> None:
        """Health probe: every device of the runtime must answer a trivial
        computation."""
        for dev in dict.fromkeys(self.group or (self.device,)):
            x = torch.ones(8, device=dev)
            if float(x.sum()) != 8.0:
                raise RuntimeError_(f"device smoke computation on {dev} returned wrong result")

    @property
    def hbm_bytes_in_use(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.memory_allocated(self.device)
        return self._resident.total_bytes

    def close(self) -> None:
        self._resident.clear()
        with self._slot_lock:
            self._slot_states.clear()
