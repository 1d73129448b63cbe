"""The PyTorch model runtime: artifact -> pinned host tensors -> GPU module.

Counterpart of ``tfservingcache_tpu/runtime/model_runtime.py`` for the
``:predict`` path. A load reads ``params.bin`` in one sequential read into
page-locked host memory, copies every leaf to the device and wraps them in
the family's ``nn.Module``; resident models live in a byte-budgeted LRU
(capped at ``serving.max_concurrent_models``) whose eviction drops the
module so its device memory is freed. Variable request shapes are padded to
power-of-two buckets per named axis, as in the reference, so each model sees
O(log) distinct shapes.

The runtime runs on ``cuda`` unless constructed with ``device="cpu"``; with
no card and no explicit device it raises. Forwards run eagerly under
``torch.inference_mode()``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
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


class TorchModelRuntime(BaseRuntime):
    def __init__(
        self, cfg: ServingConfig | None = None, device: str | torch.device | None = None
    ) -> None:
        super().__init__()
        self.cfg = cfg or ServingConfig()
        self.device = resolve_device(device)
        self._resident: LRUCache[ModelId, LoadedModel] = LRUCache(
            self.cfg.hbm_capacity_bytes,
            on_evict=self._on_evict,
            max_items=self.cfg.max_concurrent_models,
        )
        self._load_locks: dict[ModelId, threading.Lock] = {}  # guarded-by: _load_locks_guard
        self._load_locks_guard = threading.Lock()

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
            # async copies out of the page-locked buffer, one sync at the end
            params = _tree_map(
                lambda t: t.to(self.device, non_blocking=True), host_params
            )
            if on_cuda:
                torch.cuda.current_stream(self.device).synchronize()
            del host_params
            loaded = LoadedModel(
                model_def, model_def.make_module(params).eval(), tree_nbytes(params)
            )
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

    # -- residency ----------------------------------------------------------
    def _on_evict(self, model_id: ModelId, entry: LRUEntry[LoadedModel]) -> None:
        self._set_state(model_id, ModelState.UNLOADING)
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
        """Health probe: the device must answer a trivial computation."""
        x = torch.ones(8, device=self.device)
        if float(x.sum()) != 8.0:
            raise RuntimeError_("device smoke computation returned wrong result")

    @property
    def hbm_bytes_in_use(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.memory_allocated(self.device)
        return self._resident.total_bytes

    def close(self) -> None:
        self._resident.clear()
