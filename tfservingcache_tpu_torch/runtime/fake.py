"""FakeRuntime: the in-process test double for the model runtime (the
port's copy of ``tfservingcache_tpu/runtime/fake.py``, numpy only).

It makes the manager's and the batchers' logic testable without a model:
configurable load latency and failures, call recording, real state
transitions. ``predict(x) = x * version + bias``; ``generate`` answers
every token with the model's version.
"""

from __future__ import annotations

import threading
import time
from typing import Mapping

import numpy as np

from tfservingcache_tpu_torch.models.registry import TensorSpec
from tfservingcache_tpu_torch.runtime.base import BaseRuntime, ModelNotLoadedError, RuntimeError_
from tfservingcache_tpu_torch.types import Model, ModelId, ModelState
from tfservingcache_tpu_torch.utils.lockcheck import lockchecked


@lockchecked
class FakeRuntime(BaseRuntime):
    """predict(x) = x * version + bias, so tests can tell versions apart."""

    _tpusc_guarded = {"_loaded": "_lock"}

    def __init__(
        self,
        load_delay_s: float = 0.0,
        fail_loads: set[ModelId] | None = None,
        bias: float = 0.0,
        max_loaded: int | None = None,
    ) -> None:
        super().__init__()
        self.load_delay_s = load_delay_s
        self.fail_loads = fail_loads or set()
        self.bias = bias
        self.max_loaded = max_loaded
        self.loads: list[ModelId] = []
        self.unloads: list[ModelId] = []
        self.predicts: list[ModelId] = []
        self.concurrent_loads = 0
        self.max_concurrent_loads = 0
        self._loaded: dict[ModelId, Model] = {}
        self._lock = threading.Lock()

    def ensure_loaded(self, model: Model) -> None:
        mid = model.identifier
        with self._lock:
            if mid in self._loaded:
                return
            self.concurrent_loads += 1
            self.max_concurrent_loads = max(self.max_concurrent_loads, self.concurrent_loads)
            self._set_state(mid, ModelState.LOADING)
        try:
            if self.load_delay_s:
                time.sleep(self.load_delay_s)
            if mid in self.fail_loads:
                self._set_state(mid, ModelState.END)
                raise RuntimeError_(f"fake load failure for {mid}")
            with self._lock:
                if self.max_loaded is not None and len(self._loaded) >= self.max_loaded:
                    lru = next(iter(self._loaded))
                    del self._loaded[lru]
                    self.unloads.append(lru)
                    self._set_state(lru, ModelState.END)
                self._loaded[mid] = model
                self.loads.append(mid)
                self._set_state(mid, ModelState.AVAILABLE)
        finally:
            with self._lock:
                self.concurrent_loads -= 1

    def is_loaded(self, model_id: ModelId) -> bool:
        with self._lock:
            return model_id in self._loaded

    def resident_headroom(self) -> tuple[int | None, int]:
        # mirrors TPUModelRuntime.resident_headroom (byte budget uncapped
        # here: the fake sizes nothing)
        with self._lock:
            free = (
                None if self.max_loaded is None
                else max(0, self.max_loaded - len(self._loaded))
            )
        return free, 1 << 60

    def predict(
        self,
        model_id: ModelId,
        inputs: Mapping[str, np.ndarray],
        output_filter: list[str] | None = None,
    ) -> dict[str, np.ndarray]:
        if not self.is_loaded(model_id):
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        self.predicts.append(model_id)
        x = np.asarray(inputs["x"], dtype=np.float32)
        out = {"y": x * model_id.version + self.bias}
        if output_filter:
            out = {k: v for k, v in out.items() if k in output_filter}
        return out

    def unload(self, model_id: ModelId) -> None:
        with self._lock:
            if model_id in self._loaded:
                del self._loaded[model_id]
                self.unloads.append(model_id)
                self._set_state(model_id, ModelState.END)

    def signature(self, model_id: ModelId):
        if not self.is_loaded(model_id):
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        return (
            {"x": TensorSpec("float32", (-1,))},
            {"y": TensorSpec("float32", (-1,))},
            "tensorflow/serving/predict",
        )

    def generate(
        self,
        model_id: ModelId,
        input_ids,
        prompt_lengths=None,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        draft_model_id=None,
        spec_tokens: int = 4,
    ):
        if not self.is_loaded(model_id):
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        b = np.asarray(input_ids).shape[0]
        # deterministic fake: token id == model version
        return np.full((b, max_new_tokens), model_id.version, np.int32)

    def check(self) -> None:
        pass

    @property
    def hbm_bytes_in_use(self) -> int:
        # lock: iterating an unlocked dict races a concurrent load's insert
        # (RuntimeError: dictionary changed size during iteration)
        with self._lock:
            return sum(m.size_on_disk for m in self._loaded.values())
