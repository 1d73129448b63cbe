"""Runtime interface (counterpart of ``tfservingcache_tpu/runtime/base.py``).

The cache node drives an in-process runtime with direct load/unload/predict
calls; the lifecycle state machine (START/LOADING/AVAILABLE/UNLOADING/END) is
TF Serving's ModelVersionStatus enum, tracked in-process. Methods are
synchronous and thread-safe.
"""

from __future__ import annotations

import abc
import threading
from typing import Mapping

import numpy as np

from tfservingcache_tpu_torch.models.registry import TensorSpec
from tfservingcache_tpu_torch.types import Model, ModelId, ModelState


class RuntimeError_(Exception):
    """Runtime failure (load/predict). Underscore avoids shadowing builtins."""


class ModelNotLoadedError(RuntimeError_):
    pass


class LoadTimeoutError(RuntimeError_):
    """Cold-load deadline exceeded (fetch and/or load overran
    ``serving.load_timeout_s``). Maps to HTTP 504."""


class BaseRuntime(abc.ABC):
    def __init__(self) -> None:
        self._states: dict[ModelId, ModelState] = {}  # guarded-by: _states_lock
        self._states_lock = threading.Lock()

    # -- state machine ------------------------------------------------------
    def _set_state(self, model_id: ModelId, state: ModelState) -> None:
        with self._states_lock:
            self._states[model_id] = state

    def state(self, model_id: ModelId) -> ModelState:
        with self._states_lock:
            return self._states.get(model_id, ModelState.UNKNOWN)

    def states_for(self, name: str) -> dict[ModelId, ModelState]:
        """All known versions of ``name`` (the ModelService status view)."""
        with self._states_lock:
            return {m: s for m, s in self._states.items() if m.name == name}

    # -- core ---------------------------------------------------------------
    @abc.abstractmethod
    def ensure_loaded(self, model: Model) -> str | None:
        """Make ``model`` servable (idempotent); blocks until AVAILABLE or
        raises. Returns the tier that served the call ("hbm" | "disk")."""

    @abc.abstractmethod
    def is_loaded(self, model_id: ModelId) -> bool: ...

    @abc.abstractmethod
    def predict(
        self,
        model_id: ModelId,
        inputs: Mapping[str, np.ndarray],
        output_filter: list[str] | None = None,
    ) -> dict[str, np.ndarray]: ...

    @abc.abstractmethod
    def unload(self, model_id: ModelId) -> None: ...

    def unload_and_discard(self, model_id: ModelId) -> None:
        """Disk-evict hook: drop device residency (runtimes without further
        tiers inherit the plain unload)."""
        self.unload(model_id)

    @abc.abstractmethod
    def signature(
        self, model_id: ModelId
    ) -> tuple[dict[str, TensorSpec], dict[str, TensorSpec], str]:
        """-> (input_spec, output_spec, method_name) for a loaded model."""

    @abc.abstractmethod
    def check(self) -> None:
        """Raise when the runtime/accelerator is unhealthy."""

    @property
    @abc.abstractmethod
    def hbm_bytes_in_use(self) -> int: ...

    def close(self) -> None:  # pragma: no cover - trivial default
        pass
