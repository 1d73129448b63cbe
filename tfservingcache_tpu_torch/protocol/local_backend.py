"""LocalServingBackend: the cache node's fulfilment of the REST protocol
(counterpart of ``tfservingcache_tpu/protocol/local_backend.py``: ``:predict``,
model status and metadata). The request is decoded and answered in-process:
ensure the model is servable, run it on the runtime, encode the outputs.

Methods are synchronous; the REST server runs each request on its own
thread.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

import numpy as np

from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers.base import ModelNotFoundError
from tfservingcache_tpu_torch.models.registry import TensorSpec
from tfservingcache_tpu_torch.protocol import codec
from tfservingcache_tpu_torch.protocol.backend import BackendError, RestResponse, ServingBackend
from tfservingcache_tpu_torch.runtime.base import (
    LoadTimeoutError,
    ModelNotLoadedError,
    RuntimeError_,
)
from tfservingcache_tpu_torch.types import ModelId, ModelState

_STATE_NAMES = {s.value: s.name for s in ModelState}

# verbs the reference serves that this port does not yet
_LATER_VERBS = ("classify", "regress", "generate")


class LocalServingBackend(ServingBackend):
    def __init__(self, manager: CacheManager) -> None:
        self.manager = manager

    def _ensure(self, model_id: ModelId) -> None:
        try:
            self.manager.ensure_servable(model_id)
        except ModelNotFoundError as e:
            raise BackendError(str(e), 404) from e
        except LoadTimeoutError as e:
            raise BackendError(str(e), 504) from e
        except RuntimeError_ as e:
            raise BackendError(str(e), 500) from e

    def handle_rest(
        self,
        method: str,
        model_name: str,
        version: int | None,
        verb: str | None,
        body: bytes,
    ) -> RestResponse:
        try:
            resolved = self.manager.resolve_version(model_name, version)
        except (KeyError, ModelNotFoundError) as e:
            raise BackendError(str(e), 404) from e
        model_id = ModelId(model_name, resolved)
        if method == "GET" and verb is None:
            return self._rest_status(model_id)
        if method == "GET" and verb == "metadata":
            return self._rest_metadata(model_id)
        if method == "POST" and verb in _LATER_VERBS:
            raise BackendError(f":{verb} is not served by this port yet", 501)
        if method != "POST" or verb != "predict":
            raise BackendError(f"unsupported {method} {verb or ''} request", 405)
        try:
            payload = json.loads(body or b"{}")
        except ValueError as e:
            raise BackendError(f"invalid JSON body: {e}", 400) from e
        if not isinstance(payload, dict):
            raise BackendError("request body must be a JSON object", 400)
        return self._rest_predict(model_id, payload)

    def _rest_predict(self, model_id: ModelId, payload: dict) -> RestResponse:
        # "output_filter" selects outputs by name, derived ones included
        out_filter = payload.get("output_filter")
        if out_filter is not None and (
            not isinstance(out_filter, list)
            or not all(isinstance(x, str) for x in out_filter)
        ):
            raise BackendError('"output_filter" must be a list of output names', 400)
        encoding = payload.get("output_encoding", "json")
        if encoding not in ("json", "base64"):
            raise BackendError('"output_encoding" must be "json" or "base64"', 400)

        def attempt() -> dict[str, np.ndarray]:
            self._ensure(model_id)
            in_spec, _, _ = self.manager.runtime.signature(model_id)
            dtypes = {k: s.np_dtype() for k, s in in_spec.items()}
            default_input = next(iter(dtypes)) if len(dtypes) == 1 else "inputs"
            try:
                arrays, _sig = codec.decode_predict_json(payload, dtypes, default_input)
            except codec.CodecError as e:
                raise BackendError(str(e), 400) from e
            try:
                return self.manager.runtime.predict(model_id, arrays, out_filter or None)
            except ModelNotLoadedError:
                raise
            except RuntimeError_ as e:
                raise BackendError(str(e), 400) from e

        try:
            outputs = attempt()
        except ModelNotLoadedError:
            # LRU eviction raced between ensure and predict: reload once
            outputs = attempt()
        try:
            body = codec.encode_predict_json_bytes(
                outputs, row_format="instances" in payload, encoding=encoding
            )
        except codec.CodecError as e:
            raise BackendError(str(e), 400) from e
        return RestResponse(status=200, body=body)

    def _rest_status(self, model_id: ModelId) -> RestResponse:
        """ModelService status: runtime-known versions, else disk-cached
        versions as START; 404 when neither knows the model."""
        name, want = model_id.name, model_id.version
        rows = [
            (mid.version, int(state))
            for mid, state in sorted(self.manager.runtime.states_for(name).items())
            if not want or mid.version == want
        ]
        if not rows:
            rows = [
                (mid.version, int(ModelState.START))
                for mid in self.manager.list_cached()
                if mid.name == name and (not want or mid.version == want)
            ]
        if not rows:
            raise BackendError(f"model {name!r} not found", 404)
        out = {
            "model_version_status": [
                {
                    "version": str(version),
                    "state": _STATE_NAMES.get(state, "UNKNOWN"),
                    "status": {"error_code": "OK", "error_message": ""},
                }
                for version, state in rows
            ]
        }
        return RestResponse(status=200, body=json.dumps(out).encode())

    def _rest_metadata(self, model_id: ModelId) -> RestResponse:
        self._ensure(model_id)
        in_spec, out_spec, method_name = self.manager.runtime.signature(model_id)

        def render(spec: Mapping[str, TensorSpec]) -> dict[str, Any]:
            return {
                name: {
                    "dtype": s.dtype,
                    "tensor_shape": {
                        "dim": [
                            {"size": str(-1 if isinstance(d, str) else d)}
                            for d in s.norm_shape()
                        ]
                    },
                    "name": f"{name}:0",
                }
                for name, s in spec.items()
            }

        out = {
            "model_spec": {"name": model_id.name, "version": str(model_id.version)},
            "metadata": {
                "signature_def": {
                    "signature_def": {
                        "serving_default": {
                            "inputs": render(in_spec),
                            "outputs": render(out_spec),
                            "method_name": method_name,
                        }
                    }
                }
            },
        }
        return RestResponse(status=200, body=json.dumps(out).encode())
