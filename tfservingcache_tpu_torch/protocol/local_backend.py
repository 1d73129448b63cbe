"""LocalServingBackend: the cache node's fulfilment of the REST protocol
(counterpart of ``tfservingcache_tpu/protocol/local_backend.py``: ``:predict``,
``:generate``, model status and metadata). The request is decoded and
answered in-process: ensure the model is servable, run it on the runtime
(or, for ``:generate``, on the continuous engine when one is configured),
encode the outputs.

Methods are synchronous; the REST server runs each request on its own
thread.
"""

from __future__ import annotations

import json
import logging
import secrets
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

log = logging.getLogger("tpusc_torch.backend")

_STATE_NAMES = {s.value: s.name for s in ModelState}

# verbs the reference serves that this port does not yet
_LATER_VERBS = ("classify", "regress")

_STREAM_ON = ("1", "true", "yes", "on")


class LocalServingBackend(ServingBackend):
    def __init__(self, manager: CacheManager, generator: Any = None,
                 spec_draft_model: str = "") -> None:
        self.manager = manager
        # the continuous engine (runtime/batcher.py) when
        # serving.generate_engine == "continuous"; None = the solo path
        self._generator = generator
        # serving.spec_draft_model: the engine attaches the draft only while
        # it is resident, so :generate ensures it beside the target
        self._spec_draft_name = str(spec_draft_model or "")

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
        query: dict[str, str] | None = None,
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
        if method != "POST" or verb not in ("predict", "generate"):
            raise BackendError(f"unsupported {method} {verb or ''} request", 405)
        try:
            payload = json.loads(body or b"{}")
        except ValueError as e:
            raise BackendError(f"invalid JSON body: {e}", 400) from e
        if not isinstance(payload, dict):
            raise BackendError("request body must be a JSON object", 400)
        if verb == "generate":
            return self._rest_generate(model_id, payload, query or {})
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

    def _rest_generate(self, model_id: ModelId, payload: dict,
                       query: dict[str, str]) -> RestResponse:
        """tpusc extension verb ``:generate`` — KV-cached decoding
        (reference local_backend.py:689-927).

        Body: {"input_ids": [[...]], "prompt_lengths": [...]?,
               "max_new_tokens": N?, "temperature": t?, "top_k": k?, "seed": s?,
               "draft_model": "name" | {"name", "version"?}?, "spec_tokens": K?,
               "conversation_id": "..."?, "priority": "high"|"normal"|"low"?}
        Response: {"tokens": [[...]]}, (rows, max_new_tokens) new tokens.

        Without a "seed" or a "draft_model", a request runs on the continuous
        engine when one is configured; a seeded request runs on the solo
        path, reproducibly. A "draft_model" request runs greedy speculative
        decoding on the solo path (``runtime.generate(draft_model_id=...)``):
        an unknown draft is 404, a malformed one or a bad version 400,
        temperature > 0 with a draft 400. "conversation_id" and "priority"
        are validated as the reference validates them and then ignored (the
        conversation tier and priority classes are later slices).
        ``?stream=true`` answers 501 (a later slice)."""
        ids = payload.get("input_ids")
        if not isinstance(ids, list) or not ids:
            raise BackendError('"input_ids" must be a non-empty 2-D list', 400)
        draft_mid = self._draft_model(payload.get("draft_model"))
        conv_id = payload.get("conversation_id")
        if conv_id is not None and (not isinstance(conv_id, str) or not conv_id):
            raise BackendError('"conversation_id" must be a non-empty string', 400)
        if payload.get("priority", "normal") not in ("high", "normal", "low"):
            raise BackendError('"priority" must be one of "high", "normal", "low"', 400)
        if str(query.get("stream", "")).strip().lower() in _STREAM_ON:
            raise BackendError("?stream=true is not served by this port yet", 501)

        def attempt() -> np.ndarray:
            self._ensure(model_id)
            if draft_mid is not None:
                self._ensure(draft_mid)
            elif self._generator is not None:
                self._ensure_engine_draft(model_id)
            try:
                # inside the try: malformed params ("max_new_tokens": "abc")
                # answer 400, not 500
                kwargs = dict(
                    prompt_lengths=payload.get("prompt_lengths"),
                    max_new_tokens=int(payload.get("max_new_tokens", 32)),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_k=int(payload.get("top_k", 0)),
                )
                seed = int(payload["seed"]) if "seed" in payload else None
                arr = np.asarray(ids, np.int32)
                if self._generator is not None and draft_mid is None:
                    return self._generator.generate(model_id, arr, seed=seed, **kwargs)
                return self.manager.runtime.generate(
                    model_id, arr, seed=seed if seed is not None else secrets.randbits(31),
                    draft_model_id=draft_mid,
                    spec_tokens=int(payload.get("spec_tokens", 4)), **kwargs,
                )
            except ModelNotLoadedError:
                raise
            except (RuntimeError_, ValueError, TypeError) as e:
                raise BackendError(str(e), 400) from e
            except TimeoutError as e:
                raise BackendError(str(e), 504) from e

        try:
            tokens = attempt()
        except ModelNotLoadedError:
            # LRU eviction raced between ensure and generate: reload once
            try:
                tokens = attempt()
            except ModelNotLoadedError as e:
                raise BackendError(str(e), 400) from e
        return RestResponse(status=200, body=json.dumps({"tokens": tokens.tolist()}).encode())

    def _draft_model(self, spec: Any) -> ModelId | None:
        """The body's "draft_model" — a name or {"name", "version"?} —
        resolved to a ModelId (reference local_backend.py:715-742)."""
        if spec is None:
            return None
        if isinstance(spec, str):
            name, version = spec, None
        elif isinstance(spec, dict) and spec.get("name"):
            name, version = spec["name"], spec.get("version")
        else:
            raise BackendError('"draft_model" must be a model name or {"name", "version"?}', 400)
        try:
            version = int(version) if version is not None else None
        except (ValueError, TypeError) as e:
            raise BackendError(f'"draft_model" version must be an integer: {e}', 400) from e
        try:
            return ModelId(name, self.manager.resolve_version(name, version))
        except (KeyError, ModelNotFoundError) as e:
            raise BackendError(str(e), 404) from e

    def _ensure_engine_draft(self, model_id: ModelId) -> None:
        """Engine-level spec (serving.spec_draft_model): load the configured
        draft beside the target, best-effort — a missing draft degrades to
        plain decode, it never fails the target's request (reference
        :779-796)."""
        base, _, ver = self._spec_draft_name.partition("@")
        if not base or base == model_id.name:
            return
        try:
            self.manager.ensure_servable(
                ModelId(base, self.manager.resolve_version(base, int(ver) if ver else None)))
        except Exception:  # noqa: BLE001 - speculation is an optimization
            log.debug("spec draft %s not loaded", self._spec_draft_name, exc_info=True)

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
