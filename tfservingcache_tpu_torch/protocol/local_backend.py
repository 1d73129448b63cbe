"""LocalServingBackend: the cache node's fulfilment of the serving protocol
(counterpart of ``tfservingcache_tpu/protocol/local_backend.py``). The
request is decoded and answered in-process: resolve the version (a label
through ``serving.version_labels``), ensure the model is servable, run it on
the runtime (through ``MicroBatcher`` when ``batch_window_ms > 0``; for
``:generate`` on the continuous engine when one is configured, else through
``GenerateCoalescer`` when batching is on), encode the outputs. Request
bodies are parsed and numeric replies written by the native tier where it
is built (``codec.loads_request``, ``codec.encode_predict_json_bytes``).

REST verbs: ``:predict``, ``:classify`` and ``:regress`` (over
``"examples"``), ``:generate``, status and metadata. The gRPC server calls
the message-shaped methods (``predict``, ``classify``, ``regress``,
``get_model_metadata``, ``get_model_status``, ``reload_config``,
``session_run``, ``generate_stream``); they import the generated protobuf
modules when called, so REST needs neither ``grpc`` nor ``protobuf``.
``:classify``/``:regress`` over REST build the reference's arrays from the
JSON examples directly, with the reference's typing of feature lists
(integers as int64, other numbers as f32, the rest as bytes) and its
scores, which travel as f32.

Methods are synchronous; each server runs a request on a thread of its own.
A streamed ``:generate`` (and ``GenerateStream``) is fed by the generate
running on a thread of its own (in the request's trace context). Every
resolved request stamps its trace root with the model and ``route="local"``;
every stream frame written counts in ``tpusc_gen_stream_frames{protocol}``
(reference :215, :987, :1041).
"""

from __future__ import annotations

import contextvars
import json
import logging
import queue
import secrets
import threading
from collections.abc import Callable, Iterator
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping

import numpy as np

from tfservingcache_tpu_torch.cache.manager import CacheManager, VersionLabelError
from tfservingcache_tpu_torch.cache.providers.base import ModelNotFoundError
from tfservingcache_tpu_torch.models.registry import TensorSpec
from tfservingcache_tpu_torch.protocol import codec
from tfservingcache_tpu_torch.protocol.backend import BackendError, RestResponse, ServingBackend
from tfservingcache_tpu_torch.runtime.base import (
    GroupUnhealthyError,
    LoadTimeoutError,
    ModelNotLoadedError,
    RuntimeError_,
)
from tfservingcache_tpu_torch.runtime.batcher import GenerateCoalescer, MicroBatcher
from tfservingcache_tpu_torch.types import ModelId, ModelState
from tfservingcache_tpu_torch.utils.tracing import TRACER

log = logging.getLogger("tpusc_torch.backend")

_STATE_NAMES = {s.value: s.name for s in ModelState}

_STREAM_ON = ("1", "true", "yes", "on")

# the TensorProto DataType names of the signature dtypes (metadata)
_DT_NAMES = {
    "float32": "DT_FLOAT", "float64": "DT_DOUBLE", "int32": "DT_INT32",
    "int64": "DT_INT64", "uint8": "DT_UINT8", "bool": "DT_BOOL", "float16": "DT_HALF",
    "bfloat16": "DT_BFLOAT16", "object": "DT_STRING",
}


def _protos():
    """The generated TF Serving modules (``tf_core_pb2``, ``tf_serving_pb2``),
    imported by the message-shaped methods only."""
    from tfservingcache_tpu_torch.protocol.protos import tf_core_pb2, tf_serving_pb2

    return tf_core_pb2, tf_serving_pb2


def _label_str(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


class LocalServingBackend(ServingBackend):
    def __init__(self, manager: CacheManager, generator: Any = None,
                 spec_draft_model: str = "", batch_window_ms: float = 0.0,
                 batch_max_size: int = 64) -> None:
        self.manager = manager
        # batch_window_ms > 0 turns the batchers on (batches form while the
        # device is busy: no timed window, the knob is the switch; reference
        # local_backend.py:96-124). Up to 4 forwards overlap one another's
        # pad/H2D/D2H; a generate holds the card far longer, so 2 of them.
        if batch_window_ms > 0:
            self._predictor = MicroBatcher(
                manager.runtime, max_batch=batch_max_size, metrics=manager.metrics,
                max_inflight=4,
            )
            self._generator = GenerateCoalescer(
                manager.runtime, max_batch=min(batch_max_size, 32), metrics=manager.metrics,
                max_inflight=2,
            )
        else:
            self._predictor = manager.runtime
            self._generator = None
        # the continuous engine (serving.generate_engine == "continuous")
        # replaces whichever generator batching picked
        if generator is not None:
            self._generator = generator
        # serving.spec_draft_model: the engine attaches the draft only while
        # it is resident, so :generate ensures it beside the target ("" =
        # nothing to ensure, as without the engine)
        self._spec_draft_name = str(spec_draft_model or "") if generator is not None else ""

    def _ensure(self, model_id: ModelId) -> None:
        try:
            self.manager.ensure_servable(model_id)
        except ModelNotFoundError as e:
            raise BackendError(str(e), 404) from e
        except LoadTimeoutError as e:
            raise BackendError(str(e), 504) from e
        except GroupUnhealthyError as e:
            # a torn-down cross-process group fails fast, retriable against
            # a replica (reference local_backend.py:238)
            raise BackendError(str(e), 503, "UNAVAILABLE") from e
        except RuntimeError_ as e:
            raise BackendError(str(e), 500, "FAILED_PRECONDITION") from e

    def _resolve(self, name: str, version: int | None, label: str | None) -> ModelId:
        """The request's model: a label through ``serving.version_labels``
        (412 when unmapped), a missing version as the newest known one;
        stamps the trace root, whose model and route the trace view and the
        duration histogram read."""
        try:
            resolved = self.manager.resolve_version(name, version, label=label)
        except VersionLabelError as e:
            raise BackendError(str(e), 412) from e
        except (KeyError, ModelNotFoundError) as e:
            raise BackendError(str(e), 404) from e
        model_id = ModelId(name, resolved)
        TRACER.annotate_root(model=str(model_id), route="local")
        return model_id

    def handle_rest(
        self,
        method: str,
        model_name: str,
        version: int | None,
        verb: str | None,
        body: bytes,
        label: str | None = None,
        query: dict[str, str] | None = None,
    ) -> RestResponse:
        model_id = self._resolve(model_name, version, label)
        if method == "GET" and verb is None:
            return self._rest_status(model_id)
        if method == "GET" and verb == "metadata":
            return self._rest_metadata(model_id)
        if method != "POST" or verb not in ("predict", "classify", "regress", "generate"):
            raise BackendError(f"unsupported {method} {verb or ''} request", 405)
        try:
            # the native parser extracts dense numeric arrays as numpy
            payload = codec.loads_request(body or b"{}")
        except ValueError as e:
            raise BackendError(f"invalid JSON body: {e}", 400) from e
        if not isinstance(payload, dict):
            raise BackendError("request body must be a JSON object", 400)
        if verb == "generate":
            return self._rest_generate(model_id, payload, query or {})
        if verb == "predict":
            return self._rest_predict(model_id, payload)
        return self._rest_classify_regress(model_id, verb, payload)

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

        def decode() -> dict[str, np.ndarray]:
            in_spec, _, _ = self.manager.runtime.signature(model_id)
            dtypes = {k: s.np_dtype() for k, s in in_spec.items()}
            default_input = next(iter(dtypes)) if len(dtypes) == 1 else "inputs"
            try:
                arrays, _sig = codec.decode_predict_json(payload, dtypes, default_input)
            except codec.CodecError as e:
                raise BackendError(str(e), 400) from e
            return arrays

        outputs = self._predict_sync(model_id, decode, out_filter or None)
        try:
            body = codec.encode_predict_json_bytes(
                outputs, row_format="instances" in payload, encoding=encoding
            )
        except codec.CodecError as e:
            raise BackendError(str(e), 400, "FAILED_PRECONDITION") from e
        return RestResponse(status=200, body=body)

    def _predict_sync(self, model_id: ModelId, inputs: Callable[[], Mapping[str, np.ndarray]],
                      output_filter: list[str] | None) -> dict[str, np.ndarray]:
        """Ensure, decode (``inputs()``, which may read the loaded model's
        signature), predict; an LRU eviction that races between ensure and
        predict reloads once (reference :218-242)."""
        def attempt() -> dict[str, np.ndarray]:
            self._ensure(model_id)
            arrays = inputs()
            try:
                return self._predictor.predict(model_id, arrays, output_filter)
            except ModelNotLoadedError:
                raise
            except GroupUnhealthyError as e:
                raise BackendError(str(e), 503, "UNAVAILABLE") from e
            except RuntimeError_ as e:
                raise BackendError(str(e), 400, "FAILED_PRECONDITION") from e

        try:
            return attempt()
        except ModelNotLoadedError:
            return attempt()

    def _prepare_generate(self, model_id: ModelId, payload: dict):
        """Validate a ``:generate`` payload and build its runner (reference
        local_backend.py:689-872). -> ``(run, rows)``: ``run(on_token=None)``
        ensures the model(s) and runs the whole generate, returning the
        padded token matrix; ``rows`` is the request's row count. Client
        input is validated HERE, before a streamed reply ships its status
        line; an error inside ``run`` ends a stream with an error frame."""
        ids = payload.get("input_ids")
        if isinstance(ids, np.ndarray):
            # extracted by the native parser; float arrays stay admissible,
            # as on the list path (the int32 conversion truncates either way)
            if ids.size == 0 or ids.dtype.kind not in "iuf":
                raise BackendError('"input_ids" must be a non-empty 2-D list of token ids', 400)
        elif not isinstance(ids, list) or not ids:
            raise BackendError('"input_ids" must be a non-empty 2-D list', 400)
        draft_mid = self._draft_model(payload.get("draft_model"))
        conv_id = payload.get("conversation_id")
        if conv_id is not None and (not isinstance(conv_id, str) or not conv_id):
            raise BackendError('"conversation_id" must be a non-empty string', 400)
        priority = payload.get("priority", "normal")
        if priority not in ("high", "normal", "low"):
            raise BackendError('"priority" must be one of "high", "normal", "low"', 400)
        try:
            rows = int(np.atleast_2d(np.asarray(ids)).shape[0])
        except (ValueError, TypeError):
            rows = len(ids)  # ragged rows: run()'s own int32 conversion answers 400
        gen = self._generator

        def attempt(on_token) -> np.ndarray:
            self._ensure(model_id)
            if draft_mid is not None:
                self._ensure(draft_mid)
            elif gen is not None:
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
                if isinstance(gen, GenerateCoalescer) and draft_mid is None:
                    # the coalescer has neither priority classes, a
                    # conversation tier nor a live token callback: a stream
                    # replays the finished row (_stream_events)
                    return gen.generate(model_id, arr, seed=seed, **kwargs)
                if gen is not None and draft_mid is None:
                    return gen.generate(
                        model_id, arr, seed=seed, conversation_id=conv_id, priority=priority,
                        on_token=on_token, **kwargs)
                return self.manager.runtime.generate(
                    model_id, arr, seed=seed if seed is not None else secrets.randbits(31),
                    draft_model_id=draft_mid,
                    spec_tokens=int(payload.get("spec_tokens", 4)), **kwargs,
                )
            except ModelNotLoadedError:
                raise
            except GroupUnhealthyError as e:
                raise BackendError(str(e), 503, "UNAVAILABLE") from e
            except RuntimeError_ as e:
                raise BackendError(str(e), 400, "FAILED_PRECONDITION") from e
            except (ValueError, TypeError) as e:
                raise BackendError(str(e), 400) from e
            except TimeoutError as e:
                raise BackendError(str(e), 504) from e

        def run(on_token: Callable[[int], None] | None = None) -> np.ndarray:
            try:
                return attempt(on_token)
            except ModelNotLoadedError:
                # LRU eviction raced between ensure and generate: reload once
                try:
                    return attempt(on_token)
                except ModelNotLoadedError as e:
                    raise BackendError(str(e), 400, "FAILED_PRECONDITION") from e

        return run, rows

    def _rest_generate(self, model_id: ModelId, payload: dict,
                       query: dict[str, str]) -> RestResponse:
        """tpusc extension verb ``:generate`` — KV-cached decoding
        (reference local_backend.py:874-927).

        Body: {"input_ids": [[...]], "prompt_lengths": [...]?,
               "max_new_tokens": N?, "temperature": t?, "top_k": k?, "seed": s?,
               "draft_model": "name" | {"name", "version"?}?, "spec_tokens": K?,
               "conversation_id": "..."?, "priority": "high"|"normal"|"low"?}
        Response: {"tokens": [[...]]}, (rows, max_new_tokens) new tokens.

        Without a "draft_model", a request runs on the continuous engine when
        one is configured, else through the coalescer when batching is on
        (``batch_window_ms > 0``: concurrent unseeded requests with one key
        share one solo-path generate), else on the solo path; a seeded
        request runs solo on each, reproducibly. A "draft_model" request
        runs greedy speculative decoding on the solo path
        (``runtime.generate(draft_model_id=...)``): an unknown draft is 404,
        a malformed one or a bad version 400, temperature > 0 with a draft
        400. "conversation_id" parks the row's decode state at retirement
        and resumes the conversation's next turn from it
        (``serving.conversation_kv_bytes`` > 0, continuous engine);
        "priority" orders the engine's admission by class and lets a higher
        class preempt a lower decoding lane. Both are ignored elsewhere.

        ``?stream=true`` (single-row requests only; more rows answer 400
        before any 200) answers with Server-Sent Events: a ``{"token": t}``
        frame per token as the engine samples it, then ``{"done": true,
        "tokens": [[...]]}`` carrying the buffered body's matrix, or an
        ``{"error": ...}`` frame when the generate fails after the 200. The
        coalescer, solo, seeded and "draft_model" paths replay the finished
        row as frames. The port bounds no request end to end (the engine's
        wait timeout bounds the wait for rows), streams included."""
        stream = str(query.get("stream", "")).strip().lower() in _STREAM_ON
        run, rows = self._prepare_generate(model_id, payload)
        if not stream:
            tokens = run()
            return RestResponse(status=200,
                                body=json.dumps({"tokens": tokens.tolist()}).encode())
        if rows != 1:
            raise BackendError("?stream=true requires a single-row request", 400)
        return RestResponse(
            status=200, body=b"", content_type="text/event-stream",
            headers={"Cache-Control": "no-cache"},
            # the generate's thread runs in this request's trace context
            token_stream=_sse_frames(_stream_events(run, contextvars.copy_context()),
                                     self.manager.metrics),
        )

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

    def _status_rows(self, name: str, want: int) -> list[tuple[int, int]]:
        """ModelService status as (version, state) rows: the runtime's
        versions, else the disk-cached ones as START; 404 when neither knows
        the model (reference :497-521)."""
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
        return rows

    def _rest_status(self, model_id: ModelId) -> RestResponse:
        out = {
            "model_version_status": [
                {
                    "version": str(version),
                    "state": _STATE_NAMES.get(state, "UNKNOWN"),
                    "status": {"error_code": "OK", "error_message": ""},
                }
                for version, state in self._status_rows(model_id.name, model_id.version)
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

    # -- :classify / :regress ----------------------------------------------
    def _rest_classify_regress(self, model_id: ModelId, verb: str,
                               payload: dict) -> RestResponse:
        """``{"examples": [{feature: value(s)}, ...]}`` -> ``{"results":
        [[[label, score], ...], ...]}`` (classify) or ``{"results": [value,
        ...]}`` (regress), the reference's bodies (:1045-1082) byte for
        byte: each example's features typed as the reference's
        ``tf.Example`` would hold them, scores and values as f32."""
        examples = payload.get("examples")
        if not isinstance(examples, list) or not examples:
            raise BackendError('"examples" must be a non-empty list', 400)
        rows = [_example_features(ex) for ex in examples]
        if verb == "classify":
            results = [[[label, float(np.float32(score))] for label, score in row]
                       for row in self._classify_sync(model_id, rows)]
        else:
            results = [float(np.float32(v)) for v in self._regress_sync(model_id, rows)]
        return RestResponse(status=200, body=json.dumps({"results": results}).encode())

    def _examples_to_inputs(self, rows: list[dict[str, list]],
                            spec: Mapping[str, TensorSpec]) -> dict[str, np.ndarray]:
        """Feature rows (one ``{name: value list}`` per example) as named
        input arrays: a one-value list is its value, columns cast to the
        signature's dtype (reference :349-385). A feature whose input has a
        fixed shape past the batch axis (an image) arrives as the flat list
        a ``tf.Example`` holds; it takes that shape, as TF Serving parses a
        fixed-length feature (the reference passes it on flat, and the
        model refuses it: ROADMAP C9)."""
        if not rows:
            raise BackendError("Input contains no examples", 400)
        columns: dict[str, list[Any]] = {}
        for feats in rows:
            for fname, val in feats.items():
                columns.setdefault(fname, []).append(val[0] if len(val) == 1 else val)
        arrays: dict[str, np.ndarray] = {}
        for fname, col in columns.items():
            s = spec.get(fname)
            try:
                if s is not None and s.dtype != "object":
                    arrays[fname] = np.asarray(col, dtype=s.np_dtype())
                else:
                    arrays[fname] = np.asarray(col)
            except ValueError as e:
                # ragged feature lists across examples: a client error
                raise BackendError(
                    f"feature {fname!r} has inconsistent lengths across examples: {e}", 400
                ) from e
            fixed = s.norm_shape()[1:] if s is not None else ()
            arr = arrays[fname]
            if (fixed and all(isinstance(d, int) for d in fixed) and arr.ndim >= 1
                    and arr.shape[1:] != fixed
                    and int(np.prod(arr.shape[1:])) == int(np.prod(fixed))):
                arrays[fname] = arr.reshape((arr.shape[0], *fixed))
        return arrays

    def _predict_examples(self, model_id: ModelId, rows: list[dict[str, list]],
                          wanted) -> dict[str, np.ndarray]:
        """Ensure, decode the examples against the signature, predict the
        outputs ``wanted(out_spec)`` names; an eviction that races reloads
        once. The runtime's own errors pass through, as in the reference."""
        self._ensure(model_id)
        in_spec, out_spec, _ = self.manager.runtime.signature(model_id)
        arrays = self._examples_to_inputs(rows, in_spec)
        names = wanted(out_spec)
        try:
            return self._predictor.predict(model_id, arrays, names)
        except ModelNotLoadedError:
            self._ensure(model_id)
            return self._predictor.predict(model_id, arrays, names)

    def _classify_sync(self, model_id: ModelId,
                       rows: list[dict[str, list]]) -> list[list[tuple[str, Any]]]:
        """-> per example, (label, score) for every class (reference
        :387-424): the scores output, else a float64 softmax of the logits;
        labels from a ``labels`` output (per example or shared), else the
        class index."""
        # the concrete outputs, which a family's default (an LM's
        # last_token_logits) would otherwise drop
        outputs = self._predict_examples(
            model_id, rows,
            lambda out: [n for n in ("scores", "logits", "labels") if n in out] or None)
        scores = outputs.get("scores")
        if scores is None and "logits" in outputs:
            logits = outputs["logits"].astype(np.float64)
            e = np.exp(logits - logits.max(axis=-1, keepdims=True))
            scores = e / e.sum(axis=-1, keepdims=True)
        if scores is None:
            raise BackendError(
                f"model {model_id} has no 'scores'/'logits' output for Classify", 400,
                "FAILED_PRECONDITION")
        labels = outputs.get("labels")
        result = []
        for i, row in enumerate(np.atleast_2d(scores)):
            classes = []
            for j, score in enumerate(row):
                if labels is None:
                    label = str(j)
                elif np.ndim(labels) >= 2:
                    label = _label_str(labels[i][j])  # per-example label rows
                else:
                    label = _label_str(labels[j])     # one shared label vector
                classes.append((label, float(score)))
            result.append(classes)
        return result

    def _regress_sync(self, model_id: ModelId, rows: list[dict[str, list]]) -> list[float]:
        """-> one value a prediction element (reference :437-453): the
        signature's ``outputs``, else its first output, asked for by name."""
        (values,) = self._predict_examples(
            model_id, rows,
            lambda out: ["outputs" if "outputs" in out else next(iter(out))]).values()
        return [float(v) for v in np.asarray(values, np.float64).reshape(-1)]

    # -- the gRPC surface (protobuf messages in and out) --------------------
    def _model_id(self, spec) -> ModelId:
        """A request's ModelSpec resolved: ``version_label`` (the
        ``version_choice`` oneof) through ``serving.version_labels`` or
        FAILED_PRECONDITION, an unset version as the newest (reference
        :191-216)."""
        if not spec.name:
            raise BackendError("model_spec.name is required", 400)
        label = (spec.version_label
                 if spec.WhichOneof("version_choice") == "version_label" else None)
        return self._resolve(spec.name, spec.version.value or None, label)

    @staticmethod
    def _stamp(resp, model_id: ModelId):
        resp.model_spec.name = model_id.name
        resp.model_spec.version.value = model_id.version
        return resp

    def _tensor_inputs(self, request) -> dict[str, np.ndarray]:
        try:
            return {k: codec.tensorproto_to_numpy(v) for k, v in request.inputs.items()}
        except codec.CodecError as e:
            raise BackendError(str(e), 400) from e

    def predict(self, request):
        """Predict; ``signature_name="generate"`` routes to the generate
        core (reference :257-282)."""
        _, sv = _protos()
        model_id = self._model_id(request.model_spec)
        inputs = self._tensor_inputs(request)
        if request.model_spec.signature_name == "generate":
            return self._predict_generate(model_id, inputs)
        outputs = self._predict_sync(model_id, lambda: inputs,
                                     list(request.output_filter) or None)
        resp = self._stamp(sv.PredictResponse(), model_id)
        if request.model_spec.signature_name:
            resp.model_spec.signature_name = request.model_spec.signature_name
        for name, arr in outputs.items():
            resp.outputs[name].CopyFrom(codec.numpy_to_tensorproto(arr))
        return resp

    def _generate_payload(self, inputs: Mapping[str, np.ndarray]) -> dict[str, Any]:
        """Generate-signature tensors as the REST ``:generate`` body
        (reference :284-323): ``input_ids`` (2-D), ``prompt_lengths``
        (1-D), int scalars ``max_new_tokens``/``top_k``/``seed``/
        ``spec_tokens``, float ``temperature``, string ``conversation_id``/
        ``priority``."""
        if "input_ids" not in inputs:
            raise BackendError('generate signature requires an "input_ids" input tensor', 400)
        payload: dict[str, Any] = {"input_ids": np.atleast_2d(np.asarray(inputs["input_ids"]))}
        if "prompt_lengths" in inputs:
            payload["prompt_lengths"] = [
                int(x) for x in np.asarray(inputs["prompt_lengths"]).reshape(-1)]

        def scalar(name: str) -> Any:
            arr = np.asarray(inputs[name]).reshape(-1)
            if arr.size != 1:
                raise BackendError(f'generate input "{name}" must be a scalar', 400)
            return arr[0]

        for key in ("max_new_tokens", "top_k", "seed", "spec_tokens"):
            if key in inputs:
                payload[key] = int(scalar(key))
        if "temperature" in inputs:
            payload["temperature"] = float(scalar("temperature"))
        for key in ("conversation_id", "priority"):
            if key in inputs:
                v = scalar(key)
                payload[key] = v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)
        return payload

    def _predict_generate(self, model_id: ModelId, inputs: Mapping[str, np.ndarray]):
        """Predict(signature_name="generate") -> one ``tokens`` (rows,
        max_new_tokens) int32 output (reference :325-346)."""
        _, sv = _protos()
        run, _rows = self._prepare_generate(model_id, self._generate_payload(inputs))
        tokens = np.asarray(run(), np.int32)
        resp = self._stamp(sv.PredictResponse(), model_id)
        resp.model_spec.signature_name = "generate"
        resp.outputs["tokens"].CopyFrom(codec.numpy_to_tensorproto(tokens))
        return resp

    def generate_stream(self, request) -> Iterator[Any]:
        """GenerateStream: Predict(signature_name="generate")'s contract,
        one PredictResponse a sampled token (scalar int32 ``token``), then
        one carrying the padded ``tokens`` matrix; single-row requests only
        (reference :1006-1043)."""
        _, sv = _protos()
        model_id = self._model_id(request.model_spec)
        run, rows = self._prepare_generate(
            model_id, self._generate_payload(self._tensor_inputs(request)))
        if rows != 1:
            raise BackendError("GenerateStream requires a single-row request", 400)
        m = self.manager.metrics
        for kind, val in _stream_events(run, contextvars.copy_context()):
            resp = self._stamp(sv.PredictResponse(), model_id)
            resp.model_spec.signature_name = "generate"
            resp.outputs["token" if kind == "tok" else "tokens"].CopyFrom(
                codec.numpy_to_tensorproto(np.asarray(val, np.int32)))
            if m is not None:
                m.gen_stream_frames.labels("grpc").inc()
            yield resp

    def _proto_features(self, inp) -> list[dict[str, list]]:
        if inp.WhichOneof("kind") == "example_list_with_context":
            examples = inp.example_list_with_context.examples
        else:
            examples = inp.example_list.examples
        rows = []
        for ex in examples:
            feats: dict[str, list] = {}
            for fname, feat in ex.features.feature.items():
                kind = feat.WhichOneof("kind")
                feats[fname] = list(getattr(feat, kind).value) if kind else []
            rows.append(feats)
        return rows

    def classify(self, request):
        _, sv = _protos()
        model_id = self._model_id(request.model_spec)
        resp = self._stamp(sv.ClassificationResponse(), model_id)
        for row in self._classify_sync(model_id, self._proto_features(request.input)):
            cls = resp.result.classifications.add()
            for label, score in row:
                cls.classes.add(label=label, score=score)
        return resp

    def regress(self, request):
        _, sv = _protos()
        model_id = self._model_id(request.model_spec)
        resp = self._stamp(sv.RegressionResponse(), model_id)
        for v in self._regress_sync(model_id, self._proto_features(request.input)):
            resp.result.regressions.add(value=v)
        return resp

    def get_model_metadata(self, request):
        core, sv = _protos()
        model_id = self._model_id(request.model_spec)
        self._ensure(model_id)
        in_spec, out_spec, method = self.manager.runtime.signature(model_id)
        sig = core.SignatureDef(method_name=method)
        for target, spec in ((sig.inputs, in_spec), (sig.outputs, out_spec)):
            for name, s in spec.items():
                info = target[name]
                info.name = f"{name}:0"
                info.dtype = getattr(core, _DT_NAMES.get(s.dtype, "DT_INVALID"))
                for d in s.norm_shape():
                    info.tensor_shape.dim.add(size=-1 if isinstance(d, str) else d)
        resp = self._stamp(sv.GetModelMetadataResponse(), model_id)
        sdm = sv.SignatureDefMap()
        sdm.signature_def["serving_default"].CopyFrom(sig)
        resp.metadata["signature_def"].Pack(sdm)
        return resp

    def get_model_status(self, request):
        _, sv = _protos()
        resp = sv.GetModelStatusResponse()
        for version, state in self._status_rows(request.model_spec.name,
                                                request.model_spec.version.value):
            resp.model_version_status.add(version=version, state=state)
        return resp

    def reload_config(self, request):
        """Make every model of the config servable, with the
        ServableVersionPolicy oneof: ``specific`` versions, the ``latest``
        N, ``all``, or unset = the latest (reference :523-563). An unknown
        model answers status NOT_FOUND (5), failed loads INTERNAL (13)."""
        _, sv = _protos()
        resp = sv.ReloadConfigResponse()
        targets: list[ModelId] = []
        for mc in request.config.model_config_list.config:
            policy = mc.model_version_policy
            which = policy.WhichOneof("policy_choice")
            try:
                if which == "specific":
                    versions = [self.manager.resolve_version(mc.name, v or None)
                                for v in (list(policy.specific.versions) or [0])]
                elif which == "latest":
                    n = policy.latest.num_versions or 1
                    versions = self.manager.available_versions(mc.name)[-n:]
                elif which == "all":
                    versions = self.manager.available_versions(mc.name)
                else:
                    versions = [self.manager.resolve_version(mc.name, None)]
            except (KeyError, ModelNotFoundError) as e:
                resp.status.error_code = 5  # NOT_FOUND
                resp.status.error_message = str(e)
                return resp
            targets.extend(ModelId(mc.name, v) for v in versions)
        def ensure(mid: ModelId) -> Exception | None:
            try:
                self._ensure(mid)
            except Exception as e:  # noqa: BLE001 - reported in the status
                return e
            return None

        errors = []
        if targets:
            ctx = contextvars.copy_context()  # the loads' spans join the request's trace
            with ThreadPoolExecutor(max_workers=min(16, len(targets)),
                                    thread_name_prefix="tpusc-reload") as pool:
                errors = [e for e in pool.map(lambda mid: ctx.copy().run(ensure, mid), targets)
                          if e is not None]
        if errors:
            resp.status.error_code = 13  # INTERNAL
            resp.status.error_message = "; ".join(str(e) for e in errors[:3])
        return resp

    def session_run(self, request):
        _, sv = _protos()
        model_id = self._model_id(request.model_spec)

        def feeds() -> dict[str, np.ndarray]:
            try:
                return {f.name.split(":")[0]: codec.tensorproto_to_numpy(f.tensor)
                        for f in request.feed}
            except codec.CodecError as e:
                raise BackendError(str(e), 400) from e

        outputs = self._predict_sync(
            model_id, feeds, [f.split(":")[0] for f in request.fetch] or None)
        resp = sv.SessionRunResponse()
        for name, arr in outputs.items():
            t = resp.tensor.add()
            t.name = f"{name}:0"
            t.tensor.CopyFrom(codec.numpy_to_tensorproto(arr))
        return resp


def _example_features(example: Any) -> dict[str, list]:
    """One JSON example's features as the reference's ``tf.Example`` holds
    them (:1054-1068): all-integer values an int64 list, other numbers a
    float list (f32), anything else a bytes list."""
    if not isinstance(example, dict):
        raise BackendError("each example must be a JSON object of features", 400)
    feats: dict[str, list] = {}
    for fname, val in example.items():
        if isinstance(val, np.ndarray):  # extracted by the native parser
            val = val.tolist()
        vals = val if isinstance(val, list) else [val]
        if all(isinstance(v, (int, np.integer)) for v in vals):
            feats[fname] = [int(v) for v in vals]
        elif all(isinstance(v, (int, float, np.floating)) for v in vals):
            feats[fname] = [float(np.float32(v)) for v in vals]
        else:
            feats[fname] = [v.encode() if isinstance(v, str) else bytes(v) for v in vals]
    return feats


def _stream_events(run: Callable, ctx: contextvars.Context) -> Iterator[tuple[str, Any]]:
    """Run a prepared generate on a thread of its own; yield ``("tok", t)``
    as the engine samples each token, then ``("end", rows)``. The engine's
    ``on_token`` fires on its scheduler thread, so a queue is the seam. A
    path with no callback emits nothing until it finishes, so the finished
    row is replayed as tokens: every path speaks the same frames. A failed
    generate raises here, after the frames already sent. Closing the
    iterator (the client went away) leaves the generate to finish."""
    q: queue.Queue = queue.Queue()

    def worker() -> None:
        try:
            out = run(lambda t: q.put(("tok", int(t))))
            q.put(("end", np.atleast_2d(np.asarray(out)).tolist()))
        except BaseException as e:  # noqa: BLE001 - forwarded to the client
            q.put(("err", e))

    threading.Thread(target=ctx.run, args=(worker,), daemon=True,
                     name="tpusc-generate-stream").start()
    streamed = 0
    while True:
        kind, val = q.get()
        if kind == "tok":
            streamed += 1
            yield kind, val
        elif kind == "end":
            if streamed == 0 and val and val[0]:
                for t in val[0]:
                    yield "tok", int(t)
            yield kind, val
            return
        else:
            raise val


def _sse_frames(events: Iterator[tuple[str, Any]], metrics: Any = None) -> Iterator[bytes]:
    """``_stream_events`` as SSE byte frames, each token frame and the done
    frame counted; a failure after the status line can only end the stream
    with an error frame."""
    try:
        for kind, val in events:
            if metrics is not None:
                metrics.gen_stream_frames.labels("sse").inc()
            if kind == "tok":
                yield b'data: {"token": %d}\n\n' % val
            else:
                yield b"data: " + json.dumps({"done": True, "tokens": val}).encode() + b"\n\n"
    except Exception as e:  # noqa: BLE001 - the status already shipped
        log.warning("generate stream aborted: %s", e)
        yield b"data: " + json.dumps({"error": str(e) or type(e).__name__}).encode() + b"\n\n"
