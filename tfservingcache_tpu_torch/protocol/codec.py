"""The REST ``:predict`` JSON codec (the JSON half of
``tfservingcache_tpu/protocol/codec.py``, on the standard library's ``json``).

Requests: row format ``{"instances": [row, ...]}`` (a row is a value or
``{name: value}``) or columnar ``{"inputs": value-or-{name: value}}``;
``{"b64": ...}`` leaves are byte strings and ``{"b64", "dtype", "shape"}``
objects are raw little-endian tensors. Responses: ``{"predictions": ...}``
(row) or ``{"outputs": ...}`` (columnar); ``"output_encoding": "base64"``
answers columnar with each tensor as ``{"b64", "dtype", "shape"}``.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Mapping

import numpy as np


class CodecError(ValueError):
    pass


def _json_to_value(obj: Any) -> Any:
    """Recursively turn ``{"b64": ...}`` leaves into bytes."""
    if isinstance(obj, dict):
        if set(obj.keys()) == {"b64"}:
            return base64.b64decode(obj["b64"])
        return {k: _json_to_value(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_to_value(v) for v in obj]
    return obj


def _is_binary_spec(v: Any) -> bool:
    return isinstance(v, dict) and {"b64", "dtype", "shape"} <= set(v.keys())


def _binary_tensor_to_array(spec: Mapping[str, Any], dtype: np.dtype | None = None) -> np.ndarray:
    try:
        dt = np.dtype(spec["dtype"])
        shape = tuple(int(d) for d in spec["shape"])
        raw = base64.b64decode(spec["b64"])
        if dt.kind not in "fiub" or dt.itemsize == 0:
            raise CodecError(f"binary tensors must be numeric, not {dt.name}")
        if any(d < 0 for d in shape):
            raise CodecError(f"binary tensor shape {list(shape)} has negative dims")
        n = int(np.prod(shape)) if shape else 1
        if len(raw) != n * dt.itemsize:
            raise CodecError(
                f"binary tensor holds {len(raw)} bytes, shape {list(shape)} of "
                f"{dt.name} needs {n * dt.itemsize}"
            )
        arr = np.frombuffer(raw, dtype=dt).reshape(shape)
        if dtype is not None and dtype != dt:
            return arr.astype(dtype)
        return arr.copy()
    except CodecError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise CodecError(f"bad binary tensor spec: {e}") from e


def _value_to_array(value: Any, dtype: np.dtype | None) -> np.ndarray:
    if _is_binary_spec(value):
        return _binary_tensor_to_array(value, dtype)
    if isinstance(value, list) and value and all(_is_binary_spec(v) for v in value):
        rows = [_binary_tensor_to_array(v, dtype) for v in value]
        try:
            return np.stack(rows)
        except ValueError as e:
            raise CodecError(f"binary instance rows disagree in shape: {e}") from e
    if isinstance(value, (list, int, float, bool)):
        # dense numeric tensors take one C-level asarray
        try:
            arr = np.asarray(value)
        except (ValueError, TypeError, OverflowError):
            arr = np.empty(0, object)  # ragged/mixed: take the slow path
        if arr.dtype.kind in "fiub":
            if dtype is not None:
                return arr.astype(dtype)
            if arr.dtype == np.float64:
                return arr.astype(np.float32)
            return arr
    value = _json_to_value(value)

    def has_bytes(v: Any) -> bool:
        if isinstance(v, (bytes, str)):
            return True
        if isinstance(v, list) and v:
            return has_bytes(v[0])
        return False

    if has_bytes(value):
        return np.array(value, dtype=object)
    try:
        arr = np.asarray(value)
    except (OverflowError, ValueError) as e:
        raise CodecError(f"input values are not a dense numeric tensor: {e}") from e
    if arr.dtype == object:
        raise CodecError("input values are not a dense numeric tensor")
    if dtype is not None:
        arr = arr.astype(dtype)
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def decode_predict_json(
    body: Mapping[str, Any],
    input_dtypes: Mapping[str, np.dtype] | None = None,
    default_input: str = "inputs",
) -> tuple[dict[str, np.ndarray], str]:
    """Decode a ``:predict`` JSON body -> (named input arrays, signature_name)."""
    if not isinstance(body, Mapping):
        raise CodecError("request body must be a JSON object")
    input_dtypes = dict(input_dtypes or {})
    signature = body.get("signature_name", "serving_default")
    if ("instances" in body) == ("inputs" in body):
        raise CodecError('exactly one of "instances" or "inputs" must be provided')
    only_name = next(iter(input_dtypes)) if len(input_dtypes) == 1 else default_input

    if "instances" in body:
        instances = body["instances"]
        if not isinstance(instances, list) or not instances:
            raise CodecError('"instances" must be a non-empty list')
        if isinstance(instances[0], dict) and "b64" not in instances[0]:
            names = list(instances[0].keys())
            cols: dict[str, list[Any]] = {n: [] for n in names}
            for row in instances:
                if not isinstance(row, dict) or set(row.keys()) != set(names):
                    raise CodecError("all instances must name the same inputs")
                for n in names:
                    cols[n].append(row[n])
            return (
                {n: _value_to_array(v, input_dtypes.get(n)) for n, v in cols.items()},
                signature,
            )
        return {only_name: _value_to_array(instances, input_dtypes.get(only_name))}, signature

    inputs = body["inputs"]
    if isinstance(inputs, dict) and "b64" not in inputs and not _is_binary_spec(inputs):
        return (
            {n: _value_to_array(v, input_dtypes.get(n)) for n, v in inputs.items()},
            signature,
        )
    return {only_name: _value_to_array(inputs, input_dtypes.get(only_name))}, signature


def _array_to_json(arr: np.ndarray) -> Any:
    if arr.dtype == object or arr.dtype.kind in ("S", "U"):
        def enc(v: Any) -> Any:
            if isinstance(v, list):
                return [enc(x) for x in v]
            if isinstance(v, bytes):
                return {"b64": base64.b64encode(v).decode()}
            return str(v)

        return enc(arr.tolist())
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    return arr.tolist()


def _array_to_b64_json(arr: np.ndarray) -> dict[str, Any]:
    """Raw little-endian bytes + dtype + shape (about 4x smaller than JSON
    number lists for an LM's logits, one ``frombuffer`` to decode)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == object or arr.dtype.kind in ("S", "U"):
        raise CodecError("base64 output encoding does not support string outputs")
    return {
        "b64": base64.b64encode(arr.tobytes()).decode(),
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
    }


def encode_predict_json(
    outputs: Mapping[str, np.ndarray], row_format: bool, encoding: str = "json"
) -> dict[str, Any]:
    """Named output arrays as the ``:predict`` response body (a dict)."""
    outputs = dict(outputs)
    if encoding == "base64":
        if len(outputs) == 1:
            (arr,) = outputs.values()
            return {"outputs": _array_to_b64_json(np.asarray(arr))}
        return {"outputs": {n: _array_to_b64_json(np.asarray(a)) for n, a in outputs.items()}}
    if row_format:
        if len(outputs) == 1:
            (arr,) = outputs.values()
            return {"predictions": _array_to_json(np.asarray(arr))}
        arrays = {n: np.asarray(a) for n, a in outputs.items()}
        scalars = [n for n, a in arrays.items() if a.ndim == 0]
        if scalars:
            raise CodecError(
                f"0-d output(s) {scalars} cannot be row-encoded; use the columnar "
                '"inputs" request format for this model'
            )
        batch_sizes = {a.shape[0] for a in arrays.values()}
        if len(batch_sizes) != 1:
            raise CodecError(f"output batch dims disagree: {batch_sizes}")
        (batch,) = batch_sizes
        return {
            "predictions": [
                {n: _array_to_json(a[i]) for n, a in arrays.items()} for i in range(batch)
            ]
        }
    if len(outputs) == 1:
        (arr,) = outputs.values()
        return {"outputs": _array_to_json(np.asarray(arr))}
    return {"outputs": {n: _array_to_json(np.asarray(a)) for n, a in outputs.items()}}


def encode_predict_json_bytes(
    outputs: Mapping[str, np.ndarray], row_format: bool, encoding: str = "json"
) -> bytes:
    """The ``:predict`` response body as bytes."""
    return json.dumps(encode_predict_json(outputs, row_format, encoding)).encode()
