"""Tensor wire codecs (counterpart of ``tfservingcache_tpu/protocol/codec.py``):
the REST ``:predict`` JSON body, and ``TensorProto`` <-> numpy for gRPC.

``TensorProto`` needs ``protobuf``: the two functions import the generated
module when called, so this module imports without it. bfloat16 travels as
its 16-bit patterns (``tensor_content`` bytes or the low bits of
``half_val``), held as ``uint16``; numpy has no bfloat16 of its own, so a
decoded bf16 tensor widens to float32, which holds every bf16 value exactly.

Requests: row format ``{"instances": [row, ...]}`` (a row is a value or
``{name: value}``) or columnar ``{"inputs": value-or-{name: value}}``;
``{"b64": ...}`` leaves are byte strings and ``{"b64", "dtype", "shape"}``
objects are raw little-endian tensors. Responses: ``{"predictions": ...}``
(row) or ``{"outputs": ...}`` (columnar); ``"output_encoding": "base64"``
answers columnar with each tensor as ``{"b64", "dtype", "shape"}``.

The native tier (``native/``) does the heavy JSON where it is built: request
bodies are parsed with dense numeric arrays extracted straight into numpy
(``loads_request``), and numeric outputs are written from their buffers
(``encode_predict_json_bytes``), in the shortest round-trip text of their
dtype, byte for byte the reference's body. ``json`` takes the rest.
"""

from __future__ import annotations

import base64
import functools
import json
from typing import Any, Mapping

import numpy as np

from tfservingcache_tpu_torch import native


class CodecError(ValueError):
    pass


# ---------------------------------------------------------------------------
# TensorProto (gRPC)
# ---------------------------------------------------------------------------

@functools.cache
def _wire_tables() -> tuple:
    """-> (the generated ``tf_core_pb2``, DataType -> numpy dtype, numpy
    dtype name -> DataType, DataType -> repeated value field), built at
    first use."""
    from tfservingcache_tpu_torch.protocol.protos import tf_core_pb2 as core

    to_np = {
        core.DT_FLOAT: np.dtype(np.float32), core.DT_DOUBLE: np.dtype(np.float64),
        core.DT_INT32: np.dtype(np.int32), core.DT_UINT8: np.dtype(np.uint8),
        core.DT_INT16: np.dtype(np.int16), core.DT_INT8: np.dtype(np.int8),
        core.DT_INT64: np.dtype(np.int64), core.DT_BOOL: np.dtype(np.bool_),
        core.DT_UINT16: np.dtype(np.uint16), core.DT_UINT32: np.dtype(np.uint32),
        core.DT_UINT64: np.dtype(np.uint64), core.DT_HALF: np.dtype(np.float16),
        core.DT_COMPLEX64: np.dtype(np.complex64),
        core.DT_COMPLEX128: np.dtype(np.complex128),
    }
    from_np = {dt.name: code for code, dt in to_np.items()}
    from_np["bfloat16"] = core.DT_BFLOAT16
    fields = {
        core.DT_FLOAT: "float_val", core.DT_DOUBLE: "double_val",
        core.DT_INT32: "int_val", core.DT_UINT8: "int_val", core.DT_INT16: "int_val",
        core.DT_INT8: "int_val", core.DT_INT64: "int64_val", core.DT_BOOL: "bool_val",
        core.DT_UINT16: "int_val", core.DT_UINT32: "uint32_val",
        core.DT_UINT64: "uint64_val", core.DT_HALF: "half_val",
        core.DT_BFLOAT16: "half_val",
    }
    return core, to_np, from_np, fields


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def numpy_to_tensorproto(arr: np.ndarray):
    """Dense encode through ``tensor_content``; strings through
    ``string_val`` (reference codec.py:65-82). A bfloat16 array (an
    ``ml_dtypes`` one, named so) ships its 2-byte patterns."""
    core, _to_np, from_np, _fields = _wire_tables()
    arr = np.asarray(arr)
    tp = core.TensorProto()
    for d in arr.shape:
        tp.tensor_shape.dim.add(size=int(d))
    if arr.dtype.kind in ("U", "S", "O"):
        tp.dtype = core.DT_STRING
        for item in arr.reshape(-1):
            tp.string_val.append(item.encode() if isinstance(item, str) else bytes(item))
        return tp
    dt = from_np.get(arr.dtype.name) if arr.dtype.isnative else None
    if dt is None:
        raise CodecError(f"unsupported numpy dtype {arr.dtype}")
    tp.dtype = dt
    tp.tensor_content = np.ascontiguousarray(arr).tobytes()
    return tp


def tensorproto_to_numpy(tp) -> np.ndarray:
    """A ``TensorProto`` as a numpy array (reference codec.py:85-128):
    ``tensor_content`` or the dtype's repeated value field, a single value
    filling the whole shape; a bfloat16 tensor comes back as float32."""
    core, to_np, _from_np, fields = _wire_tables()
    if tp.tensor_shape.unknown_rank:
        raise CodecError("unknown-rank tensors are not supported")
    shape = tuple(d.size for d in tp.tensor_shape.dim)
    n = int(np.prod(shape)) if shape else 1
    if tp.dtype == core.DT_STRING:
        vals = [bytes(v) for v in tp.string_val]
        if len(vals) == 1 and n > 1:
            vals = vals * n
        return np.array(vals, dtype=object).reshape(shape)
    bf16 = tp.dtype == core.DT_BFLOAT16
    np_dtype = np.dtype(np.uint16) if bf16 else to_np.get(tp.dtype)
    if np_dtype is None:
        raise CodecError(f"unsupported TensorProto dtype {tp.dtype}")
    if tp.tensor_content:
        arr = np.frombuffer(tp.tensor_content, dtype=np_dtype)
        if arr.size != n:
            raise CodecError(f"tensor_content holds {arr.size} elements, shape needs {n}")
        arr = arr.reshape(shape)
        return _bf16_bits_to_f32(arr) if bf16 else arr.copy()
    field = fields.get(tp.dtype)
    if field is None:
        raise CodecError(f"no value field for dtype {tp.dtype}")
    raw = list(getattr(tp, field))
    if field == "half_val":
        # half and bfloat16 values travel as the low 16 bits of int32s
        arr = np.array(raw, dtype=np.uint16)
        arr = _bf16_bits_to_f32(arr) if bf16 else arr.view(np.float16)
    else:
        arr = np.array(raw, dtype=np_dtype)
    if arr.size == 1 and n > 1:
        arr = np.full(n, arr[0], dtype=arr.dtype)  # single-value fill (TF MakeNdarray)
    if arr.size != n:
        raise CodecError(f"{field} holds {arr.size} elements, shape needs {n}")
    return arr.reshape(shape)


def loads_request(body: bytes):
    """A JSON request body parsed: the native parser (dense numeric subtrees
    arrive as numpy arrays), or ``json.loads`` where the library is not
    built or declines the body. Raises ValueError (``JSONDecodeError`` is
    one) on a malformed body either way."""
    parsed = native.json_parse_request(body)
    if parsed is not None:
        return parsed
    return json.loads(body)


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
    if isinstance(value, np.ndarray):
        # extracted by the native parser: the list path's dtype rules
        if dtype is not None:
            return value.astype(dtype) if value.dtype != dtype else value
        if value.dtype == np.float64:
            return value.astype(np.float32)
        return value
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
        if isinstance(instances, np.ndarray):
            # extracted by the native parser: a dense numeric "instances"
            # array is the single-input row format already stacked
            if instances.size == 0:
                raise CodecError('"instances" must be a non-empty list')
            return {only_name: _value_to_array(instances, input_dtypes.get(only_name))}, signature
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
    if arr.dtype.name in _HALF_DTYPES:
        arr = arr.astype(np.float32)
    return arr.tolist()


# float16, and bfloat16 by name: numpy has no bfloat16 of its own, and an
# array of one (from ml_dtypes) names its dtype so
_HALF_DTYPES = frozenset(("float16", "bfloat16"))
# what the native encoder writes; halfs are upcast to f32 first
_NATIVE_JSON_DTYPES = frozenset(
    ("float32", "float64", "int32", "int64", "bool", "uint8", *_HALF_DTYPES))


def _native_json_supported(arr: np.ndarray) -> bool:
    return arr.dtype.name in _NATIVE_JSON_DTYPES and arr.dtype.isnative


def _native_array_json(arr: np.ndarray) -> bytes | None:
    """Native JSON text of a numeric array; None -> the Python path."""
    if arr.dtype.name in _HALF_DTYPES:
        arr = arr.astype(np.float32)  # as _array_to_json upcasts
    if arr.dtype == object or arr.dtype.kind not in "fiub":
        return None
    return native.json_encode_array(arr)


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
    """The ``:predict`` response body as bytes (reference codec.py:362-407).

    Columnar bodies whose every output the native encoder takes, and
    row-format bodies of one such output, are written by the native encoder
    and spliced into the envelope; everything else (string outputs,
    row-format multi-output bodies, base64, no native library) is
    ``json.dumps`` of ``encode_predict_json``."""
    out = {n: np.asarray(a) for n, a in outputs.items()}
    if encoding == "json" and out:
        if not row_format and all(_native_json_supported(a) for a in out.values()):
            # checked first, so that a body with one string output does not
            # pay the native encode of a large tensor and the fallback too
            pieces = {n: _native_array_json(a) for n, a in out.items()}
            if all(p is not None for p in pieces.values()):
                if len(pieces) == 1:
                    (body,) = pieces.values()
                    return b'{"outputs": ' + body + b"}"
                inner = b", ".join(json.dumps(n).encode() + b": " + p for n, p in pieces.items())
                return b'{"outputs": {' + inner + b"}}"
        elif len(out) == 1:
            (arr,) = out.values()
            body = _native_array_json(arr)
            if body is not None:
                return b'{"predictions": ' + body + b"}"
    return json.dumps(encode_predict_json(outputs, row_format, encoding)).encode()
