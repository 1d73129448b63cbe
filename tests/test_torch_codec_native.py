"""The port's REST codec on the native tier (protocol/codec.py over
native/) against the JAX package's codec: response bodies byte for byte
(hypothesis-drawn outputs of every dtype the native encoder takes, 0-d,
empty and non-contiguous arrays, NaN and +-inf, row and columnar,
multi-output, base64), and parsed request bodies tree for tree, every
extracted array equal in dtype, shape and values."""

import json
import random

import ml_dtypes
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from tfservingcache_tpu.protocol import codec as jcodec
from tfservingcache_tpu_torch import native
from tfservingcache_tpu_torch.protocol import codec
from tfservingcache_tpu_torch.protocol.backend import BackendError
from tfservingcache_tpu_torch.protocol.local_backend import LocalServingBackend
from tfservingcache_tpu_torch.runtime.fake import FakeRuntime

# what the native encoder writes (halfs upcast to f32 first)
NATIVE_DTYPES = ["float32", "float64", "int32", "int64", "bool", "uint8", "float16", "bfloat16"]

HYP = settings(max_examples=80, deadline=None, derandomize=True, database=None,
               suppress_health_check=[HealthCheck.too_slow])


def _dtype(name: str) -> np.dtype:
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" else np.dtype(name)


@st.composite
def output_arrays(draw, dtype_names=NATIVE_DTYPES):
    name = draw(st.sampled_from(dtype_names))
    dt = _dtype(name)
    # bf16 through float32 elements (hypothesis has no bfloat16 strategy)
    base = np.dtype(np.float32) if name == "bfloat16" else dt
    shape = draw(hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=5))
    arr = draw(hnp.arrays(base, shape)).astype(dt)
    layout = draw(st.sampled_from(["c", "transposed", "strided"]))
    if layout == "transposed" and arr.ndim >= 2:
        arr = arr.T
    elif layout == "strided" and arr.ndim >= 1:
        arr = arr[::2]
    return arr


@st.composite
def output_sets(draw):
    n = draw(st.integers(1, 3))
    names = draw(st.lists(st.sampled_from(["y", "logits", "a", "b\"q", "ü"]),
                          min_size=n, max_size=n, unique=True))
    return {name: draw(output_arrays()) for name in names}


def _encode(mod, outputs, row_format, encoding):
    try:
        return mod.encode_predict_json_bytes(outputs, row_format=row_format, encoding=encoding)
    except mod.CodecError as e:
        return ("CodecError", str(e))


def test_the_native_encoder_is_active_here():
    assert native.active_path() == "native"


@HYP
@given(outputs=output_sets(), row_format=st.booleans(),
       encoding=st.sampled_from(["json", "json", "base64"]))
def test_encoded_bodies_are_byte_identical_to_the_reference(outputs, row_format, encoding):
    assert _encode(codec, outputs, row_format, encoding) == \
        _encode(jcodec, outputs, row_format, encoding)


@pytest.mark.parametrize("row_format", [False, True])
@pytest.mark.parametrize("outputs", [
    {"y": np.arange(12, dtype=np.float32).reshape(3, 4) / 7},
    {"y": np.array([[1, -2], [3, 4]], np.int64)},
    {"y": np.array([True, False])},
    {"y": np.float32(2.5)},                                    # 0-d
    {"y": np.zeros((2, 0, 3), np.float32)},                    # an empty dim
    {"y": np.arange(24, dtype=np.float64).reshape(4, 6)[:, ::3]},  # non-contiguous
    {"a": np.ones((2, 2), np.float32), "b": np.arange(2, dtype=np.int32)},
    {"y": np.array([[0.1, np.nan], [np.inf, -np.inf]], np.float32)},
    {"y": np.array([1.5, 2.25], ml_dtypes.bfloat16)},
    {"y": np.array([0.1, 65504.0], np.float16)},
    {"y": (np.arange(300) % 256).astype(np.uint8).reshape(3, 100)},
    {"y": np.random.default_rng(0).standard_normal((2, 32000)).astype(np.float32)},
])
def test_reference_cases_are_byte_identical(outputs, row_format):
    for encoding in ("json", "base64"):
        assert _encode(codec, outputs, row_format, encoding) == \
            _encode(jcodec, outputs, row_format, encoding)


def test_float_text_is_the_shortest_round_trip_of_the_source_dtype():
    """f32 0.1 is written ``0.1`` (``json.dumps`` of its double would write
    ``0.10000000149011612``), and an integral float keeps its ``.0``."""
    body = codec.encode_predict_json_bytes({"y": np.float32([0.1, 3])}, row_format=True)
    assert body == b'{"predictions": [0.1, 3.0]}'
    assert json.dumps(float(np.float32(0.1))) == "0.10000000149011612"
    back = np.asarray(json.loads(body)["predictions"], np.float32)
    np.testing.assert_array_equal(back, np.float32([0.1, 3]))


def test_string_outputs_take_the_python_path(monkeypatch):
    """A body with a string output never reaches the native encoder (the
    supportability check comes first) and is ``json.dumps``'s, as the
    reference writes it."""
    calls = []
    monkeypatch.setattr(native, "json_encode_array", lambda a: calls.append(a) or None)
    for outputs in ({"s": np.array([b"ab", b"cd"], object)},
                    {"s": np.array(["x", "y"]), "f": np.ones((2, 70), np.float32)}):
        for row_format in (False, True):
            try:
                got = codec.encode_predict_json_bytes(outputs, row_format)
            except codec.CodecError as e:
                got = str(e)
            try:
                want = jcodec.encode_predict_json_bytes(outputs, row_format)
            except jcodec.CodecError as e:
                want = str(e)
            assert got == want
    assert calls == []


def test_non_native_byte_order_and_the_missing_library_take_the_python_path(monkeypatch):
    out = {"y": np.array([1.5, 2.5], ">f4")}
    assert codec.encode_predict_json_bytes(out, False) == b'{"outputs": [1.5, 2.5]}'
    monkeypatch.setattr(native, "json_encode_array", lambda a: None)
    out = {"y": np.arange(6, dtype=np.float32).reshape(2, 3)}
    assert json.loads(codec.encode_predict_json_bytes(out, False)) == {
        "outputs": [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]}


def test_the_encoder_retries_when_its_first_buffer_is_short():
    # few elements of the widest text: the first guess is too small, so the
    # C side answers -(needed) and the wrapper retries
    a = np.array([-2.2250738585072014e-308] * 4, np.float64)
    body = native.json_encode_array(a)
    assert body == json.dumps(a.tolist()).encode()
    assert body == jcodec.encode_predict_json_bytes({"y": a}, True)[len(b'{"predictions": '):-1]


# -- the request parser ------------------------------------------------------

def _same(got, want, path="$"):
    """Trees equal, every array equal in dtype, shape and values (NaN-aware)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want), path
        assert got == want or (got != got and want != want), path


def _gen_value(rng: random.Random, depth: int):
    kinds = ["num", "int", "str", "bool", "null", "numlist"]
    if depth < 4:
        kinds += ["obj", "arr", "numlist2d"]
    k = rng.choice(kinds)
    if k == "num":
        return round(rng.uniform(-1e6, 1e6), rng.randint(0, 6))
    if k == "int":
        return rng.randint(-10**12, 10**12)
    if k == "str":
        return "".join(rng.choice('ab\\"\n\té 0:') for _ in range(rng.randint(0, 8)))
    if k == "bool":
        return rng.random() < 0.5
    if k == "null":
        return None
    if k == "numlist":
        n = rng.choice([0, 3, 63, 64, 70])  # either side of the 64-element gate
        return [rng.choice([rng.randint(-9, 9), rng.uniform(-1, 1)]) for _ in range(n)]
    if k == "numlist2d":
        rows, cols = rng.randint(1, 3), rng.choice([2, 40])
        out = [[rng.uniform(-1, 1) for _ in range(cols)] for _ in range(rows)]
        if rng.random() < 0.3 and rows > 1:
            out[-1] = out[-1][:-1]  # ragged: declined, never corrupted
        return out
    if k == "obj":
        return {f"k{i}": _gen_value(rng, depth + 1) for i in range(rng.randint(0, 4))}
    return [_gen_value(rng, depth + 1) for _ in range(rng.randint(0, 4))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parsed_requests_equal_the_references(seed):
    """Seeded bodies (nested objects, dense and ragged numeric lists either
    side of the extraction gate, escapes, predict and generate envelopes):
    the port's ``loads_request`` gives the reference's tree."""
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    bodies = [json.dumps(_gen_value(rng, 0)).encode() for _ in range(150)]
    bodies += [
        json.dumps({"instances": np_rng.integers(0, 32000, (2, 128)).tolist()}).encode(),
        json.dumps({"inputs": {"x": np_rng.standard_normal((3, 40)).tolist()},
                    "output_filter": ["logits"]}).encode(),
        json.dumps({"input_ids": [np_rng.integers(1, 500, 100).tolist()],
                    "max_new_tokens": 32, "prompt_lengths": [100]}).encode(),
    ]
    for body in bodies:
        _same(codec.loads_request(body), jcodec.loads_request(body))


def test_the_references_parser_repro_bodies():
    """The bodies of tests/test_codec.py that broke the reference's first
    parser draft (count collisions, a depth bomb, a 33-dim array) and its
    parity bodies: the same trees as the reference and as ``json.loads``."""
    bodies = [
        b'{"x": [[1,2],[' + json.dumps([list(range(32))] * 2).encode() + b']], "y": 5}',
        b'{"a":' * 65 + b"1" + b"}" * 65,
        b'{"t": ' + b"[" * 33 + b",".join(b"%d" % i for i in range(64)) + b"]" * 33 + b"}",
        b'{"inputs": {"image": %s}}' % json.dumps(
            [[0.5 * i + j for i in range(10)] for j in range(10)]).encode(),
        b'{"instances": %s, "signature_name": "s"}' % json.dumps(
            [[i % 7 for i in range(80)]]).encode(),
        b'{"inputs": [1.5, 2.5], "output_filter": ["logits"]}',
        b'{"a": {"b": [1, 2, 3]}, "c": "text", "d": null, "e": [true, false]}',
        b"[NaN, Infinity, -Infinity]",
        b'{"mixed": [[1, 2], "x"], "big": %s}' % json.dumps(list(range(100))).encode(),
        json.dumps({"inputs": [[(1 << 63) + 3, 1], [2, 3]]}).encode(),
        json.dumps({"x": [(1 << 63) + 3, (1 << 63) + 4]}).encode(),
    ]
    for body in bodies:
        got = codec.loads_request(body)
        _same(got, jcodec.loads_request(body))

        def plain(v):
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, dict):
                return {k: plain(x) for k, x in v.items()}
            if isinstance(v, list):
                return [plain(x) for x in v]
            return v

        np.testing.assert_equal(plain(got), json.loads(body))


@pytest.mark.parametrize("body", [
    b'{"a": [1,2', b'{"a" 1}', b"[01]", b'{"a": 1}trailing', b"",
    b'{"instances": [' + b",".join(b"%d" % i for i in range(80)) + b"]",
    b'{"instances": [' + b",".join(b"%d" % i for i in range(80)) + b', 1e]}',
])
def test_malformed_bodies_raise_value_error_and_answer_400(body):
    for mod in (codec, jcodec):
        with pytest.raises(ValueError):
            mod.loads_request(body)

    if not body:
        return  # the backend reads an empty body as {}, as the reference does

    class Manager:
        runtime = FakeRuntime()
        metrics = None

        def resolve_version(self, name, version, label=None):
            return 1

    for window in (0.0, 1.0):
        backend = LocalServingBackend(Manager(), batch_window_ms=window)
        for verb in ("predict", "generate"):
            with pytest.raises(BackendError) as e:
                backend.handle_rest("POST", "m", 1, verb, body)
            assert e.value.http_status == 400 and "invalid JSON body" in str(e.value)


def test_decode_predict_json_takes_extracted_arrays():
    """Arrays the parser extracted decode as the reference decodes them."""
    big = np.arange(128, dtype=np.int64).reshape(2, 64)
    cases = [
        ({"instances": big.astype(np.float64)}, {"x": np.dtype(np.float32)}),
        ({"instances": big}, {"x": np.dtype(np.int32)}),
        ({"instances": big.astype(np.float64)}, {}),
        ({"inputs": {"x": big}}, {"x": np.dtype(np.int32)}),
        ({"inputs": big.astype(np.float64)}, {}),
        ({"instances": [{"x": big[0]}, {"x": big[1]}]}, {"x": np.dtype(np.int32)}),
    ]
    for body, dtypes in cases:
        got, sig = codec.decode_predict_json(body, dtypes)
        want, jsig = jcodec.decode_predict_json(body, dtypes)
        assert sig == jsig
        _same(got, want)
    for mod in (codec, jcodec):
        with pytest.raises(mod.CodecError):
            mod.decode_predict_json({"instances": np.empty((0,), np.float64)}, {})
