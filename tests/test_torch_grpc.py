"""The port's gRPC surface (tfservingcache_tpu_torch/protocol/grpc_server.py on
a ``build_node`` node) against the JAX package's ``GrpcServingServer`` over
its ``LocalServingBackend``, on one store, through the same synchronous
client: responses equal as messages, errors with the same status code and
details, streamed greedy tokens equal frame by frame.

The reference's server is ``grpc.aio``: it runs on an event loop of its own
thread, which is closed with it. Every port is 0, every call has a timeout,
every server, channel and node is closed in a ``finally``; the tests that
only read share one pair of servers (a module fixture).

Models: half_plus_two (exact), mnist_cnn (bf16: scores within 2**-7, the
bound of tests/test_torch_families.py, through the float64 softmax) and
the reference's TINY transformer_lm in f32 (greedy tokens identical, as in
tests/test_torch_slo_engine.py).
"""

import asyncio
import threading
from contextlib import contextmanager

import grpc
import numpy as np
import pytest

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskProvider
from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.protocol.grpc_server import GrpcServingServer as JGrpcServer
from tfservingcache_tpu.protocol.local_backend import LocalServingBackend as JBackend
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.protocol import codec
from tfservingcache_tpu_torch.protocol.backend import BackendError
from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel
from tfservingcache_tpu_torch.protocol.grpc_server import (
    MODEL_SERVICE,
    PREDICTION_SERVICE,
    SESSION_SERVICE,
    GrpcServingServer,
)
from tfservingcache_tpu_torch.protocol.protos import grpc_health_pb2 as health_pb
from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import ModelId

TIMEOUT = 120.0  # every RPC's deadline (s)
TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
ENGINE = {"generate_engine": "continuous", "generate_slots": 4, "generate_chunk_tokens": 2,
          "kv_page_tokens": 8}
LABELS = {"hpt": {"stable": 1}}
MNIST_TOL = 2.0**-7


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    for family, name, version in (("half_plus_two", "hpt", 1), ("half_plus_two", "hpt", 2),
                                  ("half_plus_two", "hpt2", 4), ("half_plus_two", "m", 1),
                                  ("half_plus_two", "m", 2), ("half_plus_two", "m", 3),
                                  ("half_plus_two", "other", 7), ("mnist_cnn", "mn", 1)):
        jreg.export_artifact(family, str(base), name=name, version=version)
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    return base


class RefServer:
    """The reference's backend behind its grpc.aio server, on an event loop
    of its own thread."""

    def __init__(self, store, cache_dir, engine: bool) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.metrics = JMetrics()
        self.manager = JCacheManager(
            JDiskProvider(str(store)), JDiskCache(str(cache_dir), capacity_bytes=1 << 30),
            TPUModelRuntime(JServingConfig(platform="cpu"), self.metrics), self.metrics,
            version_labels=LABELS)
        kw = {}
        if engine:
            kw = dict(ENGINE, conversation_kv_dir=str(cache_dir) + "_conv")
        self.backend = JBackend(self.manager, **kw)
        self.server = None
        try:
            self.server = self._run(self._start())
        except BaseException:
            self.close()
            raise
        self.port = self.server.port

    async def _start(self):
        server = JGrpcServer(self.backend, self.metrics)
        await server.start(0, host="127.0.0.1")
        return server

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def close(self) -> None:
        try:
            self.backend.close()
            if self.server is not None:
                self._run(self.server.close())
            self.manager.close()
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()


@pytest.fixture(scope="module")
def plain(store, tmp_path_factory):
    """One port node and one reference server for the tests that only read
    (the reload tests load versions no other test asks for)."""
    with pair(store, tmp_path_factory.mktemp("plain")) as served:
        yield served


@contextmanager
def pair(store, tmp_path, engine: bool = False):
    """-> (port node, port stub, reference server, reference stub)."""
    serving = dict(ENGINE if engine else {}, version_labels=LABELS)
    if engine:
        serving["conversation_kv_dir"] = str(tmp_path / "conv")
    node = build_node(config_from_dict({
        "serving": serving,
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
    }), device="cpu")
    ref = channels = None
    try:
        node.start("127.0.0.1")
        ref = RefServer(store, tmp_path / "ref_cache", engine)
        channels = [make_channel(f"127.0.0.1:{node.grpc_port}"),
                    make_channel(f"127.0.0.1:{ref.port}")]
        yield node, ServingStub(channels[0]), ref, ServingStub(channels[1])
    finally:
        for ch in channels or ():
            ch.close()
        if ref is not None:
            ref.close()
        node.close()


class NoModels:
    """A backend that serves nothing: for servers whose lifecycle, health
    and binding are under test."""

    def _none(self, request):
        raise BackendError("no models here", 404)

    predict = classify = regress = get_model_metadata = _none
    get_model_status = reload_config = session_run = _none


def call(stub, service, method, req):
    """-> (response, None) or (None, (code, details))."""
    try:
        return stub.method(service, method)(req, timeout=TIMEOUT), None
    except grpc.RpcError as e:
        return None, (e.code(), e.details())


def both(port, ref, service, method, req):
    return call(port, service, method, req), call(ref, service, method, req)


def predict_request(name, version=None, label=None, **inputs):
    req = sv.PredictRequest()
    req.model_spec.name = name
    if version is not None:
        req.model_spec.version.value = version
    if label is not None:
        req.model_spec.version_label = label
    for k, v in inputs.items():
        req.inputs[k].CopyFrom(codec.numpy_to_tensorproto(v))
    return req


def _examples(msg, rows):
    for feats in rows:
        ex = msg.input.example_list.examples.add()
        for fname, vals in feats.items():
            ex.features.feature[fname].float_list.value.extend(vals)
    return msg


def test_grpc_full_surface(plain):
    """Predict (with a version, without one, with a float_val tensor),
    GetModelMetadata, GetModelStatus and SessionRun answer as the
    reference's (test_e2e_single_node.py::test_grpc_full_surface)."""
    _node, port, _ref, ref = plain
    req = sv.PredictRequest()
    req.model_spec.name = "hpt"
    req.model_spec.version.value = 1
    req.inputs["x"].dtype = 1
    req.inputs["x"].tensor_shape.dim.add(size=2)
    req.inputs["x"].float_val.extend([4.0, 8.0])
    (got, err), (want, rerr) = both(port, ref, PREDICTION_SERVICE, "Predict", req)
    assert err is None and rerr is None
    assert got == want
    np.testing.assert_array_equal(codec.tensorproto_to_numpy(got.outputs["y"]), [4.0, 6.0])
    unversioned = predict_request("hpt", x=np.asarray([0.0, 1.5], np.float32))
    (got, _), (want, _) = both(port, ref, PREDICTION_SERVICE, "Predict", unversioned)
    assert got == want and got.model_spec.version.value == 1  # the resident version
    mreq = sv.GetModelMetadataRequest()
    mreq.model_spec.name = "hpt"
    mreq.model_spec.version.value = 1
    (got, _), (want, _) = both(port, ref, PREDICTION_SERVICE, "GetModelMetadata", mreq)
    assert got.model_spec == want.model_spec
    sdm, want_sdm = sv.SignatureDefMap(), sv.SignatureDefMap()
    assert got.metadata["signature_def"].Unpack(sdm)
    assert want.metadata["signature_def"].Unpack(want_sdm)
    assert sdm == want_sdm and "x" in sdm.signature_def["serving_default"].inputs
    sreq = sv.GetModelStatusRequest()
    sreq.model_spec.name = "hpt"
    (got, _), (want, _) = both(port, ref, MODEL_SERVICE, "GetModelStatus", sreq)
    assert got == want
    assert [(s.version, s.state) for s in got.model_version_status] == [
        (1, sv.ModelVersionStatus.AVAILABLE)]
    srun = sv.SessionRunRequest()
    srun.model_spec.name = "hpt"
    srun.model_spec.version.value = 1
    f = srun.feed.add()
    f.name = "x:0"
    f.tensor.CopyFrom(codec.numpy_to_tensorproto(np.asarray([2.0], np.float32)))
    srun.fetch.append("y:0")
    (got, _), (want, _) = both(port, ref, SESSION_SERVICE, "SessionRun", srun)
    assert got == want and got.tensor[0].name == "y:0"
    # an unknown model, and a status of one nobody touched: NOT_FOUND
    (_, err), (_, rerr) = both(port, ref, PREDICTION_SERVICE, "Predict",
                               predict_request("ghost", 1, x=np.zeros(1, np.float32)))
    assert err[0] == rerr[0] == grpc.StatusCode.NOT_FOUND
    sreq.model_spec.name = "mn"
    (_, err), (_, rerr) = both(port, ref, MODEL_SERVICE, "GetModelStatus", sreq)
    assert err == rerr and err[0] == grpc.StatusCode.NOT_FOUND


def test_version_label_resolves_or_fails_precondition(plain):
    """A ModelSpec.version_label resolves to the mapped version even with a
    newer one present; an unmapped label answers FAILED_PRECONDITION with
    the reference's details."""
    _node, port, _ref, ref = plain
    req = predict_request("hpt", label="stable", x=np.asarray([4.0], np.float32))
    (got, _), (want, _) = both(port, ref, PREDICTION_SERVICE, "Predict", req)
    assert got == want and got.model_spec.version.value == 1
    req.model_spec.version_label = "nope"
    (_, err), (_, rerr) = both(port, ref, PREDICTION_SERVICE, "Predict", req)
    assert err == rerr and err[0] == grpc.StatusCode.FAILED_PRECONDITION
    assert "nope" in err[1]
    mreq = sv.GetModelMetadataRequest()
    mreq.model_spec.name = "hpt"
    mreq.model_spec.version_label = "nope"
    (_, err), (_, rerr) = both(port, ref, PREDICTION_SERVICE, "GetModelMetadata", mreq)
    assert err == rerr and err[0] == grpc.StatusCode.FAILED_PRECONDITION


def test_reload_config_prefetch(plain):
    node, port, ref_srv, ref = plain
    req = sv.ReloadConfigRequest()
    mc = req.config.model_config_list.config.add()
    mc.name = "hpt2"
    mc.model_version_policy.specific.versions.append(4)
    (got, _), (want, _) = both(port, ref, MODEL_SERVICE, "HandleReloadConfigRequest", req)
    assert got == want and got.status.error_code == 0
    assert node.runtime.is_loaded(ModelId("hpt2", 4))
    assert ref_srv.manager.runtime.is_loaded(JModelId("hpt2", 4))


def test_reload_config_latest_and_all_policies(plain):
    """latest{N}, all, unset (the latest) and an unknown model (status
    NOT_FOUND) answer and load as the reference's."""
    node, port, ref_srv, ref = plain
    def loaded(name, versions):
        got = [node.runtime.is_loaded(ModelId(name, v)) for v in versions]
        want = [ref_srv.manager.runtime.is_loaded(JModelId(name, v)) for v in versions]
        assert got == want
        return got

    req = sv.ReloadConfigRequest()
    mc = req.config.model_config_list.config.add()
    mc.name = "m"
    mc.model_version_policy.latest.num_versions = 2
    (got, _), (want, _) = both(port, ref, MODEL_SERVICE, "HandleReloadConfigRequest", req)
    assert got == want and got.status.error_code == 0
    assert loaded("m", (1, 2, 3)) == [False, True, True]
    req = sv.ReloadConfigRequest()
    mc = req.config.model_config_list.config.add()
    mc.name = "m"
    mc.model_version_policy.all.SetInParent()
    (got, _), (want, _) = both(port, ref, MODEL_SERVICE, "HandleReloadConfigRequest", req)
    assert got == want and got.status.error_code == 0
    assert loaded("m", (1, 2, 3)) == [True, True, True]
    req = sv.ReloadConfigRequest()
    req.config.model_config_list.config.add().name = "other"
    (got, _), (want, _) = both(port, ref, MODEL_SERVICE, "HandleReloadConfigRequest", req)
    assert got == want and got.status.error_code == 0
    assert loaded("other", (7,)) == [True]
    req = sv.ReloadConfigRequest()
    mc = req.config.model_config_list.config.add()
    mc.name = "ghost"
    mc.model_version_policy.all.SetInParent()
    (got, _), (want, _) = both(port, ref, MODEL_SERVICE, "HandleReloadConfigRequest", req)
    assert got == want and got.status.error_code == 5


def test_regress_and_classify_on_half_plus_two(plain):
    """Regress answers the reference's message (values as f32); Classify of
    a model with no scores/logits fails as the reference's does; no
    examples is INVALID_ARGUMENT."""
    rows = [{"x": [1.0]}, {"x": [0.1]}, {"x": [-3.25]}]
    _node, port, _ref, ref = plain
    req = _examples(sv.RegressionRequest(), rows)
    req.model_spec.name = "hpt"
    req.model_spec.version.value = 1
    (got, err), (want, rerr) = both(port, ref, PREDICTION_SERVICE, "Regress", req)
    assert err is None and rerr is None and got == want
    assert [r.value for r in got.result.regressions] == [
        float(np.float32(0.5 * np.float32(v) + 2)) for v in (1.0, 0.1, -3.25)]
    creq = _examples(sv.ClassificationRequest(), rows)
    creq.model_spec.name = "hpt"
    creq.model_spec.version.value = 1
    (_, err), (_, rerr) = both(port, ref, PREDICTION_SERVICE, "Classify", creq)
    assert err == rerr and err[0] == grpc.StatusCode.FAILED_PRECONDITION
    empty = sv.RegressionRequest()
    empty.model_spec.name = "hpt"
    empty.model_spec.version.value = 1
    (_, err), (_, rerr) = both(port, ref, PREDICTION_SERVICE, "Regress", empty)
    assert err == rerr and err[0] == grpc.StatusCode.INVALID_ARGUMENT


def test_classify_mnist_scores_match_the_reference_forward(plain):
    """Classify on mnist_cnn: flat float features (a tf.Example's image)
    take the signature's (28, 28, 1) shape (ROADMAP C9: the reference
    passes them on flat and its model refuses them, INTERNAL), and the
    scores are the softmax of logits within the family bound of the
    reference's forward on the same images."""
    images = np.random.default_rng(7).random((3, 28, 28, 1), dtype=np.float32)
    rows = [{"image": img.reshape(-1).tolist()} for img in images]
    req = _examples(sv.ClassificationRequest(), rows)
    req.model_spec.name = "mn"
    req.model_spec.version.value = 1
    _node, port, ref_srv, ref = plain
    (got, err), (_, rerr) = both(port, ref, PREDICTION_SERVICE, "Classify", req)
    assert err is None, err
    assert rerr[0] == grpc.StatusCode.INTERNAL  # the reference's flat image
    logits = ref_srv.manager.runtime.predict(JModelId("mn", 1), {"image": images},
                                             ["logits"])["logits"].astype(np.float64)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    want = e / e.sum(-1, keepdims=True)
    assert got.model_spec.name == "mn" and got.model_spec.version.value == 1
    classes = got.result.classifications
    assert [[c.label for c in cls.classes] for cls in classes] == [
        [str(j) for j in range(10)]] * 3
    scores = np.asarray([[c.score for c in cls.classes] for cls in classes])
    assert np.abs(scores - want).max() <= MNIST_TOL


def test_generate_predict_and_stream_match_the_reference(store, tmp_path):
    """Predict(signature_name="generate") answers the reference's tokens;
    GenerateStream's greedy frames are the reference's frame by frame: a
    scalar ``token`` a sampled token, then the ``tokens`` matrix; every
    frame counts in tpusc_gen_stream_frames{grpc}
    (test_slo_engine.py::test_grpc_generate_stream_parity)."""
    ids = np.arange(1, 13, dtype=np.int32)[None]
    with pair(store, tmp_path, engine=True) as (node, port, ref_srv, ref):
        req = predict_request("lm", 1, input_ids=ids,
                              max_new_tokens=np.asarray(9, np.int32),
                              temperature=np.asarray(0.0, np.float32))
        req.model_spec.signature_name = "generate"
        (got, err), (want, rerr) = both(port, ref, PREDICTION_SERVICE, "Predict", req)
        assert err is None and rerr is None and got == want
        tokens = codec.tensorproto_to_numpy(got.outputs["tokens"])
        assert tokens.shape == (1, 9) and tokens.dtype == np.int32

        frames = {}
        for side, stub in (("port", port), ("ref", ref)):
            frames[side] = list(stub.generate_stream()(req, timeout=TIMEOUT))
        assert frames["port"] == frames["ref"]
        toks = [int(codec.tensorproto_to_numpy(f.outputs["token"]))
                for f in frames["port"][:-1]]
        assert toks == tokens[0].tolist()
        assert frames["port"][-1] == want  # the terminal frame is the unary answer
        assert node.metrics.gen_stream_frames.labels("grpc").value == len(frames["port"])
        assert node.engine.admitted == 2  # both ran on the continuous engine
        # more than one row is INVALID_ARGUMENT, before any frame
        req.inputs["input_ids"].CopyFrom(codec.numpy_to_tensorproto(np.vstack([ids, ids])))
        errs = []
        for stub in (port, ref):
            with pytest.raises(grpc.RpcError) as ex:
                list(stub.generate_stream()(req, timeout=TIMEOUT))
            errs.append((ex.value.code(), ex.value.details()))
        assert errs[0] == errs[1] and errs[0][0] == grpc.StatusCode.INVALID_ARGUMENT
        node.runtime._slot_states[ModelId("lm", 1)].check_page_conservation()


@pytest.mark.parametrize("method", ["MultiInference", "NoSuchMethod"])
def test_unimplemented_methods(plain, method):
    """MultiInference is refused and an unknown method answers UNIMPLEMENTED
    through the counted fallback, as on the reference."""
    node, port, _ref, ref = plain
    failures = node.metrics.request_failures.labels("grpc").value
    errs = []
    for stub in (port, ref):
        rpc = stub.channel.unary_unary(f"/{PREDICTION_SERVICE}/{method}",
                                       request_serializer=lambda b: b,
                                       response_deserializer=lambda b: b)
        with pytest.raises(grpc.RpcError) as ex:
            rpc(b"", timeout=TIMEOUT)
        errs.append(ex.value.code())
    assert errs == [grpc.StatusCode.UNIMPLEMENTED] * 2
    assert node.metrics.request_failures.labels("grpc").value == failures + 1


def test_health_check_and_watch(plain):
    """A started node's health reads SERVING; a bare server starts
    NOT_SERVING, and Watch sees the change."""
    _node, port, _ref, _r = plain
    check = port.channel.unary_unary(
        "/grpc.health.v1.Health/Check",
        request_serializer=health_pb.HealthCheckRequest.SerializeToString,
        response_deserializer=health_pb.HealthCheckResponse.FromString)
    assert check(health_pb.HealthCheckRequest(), timeout=TIMEOUT).status == \
        health_pb.HealthCheckResponse.SERVING
    server = GrpcServingServer(NoModels())
    channel = None
    try:
        bound = server.start(0, "127.0.0.1")
        channel = make_channel(f"127.0.0.1:{bound}")
        check = channel.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=health_pb.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb.HealthCheckResponse.FromString)
        watch = channel.unary_stream(
            "/grpc.health.v1.Health/Watch",
            request_serializer=health_pb.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb.HealthCheckResponse.FromString)
        assert check(health_pb.HealthCheckRequest(), timeout=TIMEOUT).status == \
            health_pb.HealthCheckResponse.NOT_SERVING
        stream = watch(health_pb.HealthCheckRequest(), timeout=TIMEOUT)
        assert next(stream).status == health_pb.HealthCheckResponse.NOT_SERVING
        server.set_health(True)
        assert next(stream).status == health_pb.HealthCheckResponse.SERVING
        stream.cancel()
        assert check(health_pb.HealthCheckRequest(), timeout=TIMEOUT).status == \
            health_pb.HealthCheckResponse.SERVING
    finally:
        if channel is not None:
            channel.close()
        server.close()


def test_binding_a_taken_port_raises():
    """``grpc.so_reuseport`` is off: a second server on a port the first
    holds raises, where the reference's default would share the port and
    split connections between the two (ROADMAP C10)."""
    first, second = GrpcServingServer(NoModels()), GrpcServingServer(NoModels())
    try:
        bound = first.start(0, "127.0.0.1")
        with pytest.raises(OSError, match="could not bind"):
            second.start(bound, "127.0.0.1")
        assert second.server is None
    finally:
        second.close()
        first.close()


def test_backend_error_codes_name_grpc_status_codes():
    """Every code a port failure can carry names a grpc.StatusCode."""
    for status in (400, 404, 405, 412, 500, 501, 503, 504):
        assert hasattr(grpc.StatusCode, BackendError("x", status).grpc_code)
    assert BackendError("x", 412).grpc_code == "FAILED_PRECONDITION"
    assert BackendError("x", 400, "FAILED_PRECONDITION").grpc_code == "FAILED_PRECONDITION"


def _tensor_cases():
    import ml_dtypes

    from tfservingcache_tpu.protocol.protos import tf_core_pb2 as jcore

    half = jcore.TensorProto(dtype=jcore.DT_HALF, half_val=np.asarray(
        [1.5, -2.0], np.float16).view(np.uint16).tolist())
    half.tensor_shape.dim.add(size=2)
    bf16 = jcore.TensorProto(dtype=jcore.DT_BFLOAT16, half_val=np.asarray(
        [0.1, 3.0, -7.5], ml_dtypes.bfloat16).view(np.uint16).tolist())
    bf16.tensor_shape.dim.add(size=3)
    fill = jcore.TensorProto(dtype=jcore.DT_INT32, int_val=[7])
    fill.tensor_shape.dim.add(size=2)
    fill.tensor_shape.dim.add(size=3)
    strings = jcore.TensorProto(dtype=jcore.DT_STRING, string_val=[b"a", b"bc"])
    strings.tensor_shape.dim.add(size=2)
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3), np.asarray([1, -2], np.int64),
              np.asarray(3, np.int32), np.asarray([True, False]), np.asarray([b"x", b"yy"], object),
              np.arange(4, dtype=np.float64), np.arange(4).astype(ml_dtypes.bfloat16)]
    return arrays, [half, bf16, fill, strings]


@pytest.mark.parametrize("case", range(11))
def test_tensorproto_codec_matches_the_reference(case):
    """The port's TensorProto codec encodes as the JAX package's does (equal
    messages) and decodes every wire form to the same values; a bfloat16
    tensor decodes to float32 holding its exact values (no ml_dtypes)."""
    from tfservingcache_tpu.protocol import codec as jcodec

    arrays, protos = _tensor_cases()
    if case < len(arrays):
        arr = arrays[case]
        assert codec.numpy_to_tensorproto(arr) == jcodec.numpy_to_tensorproto(arr)
        tp = jcodec.numpy_to_tensorproto(arr)
    else:
        tp = protos[case - len(arrays)]
    got, want = codec.tensorproto_to_numpy(tp), jcodec.tensorproto_to_numpy(tp)
    assert got.shape == want.shape
    if want.dtype == object:
        assert got.tolist() == want.tolist()
    elif want.dtype.name == "bfloat16":
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.astype(np.float32))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
