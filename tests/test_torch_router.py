"""The port's router (tfservingcache_tpu_torch/cluster/router.py) against the
JAX package's:

  - three port nodes on the CPU, each with a ``Router`` over static
    discovery: every REST verb and gRPC method answers through any router
    byte for byte as the key's ring owner answers directly;
  - on one tiny f32 ``transformer_lm`` store, a routed ``:predict`` equals
    the reference's three-node routed cluster (within the f32 tolerance of
    tests/test_torch_serving.py);
  - ``_candidates`` orders replicas as the reference's on the same
    in-flight, warmth and health state (the shared ``random`` module seeded
    before each pick);
  - retries on a dead replica, 503 / UNAVAILABLE when every replica is
    down, conversation affinity, label resolution at the router, the peer's
    trace subtree grafted, the router's own endpoints;
  - a router serving in a fresh interpreter with ``jax``, the JAX package
    and aiohttp blocked, and ``cli serve`` with file discovery (the
    docker-compose config's shape) registering, answering on the proxy
    port and unregistering on SIGTERM.

Every port is 0 (the cli test picks free ones), every call has a timeout,
routers close before their nodes in ``finally`` blocks or fixtures, and the
tests that only read share one three-node fleet. Nodes run on
``runtime/fake.py`` unless the test is about the model's outputs.
"""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import textwrap
import time
from contextlib import contextmanager

import grpc
import numpy as np
import pytest

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskProvider
from tfservingcache_tpu.cluster.cluster import ClusterConnection as JCluster
from tfservingcache_tpu.cluster.discovery.base import DiscoveryService as JDiscovery
from tfservingcache_tpu.cluster.router import RoutingBackend as JRouting
from tfservingcache_tpu.cluster.status import FleetView as JFleetView
from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.protocol.local_backend import LocalServingBackend as JBackend
from tfservingcache_tpu.protocol.rest import RestServingServer as JRest
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import NodeInfo as JNodeInfo
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch.cluster.cluster import ClusterConnection
from tfservingcache_tpu_torch.cluster.router import Router, RoutingBackend
from tfservingcache_tpu_torch.cluster.status import FleetView
from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.protocol import codec
from tfservingcache_tpu_torch.protocol.backend import BackendError
from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel
from tfservingcache_tpu_torch.protocol.grpc_server import (
    MODEL_SERVICE,
    PREDICTION_SERVICE,
    SESSION_SERVICE,
)
from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv
from tfservingcache_tpu_torch.server import build_node
from tfservingcache_tpu_torch.types import ModelId, NodeInfo
from tfservingcache_tpu_torch.utils.tracing import TRACER
from test_torch_cluster import JMockDiscovery, MockDiscovery, members
from torch_cluster_util import (
    TIMEOUT,
    LoopThread,
    fake_node,
    http,
    ident_of,
    make_store,
    node_config,
    wait_until,
)
from torch_obs_globals import confined_globals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"vocab_size": 97, "d_model": 48, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 96, "max_seq": 64, "dtype": "float32"}
LABELS = {"hpt": {"stable": 1}}
HPT_COPIES = 8


@contextmanager
def routed(nodes, cfgs, **cluster):
    """A ``Router`` beside each started node, static discovery listing all
    of them; routers close first."""
    idents = [ident_of(n) for n in nodes]
    routers = []
    try:
        for cfg, node in zip(cfgs, nodes):
            cfg.discovery.nodes = idents
            for k, v in cluster.items():
                setattr(cfg.cluster, k, v)
            routers.append(Router(cfg, node))
            routers[-1].start("127.0.0.1")
        for r in routers:
            wait_until(lambda r=r: r.cluster.node_count == len(nodes), what="membership")
        yield routers
    finally:
        for r in routers:
            r.close()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("store")
    for name, version in [("hpt", 1), ("hpt", 2)] + [(f"h{i}", 1) for i in range(HPT_COPIES)]:
        jreg.export_artifact("half_plus_two", str(base), name=name, version=version)
    jreg.export_artifact("mnist_cnn", str(base), name="mn", version=1)
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=TINY, seed=3)
    return base


@pytest.fixture(scope="module")
def fleet(store, tmp_path_factory):
    """Three CPU port nodes, each with a router (replicas 1, ownership
    fixed): -> (nodes, routers)."""
    tmp = tmp_path_factory.mktemp("fleet")
    nodes, cfgs = [], []
    try:
        for i in range(3):
            cfg = config_from_dict(node_config(
                tmp, f"n{i}", store, serving={"version_labels": LABELS},
                cache={"disk_capacity_bytes": 1 << 30},
                cluster={"max_replicas_per_model": 0}))
            nodes.append(build_node(cfg, device="cpu"))
            cfgs.append(cfg)
            nodes[-1].start("127.0.0.1")
        with routed(nodes, cfgs) as routers:
            yield nodes, routers
    finally:
        for n in nodes:
            n.close()


def owner(router, nodes, name, version):
    ident = router.cluster.find_nodes_for_key(ModelId(name, int(version or 0)).key)[0].ident
    return next(n for n in nodes if ident_of(n) == ident)


def _rest_requests():
    image = np.random.default_rng(0).random(784).astype(np.float32).tolist()
    reqs = [("POST", f"/v1/models/h{i}/versions/1:predict", {"instances": [1.0, 2.5]},
             (f"h{i}", 1)) for i in range(HPT_COPIES)]
    reqs += [
        ("POST", "/v1/models/hpt/labels/stable:predict", {"instances": [4.0]}, ("hpt", 1)),
        ("POST", "/v1/models/hpt/versions/2:predict", {"instances": [4.0]}, ("hpt", 2)),
        ("POST", "/v1/models/hpt/versions/1:regress", {"examples": [{"x": [1.0]}, {"x": [3.0]}]},
         ("hpt", 1)),
        ("POST", "/v1/models/mn/versions/1:classify", {"examples": [{"x": image}]}, ("mn", 1)),
        ("POST", "/v1/models/mn/versions/1:predict", {"instances": [image]}, ("mn", 1)),
        ("POST", "/v1/models/lm/versions/1:predict", {"instances": [[1, 5, 9, 2]]}, ("lm", 1)),
        ("POST", "/v1/models/lm/versions/1:generate",
         {"input_ids": [[1, 5, 9, 2]], "max_new_tokens": 5}, ("lm", 1)),
        ("GET", "/v1/models/hpt/versions/1", None, ("hpt", 1)),
        ("GET", "/v1/models/hpt/versions/1/metadata", None, ("hpt", 1)),
        ("GET", "/v1/models/lm/labels/stable", None, None),  # unmapped: the router's 412
        ("POST", "/v1/models/ghost/versions/1:predict", {"instances": [1.0]}, ("ghost", 1)),
        ("POST", "/v1/models/hpt/versions/1:predict", {"nope": 1}, ("hpt", 1)),
    ]
    return reqs


def test_every_rest_verb_answers_through_any_router_as_the_owner(fleet):
    nodes, routers = fleet
    for method, path, body, key in _rest_requests():
        for r in routers:
            got = http(f"http://127.0.0.1:{r.rest_port}{path}", body, method)
            if key is None:
                assert got[0] == 412 and b"not mapped" in got[1], path
                continue
            direct = owner(r, nodes, *key)
            want = http(f"http://127.0.0.1:{direct.rest_port}{path}", body, method)
            assert (got[0], got[1]) == (want[0], want[1]), (path, r.rest_port)
            assert got[2]["Content-Type"] == "application/json"
    # the router, not the node, needs a version
    status, raw, _ = http(f"http://127.0.0.1:{routers[0].rest_port}/v1/models/hpt:predict",
                          {"instances": [1.0]})
    assert status == 400 and json.loads(raw) == {
        "Status": "Error", "Message": "Model version must be provided"}
    assert http(f"http://127.0.0.1:{nodes[0].rest_port}/v1/models/hpt:predict",
                {"instances": [1.0]})[0] == 200
    # every model ran on its owner only
    for i in range(HPT_COPIES):
        mid = ModelId(f"h{i}", 1)
        holder = owner(routers[0], nodes, mid.name, 1)
        assert [n.runtime.is_loaded(mid) for n in nodes] == [n is holder for n in nodes]


def _call(stub, service, method, req):
    try:
        return stub.method(service, method)(req, timeout=TIMEOUT), None
    except grpc.RpcError as e:
        return None, (e.code(), e.details())


def _spec(msg, name, version=None, label=None):
    msg.model_spec.name = name
    if version is not None:
        msg.model_spec.version.value = version
    if label is not None:
        msg.model_spec.version_label = label
    return msg


def _grpc_requests():
    x = codec.numpy_to_tensorproto(np.asarray([1.0, 3.0], np.float32))
    ids = codec.numpy_to_tensorproto(np.asarray([[1, 5, 9]], np.int32))
    reqs = []
    for i in range(HPT_COPIES):
        req = _spec(sv.PredictRequest(), f"h{i}", 1)
        req.inputs["x"].CopyFrom(x)
        reqs.append((PREDICTION_SERVICE, "Predict", req, (f"h{i}", 1)))
    req = _spec(sv.PredictRequest(), "hpt", label="stable")
    req.inputs["x"].CopyFrom(x)
    reqs.append((PREDICTION_SERVICE, "Predict", req, ("hpt", 1)))
    req = _spec(sv.PredictRequest(), "lm", 1)
    req.inputs["input_ids"].CopyFrom(ids)
    reqs.append((PREDICTION_SERVICE, "Predict", req, ("lm", 1)))
    for cls, method in ((sv.RegressionRequest, "Regress"), (sv.ClassificationRequest, "Classify")):
        req = _spec(cls(), "hpt", 1)
        for v in (1.0, -2.0):
            req.input.example_list.examples.add().features.feature["x"].float_list.value.append(v)
        reqs.append((PREDICTION_SERVICE, method, req, ("hpt", 1)))
    reqs.append((PREDICTION_SERVICE, "GetModelMetadata",
                 _spec(sv.GetModelMetadataRequest(), "hpt", 1), ("hpt", 1)))
    reqs.append((MODEL_SERVICE, "GetModelStatus", _spec(sv.GetModelStatusRequest(), "hpt", 1),
                 ("hpt", 1)))
    reqs.append((MODEL_SERVICE, "GetModelStatus", _spec(sv.GetModelStatusRequest(), "hpt"),
                 ("hpt", 0)))
    srun = _spec(sv.SessionRunRequest(), "hpt", 1)
    feed = srun.feed.add()
    feed.name = "x:0"
    feed.tensor.CopyFrom(x)
    srun.fetch.append("y:0")
    reqs.append((SESSION_SERVICE, "SessionRun", srun, ("hpt", 1)))
    req = _spec(sv.PredictRequest(), "ghost", 1)
    req.inputs["x"].CopyFrom(x)
    reqs.append((PREDICTION_SERVICE, "Predict", req, ("ghost", 1)))
    return reqs


def test_every_grpc_method_answers_through_any_router_as_the_owner(fleet):
    nodes, routers = fleet
    channels = []
    try:
        for service, method, req, key in _grpc_requests():
            for r in routers:
                channels.append(make_channel(f"127.0.0.1:{r.grpc_port}"))
                got = _call(ServingStub(channels[-1]), service, method, req)
                channels.append(make_channel(f"127.0.0.1:{owner(r, nodes, *key).grpc_port}"))
                want = _call(ServingStub(channels[-1]), service, method, req)
                assert got == want, (method, key)
        stub = ServingStub(channels[0])
        # answered by the router itself, as the reference's
        _, err = _call(stub, MODEL_SERVICE, "HandleReloadConfigRequest", sv.ReloadConfigRequest())
        assert err[0] == grpc.StatusCode.UNIMPLEMENTED and "router" in err[1]
        _, err = _call(stub, PREDICTION_SERVICE, "MultiInference", sv.MultiInferenceRequest())
        assert err[0] == grpc.StatusCode.UNIMPLEMENTED
        req = _spec(sv.PredictRequest(), "hpt", label="nope")
        _, err = _call(stub, PREDICTION_SERVICE, "Predict", req)
        assert err[0] == grpc.StatusCode.FAILED_PRECONDITION and "nope" in err[1]
    finally:
        for ch in channels:
            ch.close()


def test_router_monitoring_and_grafted_traces(fleet):
    nodes, routers = fleet
    r = routers[0]
    remote = next(i for i in range(HPT_COPIES)
                  if owner(r, nodes, f"h{i}", 1) is not r.node)
    with confined_globals():
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        status, _, headers = http(f"http://127.0.0.1:{r.rest_port}/v1/models/h{remote}"
                                  "/versions/1:predict", {"instances": [1.0]},
                                  headers={"traceparent": tp})
        assert status == 200 and headers.get("x-tpusc-trace")
        trace = TRACER.query(n=50, trace_id="ab" * 16)
        root = next(t for t in trace if t.get("attrs", {}).get("route") == "forwarded")
        route = next(c for c in root["children"] if c["name"] == "route")
        grafted = route["children"][0]
        assert grafted["remote"] is True and grafted["name"] == "rest"
        assert grafted["trace_id"] == "ab" * 16
    status, raw, _ = http(f"http://127.0.0.1:{r.rest_port}/monitoring/cluster")
    snap = json.loads(raw)
    assert status == 200 and set(snap["nodes"]) >= {ident_of(owner(r, nodes, f"h{remote}", 1))}
    assert set(snap) == set(JFleetView().snapshot())
    # the router's exposition counts the forward under route="forwarded"
    text = http(f"http://127.0.0.1:{r.rest_port}/monitoring/prometheus/metrics")[1].decode()
    assert 'route="forwarded"' in text and "tpusc_peer_health_score" in text


class _JRefFleet:
    """Three reference nodes and a reference router on one event loop."""

    def __init__(self, store, tmp_path):
        self.loop = LoopThread()
        self.parts = []
        self.router = None
        try:
            infos = [self.loop.run(self._node(store, tmp_path / f"jn{i}")) for i in range(3)]
            self.router, self.rest, self.port = self.loop.run(self._router(infos))
        except BaseException:
            self.close()
            raise

    async def _node(self, store, cache_dir):
        metrics = JMetrics()
        manager = JCacheManager(JDiskProvider(str(store)), JDiskCache(str(cache_dir), 1 << 30),
                                TPUModelRuntime(JServingConfig(platform="cpu"), metrics), metrics)
        backend = JBackend(manager)
        rest = JRest(backend, metrics, require_version=False)
        port = await rest.start(0, host="127.0.0.1")
        self.parts.append((manager, backend, rest))
        return JNodeInfo("127.0.0.1", port, 1)

    async def _router(self, infos):
        mock = JMockDiscovery()
        self.cluster = JCluster(mock, replicas_per_model=1)
        mock._publish(infos)
        await self.cluster.connect(infos[0], lambda: True, wait_ready_s=5)
        routing = JRouting(self.cluster)
        rest = JRest(routing, require_version=True)
        return routing, rest, await rest.start(0, host="127.0.0.1")

    def close(self):
        async def shut():
            if self.router is not None:
                await self.router.close()
                await self.rest.close()
                await self.cluster.disconnect()
            for manager, backend, rest in self.parts:
                backend.close()
                await rest.close()
                manager.close()

        try:
            self.loop.run(shut())
        finally:
            self.loop.close()


def test_routed_predict_equals_the_reference_routed_cluster(fleet, store, tmp_path):
    nodes, routers = fleet
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"], size=(2, 11)).tolist()
    ref = _JRefFleet(store, tmp_path)
    try:
        status, raw, _ = http(f"http://127.0.0.1:{ref.port}/v1/models/lm/versions/1:predict",
                              {"instances": ids})
        assert status == 200
        want = np.asarray(json.loads(raw)["predictions"], np.float32)
    finally:
        ref.close()
    for r in routers:
        status, raw, _ = http(f"http://127.0.0.1:{r.rest_port}/v1/models/lm/versions/1:predict",
                              {"instances": ids})
        got = np.asarray(json.loads(raw)["predictions"], np.float32)
        assert status == 200 and got.shape == want.shape == (2, TINY["vocab_size"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# -- replica ordering -----------------------------------------------------------

def _pair_of_backends(loop, n_nodes, replicas, **kw):
    mock = MockDiscovery()
    cluster = ClusterConnection(mock, replicas_per_model=replicas)
    mock.push(members(n_nodes))
    cluster.connect(members(n_nodes)[0], lambda: True, wait_ready_s=5)
    jmock = JMockDiscovery()
    jcluster = JCluster(jmock, replicas_per_model=replicas)
    jmock._publish([JNodeInfo(n.host, n.rest_port, n.grpc_port) for n in members(n_nodes)])
    loop.run(jcluster.connect(JNodeInfo("10.0.0.0", 9000, 9100), lambda: True, wait_ready_s=5))

    async def make_ref():
        return JRouting(jcluster, **{k: v[1] for k, v in kw.items()})

    port = RoutingBackend(cluster, **{k: v[0] for k, v in kw.items()})
    return port, loop.run(make_ref()), cluster, jcluster


@pytest.mark.parametrize("state", ["idle", "loaded", "warmth", "sick", "fleet_warmth"])
def test_candidates_order_like_the_reference(state):
    loop = LoopThread()
    kw = {}
    if state in ("sick", "fleet_warmth"):
        kw["fleet"] = (FleetView(), JFleetView())
    if state == "warmth":
        kw["local_warmth"] = ({members(4)[1].ident: lambda mid: 2},
                              {members(4)[1].ident: lambda mid: 2})
    port = ref = cluster = jcluster = None
    try:
        port, ref, cluster, jcluster = _pair_of_backends(loop, 4, 3, **kw)
        idents = [n.ident for n in members(4)]
        if state == "loaded":
            for ident, n in zip(idents, (2, 0, 1, 2)):
                for _ in range(n):
                    port._inflight_inc(ident)
                    ref._inflight_inc(ident)
        if state == "sick":
            for f in kw["fleet"]:
                for _ in range(3):
                    f.note_forward(idents[2], False)
        if state == "fleet_warmth":
            from tfservingcache_tpu.cluster.status import NodeStatus as JNodeStatus
            from tfservingcache_tpu_torch.cluster.status import NodeStatus

            for f, cls in zip(kw["fleet"], (NodeStatus, JNodeStatus)):
                for i, ident in enumerate(idents):
                    f.ingest(cls(ident=ident, seq=1, models={f"m{j}##1": (i + j) % 4
                                                             for j in range(6)}))
        for seed in range(40):
            for j in range(6):
                random.seed(seed)
                got = [n.ident for n in port._candidates(f"m{j}", 1)]
                random.seed(seed)
                want = [n.ident for n in ref._candidates(f"m{j}", 1)]
                assert got == want, (seed, j)
                for conv in ("alpha", "beta"):
                    assert [n.ident for n in port._candidates(f"m{j}", 1, affinity=conv)] == [
                        n.ident for n in ref._candidates(f"m{j}", 1, affinity=conv)]
        if state == "loaded":
            for ident in idents:
                for _ in range(2):
                    port._inflight_dec(ident)
            assert port._inflight == {}  # drained counts leave no ghost keys
    finally:
        if port is not None:
            port.close()
            cluster.disconnect()

            async def shut():
                await ref.close()
                await jcluster.disconnect()

            loop.run(shut())
        loop.close()


# -- failure handling on fake nodes -------------------------------------------

def _routing(live_nodes, dead_idents, replicas, fleet=None):
    mock = MockDiscovery()
    cluster = ClusterConnection(mock, replicas_per_model=replicas)
    nodes = [NodeInfo.from_ident(ident_of(n)) for n in live_nodes]
    nodes += [NodeInfo.from_ident(i) for i in dead_idents]
    mock.push(nodes)
    cluster.connect(NodeInfo("127.0.0.1", 2, 2), lambda: True, wait_ready_s=5)
    return RoutingBackend(cluster, fleet=fleet), cluster


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _predict_req(name, value):
    req = _spec(sv.PredictRequest(), name, 1)
    req.inputs["x"].dtype = 1
    req.inputs["x"].tensor_shape.dim.add(size=1)
    req.inputs["x"].float_val.append(value)
    return req


def test_router_retries_a_dead_replica(tmp_path):
    store = make_store(tmp_path / "store", [("m", 1)])
    live = fake_node(tmp_path, "live", store)
    dead = "127.0.0.1:1:1"  # nothing listens there
    routing, cluster = _routing([live], [dead], replicas=2)
    try:
        for i in range(6):  # the random pair start reaches the dead one too
            resp = routing.predict(_predict_req("m", float(i)))
            assert codec.tensorproto_to_numpy(resp.outputs["y"]).tolist() == [float(i)]
            out = routing.handle_rest("POST", "m", 1, "predict", b'{"instances": [2.0]}')
            assert out.status == 200 and json.loads(out.body) == {"predictions": [2.0]}
        assert len(live.runtime.predicts) == 12
    finally:
        routing.close()
        cluster.disconnect()
    # with a fleet view: a conversation pinned to the dead replica fails
    # over to the live one, and the failure scores against the dead peer
    fleet = FleetView()
    routing, cluster = _routing([live], [dead], replicas=2, fleet=fleet)
    try:
        conv = next(c for c in map(str, range(100))
                    if routing._candidates("m", 1, affinity=c)[0].ident == dead)
        body = json.dumps({"input_ids": [[1]], "max_new_tokens": 1, "conversation_id": conv})
        for _ in range(3):
            out = routing.handle_rest("POST", "m", 1, "generate", body.encode())
            assert out.status == 200 and json.loads(out.body) == {"tokens": [[1]]}
        row = fleet.snapshot()["nodes"][dead]
        assert row["failures"] == row["forwards"] == 3
        assert fleet.health(dead) == pytest.approx(0.7 ** 3)
        assert fleet.health(dead) < fleet.health_threshold
        assert fleet.health(ident_of(live)) > fleet.health_threshold
    finally:
        routing.close()
        cluster.disconnect()
        live.close()


def test_all_replicas_down_is_503_and_unavailable():
    dead = ["127.0.0.1:1:1", "127.0.0.1:2:2"]  # nothing listens there
    routing, cluster = _routing([], dead, replicas=2)
    try:
        with pytest.raises(BackendError) as err:
            routing.handle_rest("POST", "m", 1, "predict", b'{"instances": [1.0]}')
        assert err.value.http_status == 503 and err.value.grpc_code == "UNAVAILABLE"
        assert str(err.value).startswith("all replicas unreachable")
        with pytest.raises(grpc.RpcError) as rpc_err:
            routing.predict(_predict_req("m", 1.0))
        assert rpc_err.value.code() == grpc.StatusCode.UNAVAILABLE
    finally:
        routing.close()
        cluster.disconnect()
    empty, cluster = _routing([], [], replicas=1)
    try:
        with pytest.raises(BackendError, match="no serving nodes") as err:
            empty.handle_rest("POST", "m", 1, "predict", b"{}")
        assert err.value.http_status == 503
    finally:
        empty.close()
        cluster.disconnect()


def test_conversation_affinity_pins_every_turn_to_one_replica(tmp_path):
    store = make_store(tmp_path / "store", [("m", 1)])
    nodes = [fake_node(tmp_path, f"n{i}", store) for i in range(3)]
    turns = {ident_of(n): [] for n in nodes}
    for n in nodes:
        def counted(*a, _gen=n.runtime.generate, _ident=ident_of(n), **kw):
            turns[_ident].append(kw.get("model_id", a[0] if a else None))
            return _gen(*a, **kw)

        n.runtime.generate = counted
    routing, cluster = _routing(nodes, [], replicas=3)
    try:
        body = {"input_ids": [[1, 2]], "max_new_tokens": 2}
        for conv in ("alpha", "beta", "gamma", "delta"):
            pinned = routing._candidates("m", 1, affinity=conv)[0].ident
            before = {k: len(v) for k, v in turns.items()}
            for _turn in range(3):
                out = routing.handle_rest("POST", "m", 1, "generate",
                                          json.dumps(dict(body, conversation_id=conv)).encode())
                assert out.status == 200 and json.loads(out.body)["tokens"] == [[1, 1]]
            assert {k: len(v) - before[k] for k, v in turns.items()} == {
                k: (3 if k == pinned else 0) for k in turns}, conv
        assert RoutingBackend._conversation_affinity("predict", b'{"conversation_id": "a"}') is None
        assert RoutingBackend._conversation_affinity("generate", b"{not json") is None
        assert RoutingBackend._conversation_affinity("generate", b'{"conversation_id": 3}') is None
    finally:
        routing.close()
        cluster.disconnect()
        for n in nodes:
            n.close()


def test_labels_resolve_at_the_router(tmp_path):
    store = make_store(tmp_path / "store", [("m", 1), ("m", 2)])
    # a forwarded gRPC spec keeps its label: the node resolves it from its
    # own (the same) config, as the reference's nodes do
    node = fake_node(tmp_path, "a", store, serving={"version_labels": {"m": {"canary": 2}}})
    mock = MockDiscovery()
    cluster = ClusterConnection(mock)
    mock.push([NodeInfo.from_ident(ident_of(node))])
    cluster.connect(NodeInfo("127.0.0.1", 2, 2), lambda: True, wait_ready_s=5)
    routing = RoutingBackend(cluster, version_labels={"m": {"canary": 2}})
    try:
        out = routing.handle_rest("POST", "m", None, "predict", b'{"instances": [1.0]}',
                                  label="canary")
        assert out.status == 200 and json.loads(out.body) == {"predictions": [2.0]}
        assert node.runtime.predicts == [ModelId("m", 2)]
        with pytest.raises(BackendError) as err:
            routing.handle_rest("POST", "m", None, "predict", b"{}", label="nope")
        assert err.value.http_status == 412 and err.value.grpc_code == "FAILED_PRECONDITION"
        assert node.runtime.predicts == [ModelId("m", 2)]  # never forwarded
        req = _predict_req("m", 3.0)
        req.model_spec.version_label = "canary"
        resp = routing.predict(req)
        assert codec.tensorproto_to_numpy(resp.outputs["y"]).tolist() == [6.0]
        with pytest.raises(BackendError):
            routing.reload_config(sv.ReloadConfigRequest())
    finally:
        routing.close()
        cluster.disconnect()
        node.close()


def test_streamed_generate_is_relayed_buffered_through_a_forwarded_hop(tmp_path):
    store = make_store(tmp_path / "store", [("m", 1)])
    nodes = [fake_node(tmp_path, f"n{i}", store) for i in range(2)]
    cfgs = [n.cfg for n in nodes]
    try:
        with routed(nodes, cfgs, max_replicas_per_model=0) as routers:
            key_owner = routers[0].cluster.find_nodes_for_key("m##1")[0].ident
            r = next(r for r in routers if ident_of(r.node) != key_owner)
            url = f"/v1/models/m/versions/1:generate?stream=true"
            body = {"input_ids": [[1, 2]], "max_new_tokens": 3}
            got = http(f"http://127.0.0.1:{r.rest_port}{url}", body)
            direct = next(n for n in nodes if ident_of(n) == key_owner)
            want = http(f"http://127.0.0.1:{direct.rest_port}{url}", body)
            assert got[0] == want[0] == 200 and got[1] == want[1]
            assert got[2]["Content-Type"] == "text/event-stream"
            assert got[1].count(b"data: ") == 4
    finally:
        for n in nodes:
            n.close()


def test_router_threads_and_ports_are_released(tmp_path):
    import threading

    store = make_store(tmp_path / "store", [("m", 1)])
    before = {t.ident for t in threading.enumerate()}
    nodes = [fake_node(tmp_path, f"n{i}", store) for i in range(2)]
    try:
        with routed(nodes, [n.cfg for n in nodes]) as routers:
            ports = [(r.rest_port, r.grpc_port) for r in routers]
            assert all(p and g for p, g in ports)
            assert routers[0].warmer is not None and routers[0].replicas is not None
    finally:
        for n in nodes:
            n.close()
    wait_until(lambda: {t.ident for t in threading.enumerate() if t.is_alive()} <= before,
               timeout_s=30, what="every thread to end")
    for p, _g in ports:
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))  # the proxy port is free again


def test_router_serves_without_jax_or_aiohttp(tmp_path):
    """Two fake-runtime nodes, each behind a router, in a fresh interpreter
    where importing jax, the JAX package, aiohttp or prometheus_client
    fails: a routed predict answers from the owner."""
    make_store(tmp_path / "store", [(f"t{i}", 1) for i in range(4)])
    script = textwrap.dedent(f"""
        import json, sys, urllib.request
        import importlib.abc

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "tfservingcache_tpu", "aiohttp",
                                          "prometheus_client"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        from tfservingcache_tpu_torch.cluster.router import Router
        from tfservingcache_tpu_torch.config import config_from_dict
        from tfservingcache_tpu_torch.runtime.fake import FakeRuntime
        from tfservingcache_tpu_torch.server import CacheNode
        from tfservingcache_tpu_torch.utils.metrics import Metrics
        nodes, routers = [], []
        for i in range(2):
            cfg = config_from_dict({{
                "cache": {{"base_dir": {str(tmp_path)!r} + f"/cache{{i}}"}},
                "model_provider": {{"base_dir": {str(tmp_path / "store")!r}}},
                "cache_node": {{"rest_port": 0, "grpc_port": 0}},
                "proxy": {{"rest_port": 0, "grpc_port": 0}},
                "discovery": {{"type": "static", "prefer_localhost": True}}}})
            nodes.append(CacheNode(cfg, FakeRuntime(), metrics=Metrics()))
            nodes[-1].start("127.0.0.1")
        idents = [f"127.0.0.1:{{n.rest_port}}:{{n.grpc_port}}" for n in nodes]
        try:
            for n in nodes:
                n.cfg.discovery.nodes = idents
                routers.append(Router(n.cfg, n))
                routers[-1].start("127.0.0.1")
            for i in range(4):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{{routers[0].rest_port}}/v1/models/t{{i}}/versions/1:predict",
                    data=json.dumps({{"instances": [3.0]}}).encode(), method="POST")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    assert json.loads(resp.read()) == {{"predictions": [3.0]}}
            assert sum(len(n.runtime.predicts) for n in nodes) == 4
        finally:
            for r in routers:
                r.close()
            for n in nodes:
                n.close()
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "tfservingcache_tpu", "aiohttp", "prometheus_client")]
        assert not bad, bad
        print("ROUTED OK")
    """)
    env = dict(os.environ, TPUSC_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ROUTED OK" in r.stdout, r.stdout + r.stderr


def test_cli_serve_with_file_discovery_registers_routes_and_unregisters(tmp_path, store):
    """``cli serve`` with ``discovery: {type: file}`` (the docker-compose
    config's shape): the node's ident lands in the members file, the proxy
    REST port routes a predict, SIGTERM removes the ident and exits 0."""
    rest_port, proxy_port = _free_port(), _free_port()
    members_file = tmp_path / "members.json"
    cfg_path = tmp_path / "node.json"
    cfg_path.write_text(json.dumps({
        "serving": {"device": "cpu"},
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": rest_port, "grpc_port": 0},
        "proxy": {"rest_port": proxy_port, "grpc_port": 0, "replicas_per_model": 2},
        "discovery": {"type": "file", "path": str(members_file), "poll_interval_s": 0.1,
                      "prefer_localhost": True},
        "observability": {"flight_dir": str(tmp_path / "flight")},
    }))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfservingcache_tpu_torch.cli", "serve", "--config", str(cfg_path)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if http(f"http://127.0.0.1:{proxy_port}/healthz")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
            time.sleep(0.2)
        idents = json.loads(members_file.read_text())["nodes"]
        assert len(idents) == 1 and idents[0].startswith(f"127.0.0.1:{rest_port}:")
        status, raw, _ = http(f"http://127.0.0.1:{proxy_port}/v1/models/hpt/versions/1:predict",
                              {"instances": [2.0]})
        assert status == 200 and json.loads(raw) == {"predictions": [3.0]}
        status, raw, _ = http(f"http://127.0.0.1:{proxy_port}/monitoring/cluster")
        assert status == 200 and idents[0] in json.loads(raw)["nodes"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    out = proc.stdout.read()
    assert rc == 0, out
    assert json.loads(members_file.read_text())["nodes"] == []
    assert "router up" in out and "ignoring unknown config" not in out
