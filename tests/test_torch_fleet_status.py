"""The port's fleet status plane (tfservingcache_tpu_torch/cluster/status.py)
against the JAX package's: ``NodeStatus`` blobs equal byte for byte (under
the byte cap too) and each package decodes the other's; ``FleetView``
health, warmth, snapshot rows and gauges equal on the same ingest and
forward sequence (fast enough that no status goes stale, so no clock
decides); a collector over the same loads reports the same models; the
``/monitoring/status`` and ``/monitoring/cluster`` bodies carry the
reference's keys; the piggyback rides REST headers and gRPC trailers; the
``drop_peer`` fault swallows a status; ``tools/fleet_top.py`` renders the
port's snapshot."""

import importlib.util
import io
import os
import random

import grpc
import pytest
from prometheus_client.parser import text_string_to_metric_families

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskProvider
from tfservingcache_tpu.cluster.status import FleetView as JFleetView
from tfservingcache_tpu.cluster.status import NodeStatus as JNodeStatus
from tfservingcache_tpu.cluster.status import StatusCollector as JStatusCollector
from tfservingcache_tpu.runtime.fake import FakeRuntime as JFakeRuntime
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch.cluster.status import (
    STATUS_HEADER,
    STATUS_TRAILER,
    STATUS_WANT_HEADER,
    STATUS_WANT_METADATA,
    FleetView,
    NodeStatus,
    StatusCollector,
    StatusExchange,
)
from tfservingcache_tpu_torch.lab import faults
from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel
from tfservingcache_tpu_torch.protocol.grpc_server import PREDICTION_SERVICE
from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv
from tfservingcache_tpu_torch.types import ModelId, NodeInfo
from tfservingcache_tpu_torch.utils.metrics import Metrics
from torch_cluster_util import TIMEOUT, fake_node, http, ident_of, make_store
from torch_obs_globals import confined_globals


@pytest.fixture(autouse=True)
def _globals():
    with confined_globals():
        yield


def _status(cls, seed: int, n_models: int, n_tenants: int):
    rng = random.Random(seed)
    return cls(
        ident=f"10.0.0.{seed}:9000:9100", seq=seed + 3, t_wall=1234.5678 + seed,
        models={f"tenant{i:04d}##{i % 3}": rng.choice([1, 2, 3]) for i in range(n_models)},
        inflight=rng.randrange(9), queue_depth=rng.randrange(5),
        oldest_wait_s=rng.random(), goodput=rng.random(), kv_pages_free=17,
        kv_pages_total=64, kv_pages_shared=3, host_tier_bytes=1 << 20, models_resident=2,
        tenants={f"t{i}@1": [rng.random() * 10 for _ in range(5)] for i in range(n_tenants)},
    )


@pytest.mark.parametrize("seed,n_models,n_tenants,cap", [
    (0, 2, 0, 4096), (1, 40, 3, 4096), (2, 500, 8, 512), (3, 500, 40, 256),
    (4, 64, 300, 1024), (5, 5000, 0, 64)])
def test_encode_is_the_reference_byte_for_byte(seed, n_models, n_tenants, cap):
    port, ref = _status(NodeStatus, seed, n_models, n_tenants), _status(
        JNodeStatus, seed, n_models, n_tenants)
    assert port.to_dict() == ref.to_dict()
    blob = port.encode(byte_cap=cap)
    assert blob == ref.encode(byte_cap=cap)
    assert len(blob) <= cap
    if blob:
        assert JNodeStatus.decode(blob).to_dict() == NodeStatus.decode(blob).to_dict()
    full = ref.encode(byte_cap=1 << 30)
    assert NodeStatus.decode(full).to_dict() == JNodeStatus.decode(full).to_dict() == ref.to_dict()


def test_decode_drops_garbage_like_the_reference():
    for blob in ("", None, "!!!not-base64!!!", "aGVsbG8="):
        assert NodeStatus.decode(blob) is None and JNodeStatus.decode(blob) is None
    for d in ({"models": {"m": 1}}, {"ident": "x", "seq": "NaN?"}, "nope",
              {"ident": "x", "models": {"m": 0, "n": 2}}):
        got, want = NodeStatus.from_dict(d), JNodeStatus.from_dict(d)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.to_dict() == want.to_dict()


def _gauges(text: bytes, families=("tpusc_peer_health_score", "tpusc_fleet_model_replicas")):
    out = {}
    for fam in text_string_to_metric_families(text.decode()):
        if fam.name in families:
            out.update({(s.name, tuple(sorted(s.labels.items()))): s.value
                        for s in fam.samples})
    return out


def _drive(fleet, status_cls, rng):
    """One random sequence of ingests (with reorderings) and forwards."""
    peers = [f"10.0.0.{i}:1:2" for i in range(4)]
    seqs = dict.fromkeys(peers, 0)
    for _ in range(120):
        peer = rng.choice(peers)
        if rng.random() < 0.5:
            seqs[peer] += rng.choice([1, 1, 1, -2])  # sometimes an older seq
            fleet.ingest(status_cls(ident=peer, seq=seqs[peer], models={
                f"m{j}##1": rng.choice([0, 1, 2, 3]) for j in range(rng.randrange(4))}))
        else:
            ok = rng.random() < 0.7
            fleet.note_forward(peer, ok, rng.random() * 0.5 if ok else None)
    return peers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_view_scores_like_the_reference(seed):
    port_metrics, ref_metrics = Metrics(), JMetrics()
    port = FleetView(metrics=port_metrics)
    ref = JFleetView(metrics=ref_metrics)
    peers = _drive(port, NodeStatus, random.Random(seed))
    _drive(ref, JNodeStatus, random.Random(seed))
    for peer in peers + ["unknown:1:2"]:
        assert port.health(peer) == pytest.approx(ref.health(peer), rel=1e-12, abs=1e-12)
        for j in range(4):
            assert port.warmth(peer, f"m{j}##1") == ref.warmth(peer, f"m{j}##1")
    got, want = port.snapshot(), ref.snapshot()
    assert set(got) == set(want) and got["models"] == want["models"]
    assert got["tenants"] == want["tenants"]
    for ident, row in want["nodes"].items():
        assert set(got["nodes"][ident]) == set(row)
        for key, val in row.items():
            if key != "status_age_s":
                assert got["nodes"][ident][key] == val, (ident, key)
    assert _gauges(port_metrics.render()) == _gauges(ref_metrics.render())
    # pruning forgets the departed peers and their series in both
    live = [NodeInfo.from_ident(peers[0])]
    port.prune(live)
    ref.prune(live)
    assert _gauges(port_metrics.render()) == _gauges(ref_metrics.render())
    assert set(port.snapshot()["nodes"]) == {peers[0]}
    assert "10.0.0.1:1:2" not in port_metrics.render().decode()


def test_health_down_and_recovery_arithmetic():
    fleet = FleetView()
    assert fleet.health("p") == 1.0
    for _ in range(3):
        fleet.note_forward("p", False)
    assert fleet.health("p") == pytest.approx(0.7 ** 3, abs=1e-6)
    assert fleet.health("p") < fleet.health_threshold
    for _ in range(3):
        fleet.note_forward("p", True, 0.01)
    assert fleet.health("p") > fleet.health_threshold


def test_staleness_gates_warmth_and_decays_health():
    fleet = FleetView(stale_after_s=15.0)
    assert fleet.ingest(NodeStatus(ident="p:1:2", seq=5, models={"m##1": 2}))
    assert not fleet.ingest(NodeStatus(ident="p:1:2", seq=4, models={}))
    assert fleet.warmth("p:1:2", "m##1") == 2
    fleet._peers["p:1:2"].received_mono -= 60.0  # rewound: no sleeps
    assert fleet.warmth("p:1:2", "m##1") == 0
    assert fleet.health("p:1:2") == pytest.approx(15.0 / 60.0, rel=1e-3)
    assert fleet.snapshot()["nodes"]["p:1:2"]["stale"] is True


def test_drop_peer_fault_swallows_the_status():
    fleet = FleetView()
    faults.arm([faults.FaultSpec(kind="drop_peer", peer="a:1:2", count=0)])
    try:
        assert not fleet.ingest(NodeStatus(ident="a:1:2", seq=1, models={"m##1": 3}))
        assert fleet.ingest(NodeStatus(ident="b:1:2", seq=1, models={"m##1": 3}))
        assert faults.snapshot()[0] == {"kind": "drop_peer", "visits": 1, "fired": 1}
    finally:
        faults.disarm()
    assert fleet.warmth("a:1:2", "m##1") == 0 and fleet.status_age_s("a:1:2") is None
    assert fleet.ingest(NodeStatus(ident="a:1:2", seq=1, models={"m##1": 3}))


def test_collector_reports_what_the_reference_collector_does(tmp_path):
    store = make_store(tmp_path / "store", [(f"t{i}", 1) for i in range(12)])
    node = fake_node(tmp_path, "port", store)
    jmanager = JCacheManager(JDiskProvider(str(store)),
                             JDiskCache(str(tmp_path / "jcache"), capacity_bytes=1 << 20),
                             JFakeRuntime())
    try:
        for i in range(12):
            node.manager.ensure_servable(ModelId(f"t{i}", 1))
            jmanager.ensure_servable(JModelId(f"t{i}", 1))
        for i in range(0, 12, 3):  # on disk only
            node.runtime.unload(ModelId(f"t{i}", 1))
            jmanager.runtime.unload(JModelId(f"t{i}", 1))
        for max_models in (64, 5):
            got = StatusCollector("a", node.manager, max_models=max_models,
                                  min_interval_s=0.0).collect().to_dict()
            want = JStatusCollector("a", jmanager, max_models=max_models,
                                    min_interval_s=0.0).collect().to_dict()
            for key in ("models", "models_resident", "truncated", "queue_depth", "goodput",
                        "kv_pages_free"):
                assert got[key] == want[key], key
            # the ledger's vectors hold measured load seconds (which order
            # the rows): the row counts match
            assert len(got["tenants"]) == len(want["tenants"]) == 8
        collector = node.groups[0].status
        assert collector.ident == ident_of(node)
        first = collector.collect()
        assert collector.collect() is first  # cached for min_interval_s
        assert NodeStatus.decode(collector.encoded()).ident == ident_of(node)
    finally:
        node.close()
        jmanager.close()


def test_status_piggybacks_on_rest_and_grpc_when_asked(tmp_path):
    store = make_store(tmp_path / "store", [("m", 1)])
    node = fake_node(tmp_path, "a", store)
    url = f"http://127.0.0.1:{node.rest_port}/v1/models/m/versions/1:predict"
    channel = make_channel(f"127.0.0.1:{node.grpc_port}")
    try:
        status, _, headers = http(url, {"instances": [1.0]})
        assert status == 200 and STATUS_HEADER not in headers
        status, _, headers = http(url, {"instances": [1.0]}, headers={STATUS_WANT_HEADER: "1"})
        st = NodeStatus.decode(headers[STATUS_HEADER])
        assert status == 200 and st.ident == ident_of(node) and st.models == {"m##1": 3}
        # an error answer carries it too: the peer is up
        status, _, headers = http(url.replace("/m/", "/nope/"), {"instances": [1.0]},
                                  headers={STATUS_WANT_HEADER: "1"})
        assert status == 404 and NodeStatus.decode(headers[STATUS_HEADER]) is not None
        req = sv.PredictRequest()
        req.model_spec.name = "m"
        req.model_spec.version.value = 1
        req.inputs["x"].dtype = 1
        req.inputs["x"].tensor_shape.dim.add(size=1)
        req.inputs["x"].float_val.append(2.0)
        predict = ServingStub(channel).method(PREDICTION_SERVICE, "Predict")
        _, call = predict.with_call(req, timeout=TIMEOUT)
        assert STATUS_TRAILER not in dict(call.trailing_metadata())
        _, call = predict.with_call(req, metadata=((STATUS_WANT_METADATA, "1"),),
                                    timeout=TIMEOUT)
        st = NodeStatus.decode(dict(call.trailing_metadata())[STATUS_TRAILER])
        assert st.ident == ident_of(node)
        req.model_spec.name = "nope"
        with pytest.raises(grpc.RpcError) as err:
            predict(req, metadata=((STATUS_WANT_METADATA, "1"),), timeout=TIMEOUT)
        assert err.value.code() == grpc.StatusCode.NOT_FOUND
        assert NodeStatus.decode(dict(err.value.trailing_metadata())[STATUS_TRAILER])
    finally:
        channel.close()
        node.close()


def test_monitoring_bodies_have_the_reference_keys(tmp_path):
    store = make_store(tmp_path / "store", [("m", 1)])
    node = fake_node(tmp_path, "a", store)
    jmanager = JCacheManager(JDiskProvider(str(store)),
                             JDiskCache(str(tmp_path / "jcache"), capacity_bytes=1 << 20),
                             JFakeRuntime())
    try:
        node.manager.ensure_servable(ModelId("m", 1))
        jmanager.ensure_servable(JModelId("m", 1))
        base = f"http://127.0.0.1:{node.rest_port}"
        import json

        status, body, _ = http(base + "/monitoring/status")
        got = json.loads(body)
        want = JStatusCollector("a", jmanager, min_interval_s=0.0).collect().to_dict()
        assert status == 200 and set(got) == set(want) and got["models"] == want["models"]
        assert got["ident"] == ident_of(node) and got["models_resident"] == 1
        assert http(base + "/monitoring/cluster")[0] == 404  # a node has no fleet view
        node.rest.status_collector = None
        status, body, _ = http(base + "/monitoring/status")
        assert status == 404 and json.loads(body) == {
            "error": "status exchange not enabled on this server"}
        # a fleet view answers /monitoring/cluster with the reference's rows
        fleet, jfleet = FleetView(), JFleetView()
        for f, cls in ((fleet, NodeStatus), (jfleet, JNodeStatus)):
            f.ingest(cls(ident="p:1:2", seq=1, models={"m##1": 3}))
            f.note_forward("q:1:2", False)
        node.rest.fleet = fleet
        status, body, _ = http(base + "/monitoring/cluster")
        got, want = json.loads(body), jfleet.snapshot()
        assert status == 200 and set(got) == set(want)
        assert {k: set(v) for k, v in got["nodes"].items()} == {
            k: set(v) for k, v in want["nodes"].items()}
    finally:
        node.close()
        jmanager.close()


def test_status_exchange_polls_quiet_peers_and_reads_its_own(tmp_path):
    store = make_store(tmp_path / "store", [("m", 1)])
    a, b = fake_node(tmp_path, "a", store), fake_node(tmp_path, "b", store)
    try:
        b.manager.ensure_servable(ModelId("m", 1))
        fleet = FleetView()
        ex = StatusExchange(fleet, {ident_of(a): a.groups[0].status}, poll_interval_s=60.0)
        ex.on_update([NodeInfo.from_ident(ident_of(a)), NodeInfo.from_ident(ident_of(b)),
                      NodeInfo("127.0.0.1", 1, 1)])  # nothing listens on the last
        assert ex.poll_once() == 2
        assert fleet.warmth(ident_of(b), "m##1") == 3
        assert ex.poll_once() == 0  # fresh: b is not polled again, a's seq is cached
        ex.start()
        ex.close()
        assert ex._thread is None
    finally:
        a.close()
        b.close()


def _fleet_top():
    path = os.path.join(os.path.dirname(__file__), "..", "tools", "fleet_top.py")
    spec = importlib.util.spec_from_file_location("fleet_top", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_top_renders_the_port_snapshot():
    fleet = FleetView()
    fleet.ingest(NodeStatus(
        ident="10.0.0.1:9000:9100", seq=3, models={"m##1": 2, "n##1": 1},
        inflight=2, queue_depth=1, oldest_wait_s=0.03, goodput=0.91,
        kv_pages_free=20, kv_pages_total=64, host_tier_bytes=3 << 20))
    fleet.note_forward("10.0.0.1:9000:9100", True, 0.02)
    for _ in range(3):
        fleet.note_forward("10.0.0.2:9000:9100", False)
    out = io.StringIO()
    _fleet_top().render(fleet.snapshot(), out=out)
    text = out.getvalue()
    assert "2 peers" in text and "20/64" in text and "3.0MiB" in text
    assert "m@1" in text and "host[10.0.0.1:9000:9100]" in text
    assert "never" in text and "0.34*" in text
