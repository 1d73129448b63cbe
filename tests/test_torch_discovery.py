"""The port's consul, etcd and Kubernetes discovery clients
(tfservingcache_tpu_torch/cluster/discovery/{consul,etcd,kubernetes}.py)
against the JAX package's, both talking to one protocol-correct fake server
(tests/test_discovery_backends.py's aiohttp fakes, on an event loop of their
own thread): the same registrations and bodies land, and both clients see
the same membership after every change. Every client is unregistered in a
``finally``; the port's loops end with it."""

import asyncio

import pytest

from tfservingcache_tpu.cluster.discovery.consul import ConsulDiscoveryService as JConsul
from tfservingcache_tpu.cluster.discovery.etcd import EtcdDiscoveryService as JEtcd
from tfservingcache_tpu.cluster.discovery.kubernetes import K8sDiscoveryService as JK8s
from tfservingcache_tpu.types import NodeInfo as JNodeInfo
from tfservingcache_tpu_torch.cluster.discovery.consul import ConsulDiscoveryService
from tfservingcache_tpu_torch.cluster.discovery.etcd import EtcdDiscoveryService, prefix_range_end
from tfservingcache_tpu_torch.cluster.discovery.kubernetes import K8sDiscoveryService
from tfservingcache_tpu_torch.types import NodeInfo
from test_discovery_backends import FakeConsul, FakeEtcd, FakeK8s, endpoints_obj, serve_app, unb64
from torch_cluster_util import LoopThread, wait_until


def idents(nodes):
    return sorted(n.ident for n in nodes)


class RefClient:
    """A reference discovery client on the loop, its snapshots collected."""

    def __init__(self, loop, make):
        self.loop = loop
        self.seen: list = []

        async def start():
            svc = make()
            q = svc.subscribe()

            async def pump():
                while True:
                    self.seen.append(await q.get())

            return svc, asyncio.ensure_future(pump())

        self.svc, self._pump = loop.run(start())

    def register(self, node, healthy=lambda: True):
        self.loop.run(self.svc.register(JNodeInfo(node.host, node.rest_port, node.grpc_port),
                                        healthy))

    def last(self):
        return idents(self.seen[-1]) if self.seen else None

    def close(self):
        async def stop():
            self._pump.cancel()
            await self.svc.unregister()

        self.loop.run(stop())


def latest(q, pred, timeout_s=10.0):
    """Wait for a snapshot of the port client's queue that satisfies
    ``pred``; -> its idents."""
    wait_until(lambda: not q.empty() and pred(q.queue[-1]), timeout_s, "a membership snapshot")
    return idents(q.queue[-1])


@pytest.fixture
def loop():
    lt = LoopThread()
    try:
        yield lt
    finally:
        lt.close()


@pytest.fixture
def served(loop):
    """-> a function serving a fake's app on the loop, -> its URL."""
    runners = []

    def serve(app):
        runner, url = loop.run(serve_app(app))
        runners.append(runner)
        return url

    try:
        yield serve
    finally:
        for runner in runners:
            loop.run(runner.cleanup())


A, B = NodeInfo("10.0.0.1", 8094, 8095), NodeInfo("10.0.0.2", 8194, 8195)


def test_consul_port_and_reference_share_one_agent(loop, served):
    fake = FakeConsul()
    url = served(fake.app())
    port = ConsulDiscoveryService(url, "tpusc", ttl_s=0.2, poll_interval_s=0.05)
    ref = RefClient(loop, lambda: JConsul(url, "tpusc", ttl_s=0.2, poll_interval_s=0.05))
    q = port.subscribe()
    try:
        port.register(A, lambda: True)
        ref.register(B)
        sid = port._service_ids[0]
        got, want = fake.registrations[sid], fake.registrations[ref.svc._service_ids[0]]
        assert set(got) == set(want) and got["Check"] == want["Check"] == {
            "TTL": "0.2s", "DeregisterCriticalServiceAfter": "20s"}
        assert set(got["Tags"]) == {"rest:8094", "grpc:8095"}
        both = sorted([A.ident, B.ident])
        assert latest(q, lambda ns: len(ns) == 2) == both
        wait_until(lambda: ref.last() == both, what="the reference's view")
        wait_until(lambda: ("pass", f"service:{sid}") in fake.beats, what="a beat")
        fake.registrations["other"] = {"Name": "tpusc", "ID": "other", "Address": "10.0.0.3",
                                       "Tags": ["rest:1", "grpc:2"]}
        three = sorted(both + ["10.0.0.3:1:2"])
        assert latest(q, lambda ns: len(ns) == 3) == three
        wait_until(lambda: ref.last() == three, what="the reference's view")
    finally:
        port.unregister()
        ref.close()
    assert sid in fake.deregistered and port._threads == []


def test_consul_skips_bad_entries_and_keeps_membership_on_agent_errors(served):
    fake = FakeConsul()
    url = served(fake.app())
    fake.registrations["bad"] = {"Name": "tpusc", "ID": "bad", "Address": "10.9.9.9", "Tags": []}
    fake.registrations["worse"] = {"Name": "tpusc", "ID": "worse", "Address": "10.9.9.8",
                                   "Tags": ["rest:abc", "grpc:1"]}
    port = ConsulDiscoveryService(url, "tpusc", ttl_s=0.1, poll_interval_s=0.03)
    q = port.subscribe()
    try:
        port.register(A, lambda: False)  # unhealthy: its beats fail
        assert latest(q, lambda ns: len(ns) == 1) == [A.ident]
        wait_until(lambda: any(v == "fail" for v, _ in fake.beats), what="a failing beat")
        assert not any(v == "pass" for v, _ in fake.beats)
        fake.health_error = True
        n = q.qsize()
        wait_until(lambda: len([b for b in fake.beats if b[0] == "fail"]) >= 3, what="polls")
        assert q.qsize() == n  # an agent error publishes nothing
        fake.health_error = False
        fake.registrations["peer"] = {"Name": "tpusc", "ID": "peer", "Address": "10.0.0.2",
                                      "Tags": ["rest:1", "grpc:2"]}
        assert latest(q, lambda ns: len(ns) == 2) == [A.ident, "10.0.0.2:1:2"]
    finally:
        port.unregister()


def _notify(loop, fake, ev, key, value=""):
    loop.loop.call_soon_threadsafe(fake._notify, ev, key, value)


def test_etcd_port_and_reference_share_one_gateway(loop, served):
    fake = FakeEtcd()
    url = served(fake.app())
    port = EtcdDiscoveryService(url, "tpusc", ttl_s=1.0)
    ref = RefClient(loop, lambda: JEtcd(url, "tpusc", ttl_s=1.0))
    q = port.subscribe()
    try:
        port.register(A, lambda: True)
        ref.register(B)
        key = port._self_keys[0]
        assert fake.kv[key] == A.ident and key.startswith("/service/tpusc/")
        both = sorted([A.ident, B.ident])
        assert latest(q, lambda ns: len(ns) == 2) == both
        wait_until(lambda: ref.last() == both, what="the reference's view")
        wait_until(lambda: len(fake.watchers) == 2, what="both watch streams")
        fake.kv["/service/tpusc/peer1"] = "10.0.0.3:1:2"
        _notify(loop, fake, "PUT", "/service/tpusc/peer1", "10.0.0.3:1:2")
        three = sorted(both + ["10.0.0.3:1:2"])
        assert latest(q, lambda ns: len(ns) == 3) == three
        wait_until(lambda: ref.last() == three, what="the reference's view")
        del fake.kv["/service/tpusc/peer1"]
        _notify(loop, fake, "DELETE", "/service/tpusc/peer1")
        assert latest(q, lambda ns: len(ns) == 2) == both
        wait_until(lambda: ref.last() == both, what="the reference's view")
        grants = fake.lease_grants
        wait_until(lambda: fake.lease_grants >= grants + 2, what="fresh leases a beat")
        port.unregister()  # its key goes, its watch ends
        assert key not in fake.kv and port._threads == []
        wait_until(lambda: ref.last() == [B.ident], what="the reference seeing the port leave")
    finally:
        port.unregister()
        ref.close()
    assert unb64(prefix_range_end("/service/a/")) == "/service/a0"
    assert unb64(prefix_range_end("abc")) == "abd"


def test_k8s_port_and_reference_watch_one_api_server(loop, served, tmp_path):
    (tmp_path / "namespace").write_text("team-ns\n")
    (tmp_path / "token").write_text("sekrit")
    fake = FakeK8s()
    fake.endpoints["tpusc"] = endpoints_obj(
        "tpusc", ["10.0.0.1", "10.0.0.2"],
        extra_subset={"addresses": [{"ip": "10.0.9.9"}], "ports": [{"name": "http", "port": 80}]})
    url = served(fake.app())
    port = K8sDiscoveryService("tpusc", api_url=url, sa_dir=str(tmp_path), poll_interval_s=0.05)
    ref = RefClient(loop, lambda: JK8s("tpusc", api_url=url, sa_dir=str(tmp_path),
                                       poll_interval_s=0.05))
    assert port.namespace == ref.svc.namespace == "team-ns"
    assert port.field_selector == ref.svc.field_selector == "metadata.name=tpusc"
    assert port._endpoints_url(True, "7") == ref.svc._endpoints_url(True, "7")
    assert port._headers() == {"Authorization": "Bearer sekrit"}
    q = port.subscribe()
    try:
        port.register(NodeInfo("ignored", 0, 0), lambda: True)
        ref.register(NodeInfo("ignored", 0, 0))
        two = ["10.0.0.1:8094:8095", "10.0.0.2:8094:8095"]  # the unnamed subset skipped
        assert latest(q, lambda ns: len(ns) == 2) == two
        wait_until(lambda: ref.last() == two, what="the reference's view")
        wait_until(lambda: len(fake.watchers) == 2, what="both watch streams")
        for ev, ips in (("MODIFIED", ["10.0.0.1", "10.0.0.2", "10.0.0.3"]), ("DELETED", [])):
            loop.loop.call_soon_threadsafe(fake.push_event, ev, endpoints_obj("tpusc", ips))
            want = [f"{ip}:8094:8095" for ip in ips]
            assert latest(q, lambda ns, n=len(ips): len(ns) == n) == want
            wait_until(lambda w=want: ref.last() == w, what="the reference's view")
    finally:
        port.unregister()
        ref.close()
    assert port._thread is None


def test_k8s_needs_an_api_url_outside_a_cluster(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(ValueError, match="in-cluster"):
        K8sDiscoveryService("tpusc", sa_dir="/nonexistent")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.1.2.3")
    svc = K8sDiscoveryService("tpusc", sa_dir="/nonexistent")
    assert svc.api_url == "https://10.1.2.3:443" and svc.namespace == "default"
