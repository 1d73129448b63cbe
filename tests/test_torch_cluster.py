"""The port's ring plumbing and file/static discovery
(tfservingcache_tpu_torch/cluster/{cluster,discovery}) against the JAX
package's: the same membership places every key on the same replicas, and a
port node and a reference node share one members file, each seeing the
other. The reference's asyncio objects run on an event loop of their own
thread (tests/torch_cluster_util.py)."""

import asyncio
import json
import queue
import time

import pytest

from tfservingcache_tpu.cluster.cluster import ClusterConnection as JCluster
from tfservingcache_tpu.cluster.discovery.base import DiscoveryService as JDiscovery
from tfservingcache_tpu.cluster.discovery.filewatch import FileDiscoveryService as JFileDiscovery
from tfservingcache_tpu.types import NodeInfo as JNodeInfo
from tfservingcache_tpu_torch.cluster.cluster import ClusterConnection
from tfservingcache_tpu_torch.cluster.discovery import create_discovery
from tfservingcache_tpu_torch.cluster.discovery.base import DiscoveryService
from tfservingcache_tpu_torch.cluster.discovery.filewatch import (
    READ_RETRIES,
    FileDiscoveryService,
)
from tfservingcache_tpu_torch.cluster.discovery.static import StaticDiscoveryService
from tfservingcache_tpu_torch.config import DiscoveryConfig
from tfservingcache_tpu_torch.types import NodeInfo
from torch_cluster_util import LoopThread, wait_until


class MockDiscovery(DiscoveryService):
    """Pushes membership by hand (the reference's DiscoveryServiceMock)."""

    def register(self, self_node, is_healthy):
        pass

    def unregister(self):
        pass

    def push(self, nodes):
        self._publish(nodes)


class JMockDiscovery(JDiscovery):
    async def register(self, self_node, is_healthy):
        pass

    async def unregister(self):
        pass


def members(n, base_port=9000):
    return [NodeInfo(f"10.0.0.{i}", base_port + i, base_port + 100 + i) for i in range(n)]


@pytest.fixture
def loop():
    lt = LoopThread()
    try:
        yield lt
    finally:
        lt.close()


def _connected(loop, nodes, replicas):
    """A port and a reference ClusterConnection holding ``nodes``."""
    mock = MockDiscovery()
    port = ClusterConnection(mock, replicas_per_model=replicas)
    mock.push(nodes)
    port.connect(nodes[0], lambda: True, wait_ready_s=5)
    jmock = JMockDiscovery()
    ref = JCluster(jmock, replicas_per_model=replicas)
    jmock._publish([JNodeInfo(n.host, n.rest_port, n.grpc_port) for n in nodes])
    loop.run(ref.connect(JNodeInfo(nodes[0].host, nodes[0].rest_port, nodes[0].grpc_port),
                         lambda: True, wait_ready_s=5))
    return port, ref


@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("n_nodes", [3, 7])
def test_ring_places_keys_like_the_reference(loop, replicas, n_nodes):
    port, ref = _connected(loop, members(n_nodes), replicas)
    try:
        assert port.node_count == ref.node_count == n_nodes
        for i in range(200):
            key = f"tenant{i}##{i % 5}"
            got = [n.ident for n in port.find_nodes_for_key(key)]
            want = [n.ident for n in ref.find_nodes_for_key(key)]
            assert got == want and len(got) == min(replicas, n_nodes), key
    finally:
        port.disconnect()
        loop.run(ref.disconnect())


def test_replicas_for_key_hook_is_prefix_stable(loop):
    port, ref = _connected(loop, members(5), 1)
    try:
        for n in (1, 2, 4):
            port.replicas_for_key = ref.replicas_for_key = lambda key, n=n: n
            for i in range(50):
                key = f"m{i}##1"
                got = [x.ident for x in port.find_nodes_for_key(key)]
                assert got == [x.ident for x in ref.find_nodes_for_key(key)]
                port.replicas_for_key = lambda key: 1
                assert [x.ident for x in port.find_nodes_for_key(key)] == got[:1]
                port.replicas_for_key = lambda key, n=n: n
        # a failing hook falls back to the static count
        port.replicas_for_key = lambda key: 1 / 0
        assert len(port.find_nodes_for_key("m0##1")) == 1
    finally:
        port.disconnect()
        loop.run(ref.disconnect())


def test_membership_updates_swap_the_ring_and_run_callbacks():
    mock = MockDiscovery()
    cluster = ClusterConnection(mock, replicas_per_model=2)
    seen = queue.Queue()
    cluster.on_update.append(lambda nodes: seen.put(len(nodes)))
    cluster.on_update.insert(0, lambda nodes: 1 / 0)  # a failing callback stops nothing
    mock.push(members(5))
    cluster.connect(members(5)[0], lambda: True, wait_ready_s=5)
    try:
        assert seen.get(timeout=10) == 5 and cluster.node_count == 5
        found = cluster.find_nodes_for_key("m##1")
        assert len(found) == 2 and found[0].ident != found[1].ident
        assert cluster.node_for_key("m##1") in found
        mock.push(members(2))
        assert seen.get(timeout=10) == 2
        wait_until(lambda: cluster.node_count == 2, what="the ring swap")
    finally:
        cluster.disconnect()
    assert cluster._thread is None


def test_connect_without_membership_times_out_to_an_empty_ring():
    cluster = ClusterConnection(MockDiscovery())
    cluster.connect(members(1)[0], lambda: True, wait_ready_s=0.05)
    try:
        assert cluster.node_count == 0 and cluster.find_nodes_for_key("m##1") == []
        assert cluster.node_for_key("m##1") is None
    finally:
        cluster.disconnect()


def test_static_discovery_accumulates_registrations():
    d = StaticDiscoveryService(["10.0.0.1:1:2"])
    q = d.subscribe()
    d.register(NodeInfo("10.0.0.2", 3, 4), lambda: True)
    d.register(NodeInfo("10.0.0.3", 5, 6), lambda: True)
    d.register(NodeInfo("10.0.0.1", 1, 2), lambda: True)  # already listed
    assert [n.ident for n in q.get(timeout=1)] == ["10.0.0.1:1:2", "10.0.0.2:3:4"]
    for _ in range(2):
        assert [n.ident for n in q.get(timeout=1)] == [
            "10.0.0.1:1:2", "10.0.0.2:3:4", "10.0.0.3:5:6"]
    late = d.subscribe()  # a late subscriber gets the last snapshot at once
    assert len(late.get(timeout=1)) == 3
    d.unregister()


def test_create_discovery_builds_every_backend(tmp_path):
    assert isinstance(create_discovery(DiscoveryConfig(type="static", nodes=["h:1:2"])),
                      StaticDiscoveryService)
    assert isinstance(create_discovery(DiscoveryConfig(type="FILE", path=str(tmp_path / "m"))),
                      FileDiscoveryService)
    names = {t: type(create_discovery(DiscoveryConfig(type=t, address="http://127.0.0.1:1")))
             .__name__ for t in ("consul", "etcd", "k8s", "kubernetes")}
    assert names == {"consul": "ConsulDiscoveryService", "etcd": "EtcdDiscoveryService",
                     "k8s": "K8sDiscoveryService", "kubernetes": "K8sDiscoveryService"}
    with pytest.raises(ValueError, match="unknown discovery type"):
        create_discovery(DiscoveryConfig(type="zookeeper"))


def _drain_until(q, pred, timeout_s=10.0):
    wait_until(lambda: not q.empty() and pred(q.queue[-1]), timeout_s, "a membership snapshot")
    return q.queue[-1]


def test_file_discovery_register_watch_unregister(tmp_path):
    path = str(tmp_path / "members.json")
    d1 = FileDiscoveryService(path, poll_interval_s=0.05)
    d2 = FileDiscoveryService(path, poll_interval_s=0.05)
    n1, n2 = NodeInfo("127.0.0.1", 9001, 9101), NodeInfo("127.0.0.1", 9002, 9102)
    q = d1.subscribe()
    try:
        d1.register(n1, lambda: True)
        d2.register(n2, lambda: True)
        seen = _drain_until(q, lambda nodes: len(nodes) == 2)
        assert {n.ident for n in seen} == {n1.ident, n2.ident}
        d2.unregister()
        assert json.load(open(path))["nodes"] == [n1.ident]
        _drain_until(q, lambda nodes: [n.ident for n in nodes] == [n1.ident])
    finally:
        d2.unregister()
        d1.unregister()
    assert json.load(open(path))["nodes"] == []


def test_file_discovery_puts_back_a_clobbered_ident(tmp_path):
    path = tmp_path / "members.json"
    d = FileDiscoveryService(str(path), poll_interval_s=0.05)
    q = d.subscribe()
    try:
        d.register(NodeInfo("127.0.0.1", 1, 2), lambda: True)
        path.write_text(json.dumps({"nodes": ["10.0.0.9:5:6", "bad-ident"]}))  # a racing writer
        _drain_until(q, lambda nodes: {n.ident for n in nodes} == {"10.0.0.9:5:6",
                                                                   "127.0.0.1:1:2"})
        assert sorted(json.loads(path.read_text())["nodes"]) == [
            "10.0.0.9:5:6", "127.0.0.1:1:2", "bad-ident"]
    finally:
        d.unregister()


def test_file_discovery_leaves_a_torn_members_file_alone(tmp_path):
    """A poll that catches another writer mid-write skips its round: it
    neither writes this node's ident over the others' nor publishes."""
    path = tmp_path / "members.json"
    d = FileDiscoveryService(str(path), poll_interval_s=0.05)
    q = d.subscribe()
    try:
        d.register(NodeInfo("127.0.0.1", 1, 2), lambda: True)
        _drain_until(q, lambda nodes: [n.ident for n in nodes] == ["127.0.0.1:1:2"])
        published = q.qsize()
        torn = '{"nodes": ["10.0.0.9:5:6", "127.0.0.1:1'
        path.write_text(torn)
        time.sleep(0.5)
        assert path.read_text() == torn and q.qsize() == published
        path.write_text(json.dumps({"nodes": ["10.0.0.9:5:6"]}))
        _drain_until(q, lambda nodes: {n.ident for n in nodes} == {"10.0.0.9:5:6",
                                                                   "127.0.0.1:1:2"})
    finally:
        d.unregister()


def test_file_discovery_register_and_unregister_leave_a_torn_members_file_alone(tmp_path):
    """``register`` and ``unregister`` that find the file torn, and find it
    torn again on each re-read, write nothing: neither this node's ident
    alone nor ``[]`` over the other members'. A registered node joins once
    the file reads again."""
    path = tmp_path / "members.json"
    torn = '{"nodes": ["10.0.0.9:5:6", "127.0.0.1:1'
    path.write_text(torn)
    d = FileDiscoveryService(str(path), poll_interval_s=0.05)
    q = d.subscribe()
    try:
        d.register(NodeInfo("127.0.0.1", 1, 2), lambda: True)
        assert path.read_text() == torn
        path.write_text(json.dumps({"nodes": ["10.0.0.9:5:6"]}))
        _drain_until(q, lambda nodes: {n.ident for n in nodes} == {"10.0.0.9:5:6",
                                                                   "127.0.0.1:1:2"})
        wait_until(lambda: "127.0.0.1:1:2" in path.read_text(), 10.0, "the re-registration")
        path.write_text(torn)
    finally:
        d.unregister()
    assert path.read_text() == torn


@pytest.mark.parametrize("torn_reads", [1, READ_RETRIES - 1])
def test_file_discovery_rereads_a_torn_members_file(tmp_path, monkeypatch, torn_reads):
    """A members file that reads torn fewer times than the retry bound is
    read again: ``register`` adds its ident to the other members' and
    ``unregister`` removes only its own."""
    path = tmp_path / "members.json"
    path.write_text(json.dumps({"nodes": ["10.0.0.9:5:6"]}))
    d = FileDiscoveryService(str(path), poll_interval_s=3600)
    read = d._read

    def torn_then_whole():
        left = [torn_reads]

        def reading():
            if left[0]:
                left[0] -= 1
                return None
            return read()

        return reading

    monkeypatch.setattr("tfservingcache_tpu_torch.cluster.discovery.filewatch.READ_RETRY_S", 0)
    try:
        d._read = torn_then_whole()
        d.register(NodeInfo("127.0.0.1", 1, 2), lambda: True)
        assert json.loads(path.read_text()) == {"nodes": ["10.0.0.9:5:6", "127.0.0.1:1:2"]}
    finally:
        d._read = torn_then_whole()
        d.unregister()
    assert json.loads(path.read_text()) == {"nodes": ["10.0.0.9:5:6"]}


def test_port_and_reference_nodes_share_one_members_file(tmp_path, loop):
    """The members file is the reference's format: each side registers,
    each sees both, and the port's unregister leaves the reference's line."""
    path = str(tmp_path / "members.json")
    port = FileDiscoveryService(path, poll_interval_s=0.05)
    port_node = NodeInfo("127.0.0.1", 9001, 9101)
    ref_node = JNodeInfo("127.0.0.1", 9002, 9102)
    ref_seen: list = []

    async def start_ref():
        ref = JFileDiscovery(path, poll_interval_s=0.05)
        q = ref.subscribe()

        async def pump():
            while True:
                ref_seen.append(await q.get())

        await ref.register(ref_node, lambda: True)
        return ref, asyncio.ensure_future(pump())

    q = port.subscribe()
    ref, pump = loop.run(start_ref())
    try:
        port.register(port_node, lambda: True)
        both = {port_node.ident, ref_node.ident}
        _drain_until(q, lambda nodes: {n.ident for n in nodes} == both)
        wait_until(lambda: ref_seen and {n.ident for n in ref_seen[-1]} == both,
                   what="the reference's view")
        port.unregister()
        assert json.load(open(path))["nodes"] == [ref_node.ident]
        wait_until(lambda: [n.ident for n in ref_seen[-1]] == [ref_node.ident],
                   what="the reference seeing the port leave")
    finally:
        port.unregister()

        async def stop_ref():
            pump.cancel()
            await ref.unregister()

        loop.run(stop_ref())
    assert json.load(open(path))["nodes"] == []
