"""The port's ReplicaController (tfservingcache_tpu_torch/cluster/
replication.py) against the JAX package's: the same start/end schedule,
``evaluate`` called directly (no thread), gives the same targets tick for
tick and the same ``tpusc_model_replicas_target`` series; growth warms the
newly assigned local group; the ring reads the per-key count through
``replicas_for_key``."""

import random

import pytest
from prometheus_client.parser import text_string_to_metric_families

from tfservingcache_tpu.cluster.replication import ReplicaController as JReplicaController
from tfservingcache_tpu.utils.metrics import Metrics as JMetrics
from tfservingcache_tpu_torch.cluster.cluster import ClusterConnection
from tfservingcache_tpu_torch.cluster.replication import ReplicaController
from tfservingcache_tpu_torch.types import ModelId
from tfservingcache_tpu_torch.utils.metrics import Metrics
from test_torch_cluster import MockDiscovery, members
from torch_cluster_util import fake_node, make_store, wait_until


def _targets(text: bytes) -> dict:
    for fam in text_string_to_metric_families(text.decode()):
        if fam.name == "tpusc_model_replicas_target":
            return {s.labels["model"]: s.value for s in fam.samples}
    return {}


def _schedule(seed: int, ticks: int = 60):
    """Per tick: a list of ("start" | "end", key) notes, then an evaluate."""
    rng = random.Random(seed)
    keys = [f"m{i}##1" for i in range(4)]
    open_ = dict.fromkeys(keys, 0)
    out = []
    for tick in range(ticks):
        notes = []
        burst = tick < ticks // 2
        for _ in range(rng.randrange(12 if burst else 3)):
            key = rng.choice(keys[:2] if burst else keys)
            if open_[key] and rng.random() < (0.3 if burst else 0.8):
                open_[key] -= 1
                notes.append(("end", key))
            else:
                open_[key] += 1
                notes.append(("start", key))
        if not burst:  # the load drains
            for key in keys:
                notes += [("end", key)] * open_[key]
                open_[key] = 0
        out.append(notes)
    return out


@pytest.mark.parametrize("seed,base,top,target,decay", [
    (0, 1, 4, 2.0, 3), (1, 1, 3, 1.0, 1), (2, 2, 6, 1.5, 4), (3, 1, 1, 2.0, 2)])
def test_evaluate_gives_the_reference_sequence(seed, base, top, target, decay):
    pm, jm = Metrics(), JMetrics()
    kw = dict(base_replicas=base, max_replicas=top, load_target=target, decay_ticks=decay)
    port = ReplicaController(None, metrics=pm, **kw)
    ref = JReplicaController(None, metrics=jm, **kw)
    grew = False
    for notes in _schedule(seed):
        for kind, key in notes:
            getattr(port, f"note_{kind}")(key)
            getattr(ref, f"note_{kind}")(key)
        got, want = port.evaluate(), ref.evaluate()
        assert got == want
        grew |= any(n > base for n in got.values())
        for key in ("m0##1", "m3##1", "never##1"):
            assert port.replicas_for(key) == ref.replicas_for(key)
        assert _targets(pm.render()) == _targets(jm.render())
    assert grew == (top > base)
    for _ in range(50):  # idle ticks: the EWMAs decay and the keys go
        got = port.evaluate()
        assert got == ref.evaluate()
        if not got:
            break
    assert got == {} and _targets(pm.render()) == {}


def test_growth_warms_the_new_local_replica_and_the_ring_follows(tmp_path):
    store = make_store(tmp_path / "store", [("hot", 1)])
    node = fake_node(tmp_path, "a", store)
    mock = MockDiscovery()
    cluster = ClusterConnection(mock, replicas_per_model=1)
    mock.push(members(4))
    cluster.connect(members(4)[0], lambda: True, wait_ready_s=5)
    try:
        idents = cluster.ring.get_n("hot##1", 2)
        ctl = ReplicaController(cluster, base_replicas=1, max_replicas=2, load_target=1.0,
                                local_managers={idents[1]: node.manager})
        cluster.replicas_for_key = ctl.replicas_for
        assert [n.ident for n in cluster.find_nodes_for_key("hot##1")] == idents[:1]
        for _ in range(4):
            ctl.note_start("hot##1")
        assert ctl.evaluate() == {"hot##1": 2}
        assert [n.ident for n in cluster.find_nodes_for_key("hot##1")] == idents
        wait_until(lambda: node.runtime.is_loaded(ModelId("hot", 1)), what="the warm")
        for _ in range(4):
            ctl.note_end("hot##1")
        ticks = 0
        while ctl.evaluate():
            ticks += 1
        assert ticks >= ctl.decay_ticks  # shrinks only after the hysteresis
        assert len(cluster.find_nodes_for_key("hot##1")) == 1
        ctl.interval_s = 0.01
        ctl.start()
        ctl.close()
        assert ctl._thread is None
    finally:
        cluster.disconnect()
        node.close()
