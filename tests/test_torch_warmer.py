"""The port's AssignmentWarmer (tfservingcache_tpu_torch/cluster/warmer.py),
mirroring tests/test_warmer.py: on a membership change the owned models
already on local disk are loaded, the unowned and the not-on-disk ones are
not; a remap warms the newly owned; the sweep stops at the runtime's free
resident capacity. Each scenario runs the reference's warmer beside the
port's on the same ring and store, and the two load the same models.
Fetching to disk without a load (the reference manager's ``prefetch``) is
the port manager's miss-path fetch."""

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JDiskCache
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskProvider
from tfservingcache_tpu.cluster.warmer import AssignmentWarmer as JWarmer
from tfservingcache_tpu.runtime.fake import FakeRuntime as JFakeRuntime
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider
from tfservingcache_tpu_torch.cluster.warmer import AssignmentWarmer
from tfservingcache_tpu_torch.models import registry
from tfservingcache_tpu_torch.runtime.fake import FakeRuntime
from tfservingcache_tpu_torch.types import ModelId, NodeInfo
from tfservingcache_tpu_torch.utils.metrics import Metrics
from torch_cluster_util import make_store, wait_until


class RingStub:
    """find_nodes_for_key from a fixed key -> ports mapping."""

    def __init__(self, owners_by_key):
        self.owners_by_key = owners_by_key

    def find_nodes_for_key(self, key):
        return [NodeInfo("h", 1, int(p)) for p in self.owners_by_key.get(key, [])]


SELF = NodeInfo("h", 1, 7001).ident


class Pair:
    """A port and a reference manager over one store, each with its
    warmer on one ring."""

    def __init__(self, tmp_path, ring, max_loaded=None, metrics=None):
        store = str(make_store(tmp_path / "store", [("a", 1), ("b", 1), ("c", 1)], nbytes=10))
        self.runtime = FakeRuntime(max_loaded=max_loaded)
        self.manager = CacheManager(DiskModelProvider(store),
                                    ModelDiskCache(str(tmp_path / "cache"), 1000), self.runtime)
        self.jruntime = JFakeRuntime(max_loaded=max_loaded)
        self.jmanager = JCacheManager(JDiskProvider(store),
                                      JDiskCache(str(tmp_path / "jcache"), 1000), self.jruntime)
        self.warmer = AssignmentWarmer(ring, [(SELF, self.manager)], metrics=metrics)
        self.jwarmer = JWarmer(ring, [(SELF, self.jmanager)])

    def prefetch(self, name):
        self.manager._fetch(ModelId(name, 1))
        self.jmanager.prefetch(JModelId(name, 1))

    def serve(self, name):
        self.manager.ensure_servable(ModelId(name, 1))
        self.jmanager.ensure_servable(JModelId(name, 1))

    def update(self):
        self.warmer.on_update([])
        self.jwarmer.on_update([])

    def loads(self):
        return [str(m) for m in self.runtime.loads], [str(m) for m in self.jruntime.loads]

    def close(self):
        self.warmer.close()
        self.jwarmer.close()
        self.manager.close()
        self.jmanager.close()


def test_owned_on_disk_models_are_warmed(tmp_path):
    metrics = Metrics()
    pair = Pair(tmp_path, RingStub({"a##1": [7001, 7002], "b##1": [7002], "c##1": [7001]}),
                metrics=metrics)
    try:
        pair.prefetch("a")
        pair.prefetch("b")
        pair.update()
        wait_until(lambda: pair.warmer.warmed == 1 and pair.jwarmer.warmed == 1, what="warms")
        got, want = pair.loads()
        assert got == want == ["a@1"]  # b is not owned, c is not on disk
        assert not pair.runtime.is_loaded(ModelId("c", 1))
        assert b"tpusc_assignment_warms_total 1.0" in metrics.render()
    finally:
        pair.close()


def test_rewarm_after_remap(tmp_path):
    ring = RingStub({"a##1": [7001]})
    pair = Pair(tmp_path, ring)
    try:
        pair.prefetch("a")
        pair.prefetch("b")
        pair.update()
        wait_until(lambda: pair.warmer.warmed == pair.jwarmer.warmed == 1, what="warms")
        ring.owners_by_key["b##1"] = [7001]
        pair.update()
        wait_until(lambda: pair.runtime.is_loaded(ModelId("b", 1))
                   and pair.jruntime.is_loaded(JModelId("b", 1)), what="the remap's warm")
        assert pair.runtime.is_loaded(ModelId("a", 1))
        got, want = pair.loads()
        assert got == want == ["a@1", "b@1"]
    finally:
        pair.close()


def test_sweep_bounded_by_resident_capacity(tmp_path):
    pair = Pair(tmp_path, RingStub({k: [7001] for k in ("a##1", "b##1", "c##1")}), max_loaded=2)
    try:
        pair.prefetch("a")
        pair.serve("a")  # serving, must survive the sweep
        pair.prefetch("b")
        pair.prefetch("c")
        pair.update()
        wait_until(lambda: len(pair.runtime.loads) == len(pair.jruntime.loads) == 2,
                   what="one warm into the one free slot")
        pair.warmer.on_update([])  # a second sweep changes nothing
        pair.warmer.close()
        pair.jwarmer.close()
        got, want = pair.loads()
        assert got == want and len(got) == 2
        assert pair.runtime.unloads == pair.jruntime.unloads == []
        assert pair.runtime.is_loaded(ModelId("a", 1))
    finally:
        pair.close()


def test_resident_bytes_estimate_reads_the_manifest(tmp_path):
    path = registry.export_artifact("half_plus_two", str(tmp_path), name="hpt", device="cpu")
    assert registry.resident_bytes_estimate(path) == 8  # two f32 scalars
    assert registry.resident_bytes_estimate(str(tmp_path / "missing")) is None
