"""The plumbing of the port's group across processes
(tfservingcache_tpu_torch/parallel/multihost.py), case for case after the
reference's tests/test_multihost_unit.py on the port's classes, its stdlib
work server and urllib: the envelope codec (and the envelope across the two
packages, both ways), the follower handler's dispatch and errors, the
leader's broadcast and its error classes, failure containment and
re-formation, the leader-decided draft gate, and the prefetch budget. Every
server and runtime is closed in a ``finally``."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.parallel import multihost as jmh
from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.parallel import multihost as mh
from tfservingcache_tpu_torch.parallel.multihost import (
    GroupWorkHandler,
    GroupWorkServer,
    MultiHostGroupRuntime,
    decode_work,
    encode_work,
)
from tfservingcache_tpu_torch.runtime.base import GroupUnhealthyError, RuntimeError_
from tfservingcache_tpu_torch.types import ModelId


def test_work_envelope_roundtrip():
    meta = {"op": "predict", "model": "m", "version": 3, "group": 1,
            "output_filter": ["logits"]}
    arrays = {
        "input_ids": np.arange(6, dtype=np.int32).reshape(2, 3),
        "prompt_lengths": np.array([3, 2], np.int32),
    }
    meta2, arrays2 = decode_work(encode_work(meta, arrays))
    assert meta2 == meta
    np.testing.assert_array_equal(arrays2["input_ids"], arrays["input_ids"])
    np.testing.assert_array_equal(arrays2["prompt_lengths"], arrays["prompt_lengths"])
    # empty-array envelope
    m3, a3 = decode_work(encode_work({"op": "ensure", "group": 0}))
    assert m3["op"] == "ensure" and a3 == {}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_work_envelope_decodes_across_packages(direction):
    """An envelope either package encodes decodes in the other, bytes equal
    both ways (a leader and a follower of different packages agree on the
    wire)."""
    meta = {"op": "generate", "model": "lm", "version": 1, "group": 0, "max_new_tokens": 8,
            "temperature": 0.0, "top_k": 0, "seed": 7, "draft_model": "", "draft_version": 0,
            "spec_tokens": 4, "prefix_rows": 16, "budget_s": 30.0,
            "cfg": {"prefix_cache": True}}
    arrays = {"input_ids": np.arange(12, dtype=np.int32).reshape(1, 12),
              "prompt_lengths": np.array([12], np.int32),
              "x": np.linspace(-1, 1, 10, dtype=np.float32).reshape(2, 5)}
    enc, dec = ((jmh.encode_work, decode_work) if direction == "jax_to_port"
                else (encode_work, jmh.decode_work))
    body = enc(meta, arrays)
    assert body == (encode_work if enc is jmh.encode_work else jmh.encode_work)(meta, arrays)
    got_meta, got_arrays = dec(body)
    assert got_meta == meta
    assert sorted(got_arrays) == sorted(arrays)
    for k, v in arrays.items():
        assert got_arrays[k].dtype == v.dtype
        np.testing.assert_array_equal(got_arrays[k], v)


class _RecordingManager:
    def __init__(self):
        self.calls = []

    def ensure_servable(self, mid):
        self.calls.append(("ensure", mid))

    def prefetch(self, mid):
        self.calls.append(("prefetch", mid))


class _RecordingRuntime:
    def __init__(self):
        self.calls = []

    def predict(self, mid, inputs, output_filter=None):
        self.calls.append(("predict", mid, sorted(inputs), output_filter))
        return {}

    def unload(self, mid):
        self.calls.append(("unload", mid))


def _post(port, meta, arrays=None):
    """POST a work envelope to a running GroupWorkServer -> (status, JSON)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/tpusc/groupwork",
                                 data=encode_work(meta, arrays))
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _server(manager, runtime, group=0, port=0):
    handler = GroupWorkHandler()
    handler.register(group, manager, runtime)
    srv = GroupWorkServer(handler)
    return srv, srv.start(port, host="127.0.0.1")


def _leader(port, **serving):
    return MultiHostGroupRuntime(ServingConfig(**serving), device="cpu",
                                 followers=[f"127.0.0.1:{port}"], group_index=0)


def _wait(cond, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"{what} never held"
        time.sleep(0.05)


def test_handler_dispatch_and_errors():
    mgr, rt = _RecordingManager(), _RecordingRuntime()
    srv, port = _server(mgr, rt, group=2)
    try:
        status, out = _post(port, {"op": "predict", "model": "m", "version": 1, "group": 2,
                                   "output_filter": None}, {"x": np.ones((1, 2), np.float32)})
        assert status == 200 and out["ok"]
        assert mgr.calls == [("ensure", ModelId("m", 1))]
        assert rt.calls[0][:2] == ("predict", ModelId("m", 1))

        status, out = _post(port, {"op": "prefetch", "model": "m", "version": 1, "group": 2})
        assert status == 200 and ("prefetch", ModelId("m", 1)) in mgr.calls

        status, out = _post(port, {"op": "unload", "model": "m", "version": 1, "group": 2})
        assert status == 200 and ("unload", ModelId("m", 1)) in rt.calls

        # unknown op -> 500 with the cause in the body
        status, out = _post(port, {"op": "explode", "model": "m", "version": 1, "group": 2})
        assert status == 500 and not out["ok"] and "explode" in out["error"]
        # unknown group -> 500, not a crash
        status, out = _post(port, {"op": "ensure", "model": "m", "version": 1, "group": 9})
        assert status == 500 and "9" in out["error"]
    finally:
        srv.close()


def test_leader_broadcast_surfaces_follower_error_detail():
    """The leader's join carries the follower's real exception text, not
    just 'HTTP Error 500' (a prefetch IO failure must be diagnosable)."""

    class _FailingManager(_RecordingManager):
        def prefetch(self, mid):
            raise FileNotFoundError(f"artifact store gone for {mid}")

    srv, port = _server(_FailingManager(), _RecordingRuntime())
    try:
        leader = _leader(port)
        try:
            futures = leader._broadcast({"op": "prefetch", "model": "m", "version": 1})
            with pytest.raises(RuntimeError, match="artifact store gone"):
                leader._join(futures)
        finally:
            leader.close()
    finally:
        srv.close()


def test_follower_timeout_tied_to_request_deadline():
    """A slow follower fails the leader's op within about the request
    deadline (serving.load_timeout_s), not the work_timeout_s backstop."""

    class _SlowManager(_RecordingManager):
        def prefetch(self, mid):
            time.sleep(4.0)

    srv, port = _server(_SlowManager(), _RecordingRuntime())
    try:
        leader = _leader(port, load_timeout_s=0.5)
        assert leader._op_timeout_s == 0.5  # min(work 600, load 0.5)
        try:
            t0 = time.monotonic()
            futures = leader._broadcast({"op": "prefetch", "model": "m", "version": 1})
            # transport death is typed: retriable elsewhere for the client
            with pytest.raises(GroupUnhealthyError, match="follower"):
                leader._join(futures)
            assert time.monotonic() - t0 < 3.0  # about the deadline, not 600 s
        finally:
            leader.close()
    finally:
        srv.close()


def test_group_failure_containment_and_reformation(tmp_path, monkeypatch):
    """A follower killed mid-stream: the leader marks the group unhealthy
    (requests fail fast with GroupUnhealthyError, 503), its heartbeat fails
    (manager.is_healthy False: discovery drops the group), and once the
    follower is back the re-formation loop resets every process's group
    state and serves again."""
    monkeypatch.setattr(mh, "REFORM_PROBE_PERIOD_S", 0.2)

    class _ResettableRuntime(_RecordingRuntime):
        def reset_group_state(self):
            self.calls.append(("reset",))

    srv, port = _server(_RecordingManager(), _ResettableRuntime())
    leader = _leader(port, load_timeout_s=2.0)
    (tmp_path / "store").mkdir()
    manager = CacheManager(DiskModelProvider(str(tmp_path / "store")),
                           ModelDiskCache(str(tmp_path / "cache"), capacity_bytes=1 << 20),
                           leader)
    srv2 = None
    try:
        # healthy: a collective round-trips and the heartbeat passes
        leader._run_collective({"op": "ensure", "model": "m", "version": 1}, None,
                               lambda: None)
        assert manager.is_healthy()

        # the follower dies: the TRIGGERING request already gets the
        # retriable 503-mapped error, not a raw 500
        srv.close()
        with pytest.raises(GroupUnhealthyError, match="followers failed"):
            leader._run_collective({"op": "ensure", "model": "m", "version": 1}, None,
                                   lambda: None)
        assert leader._unhealthy_reason is not None

        # new requests fail FAST (no queueing into the dead group) ...
        t0 = time.monotonic()
        with pytest.raises(GroupUnhealthyError, match="re-forming"):
            leader._run_collective({"op": "ensure", "model": "m", "version": 1}, None,
                                   lambda: None)
        assert time.monotonic() - t0 < 0.5
        # ... and the group's heartbeat fails
        assert not manager.is_healthy()

        # the follower returns on the same address: the loop pings it,
        # broadcasts a reset, resets the leader and rejoins
        rt2 = _ResettableRuntime()
        srv2, _ = _server(_RecordingManager(), rt2, port=port)
        _wait(lambda: leader._unhealthy_reason is None, what="re-formation")
        assert ("reset",) in rt2.calls
        leader._run_collective({"op": "ensure", "model": "m", "version": 1}, None,
                               lambda: None)
        assert manager.is_healthy()
        # a STALE failure from before the re-formation must not tear the
        # healthy group down again
        assert leader._epoch == 1
        leader._mark_unhealthy("late pre-teardown timeout", epoch=0)
        assert leader._unhealthy_reason is None
    finally:
        manager.close()
        srv.close()
        if srv2 is not None:
            srv2.close()


def test_wedged_follower_timeout_contains_group(monkeypatch):
    """A follower alive but WEDGED (the work call outlasts the op deadline)
    tears the group down too, and while it stays wedged (ping finds the
    lock busy) re-formation does not proceed."""
    monkeypatch.setattr(mh, "REFORM_PROBE_PERIOD_S", 0.2)

    class _WedgedManager(_RecordingManager):
        def ensure_servable(self, mid):
            time.sleep(4.0)  # stuck mid-collective

    srv, port = _server(_WedgedManager(), _RecordingRuntime())
    leader = _leader(port, load_timeout_s=0.5)
    try:
        with pytest.raises(GroupUnhealthyError, match="followers failed"):
            leader._run_collective({"op": "ensure", "model": "m", "version": 1}, None,
                                   lambda: None)
        assert leader._unhealthy_reason is not None
        # the wedged follower answers pings "lock busy": still down after
        # several probe periods
        time.sleep(1.0)
        assert leader._unhealthy_reason is not None
    finally:
        leader.close()
        srv.close()


def test_leader_gates_group_draft_on_low_acceptance(tmp_path):
    """The draft-acceptance gate of a group is the leader's: after sustained
    low acceptance the envelope ships NO draft (followers run the same
    plain decode), and the tokens stay exact throughout."""
    from tfservingcache_tpu_torch.runtime.model_runtime import SPEC_DISABLE_AFTER

    cfg_t = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
             "d_ff": 128, "max_seq": 128, "rope_theta": 10000.0, "dtype": "float32"}
    cfg_d = dict(cfg_t, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64)
    store = tmp_path / "store"
    jreg.export_artifact("transformer_lm", str(store), name="target", version=1, seed=0,
                         config=cfg_t)
    md = jreg.build("transformer_lm", cfg_d)
    import jax

    zeros = jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                   md.init(jax.random.PRNGKey(9)))
    jreg.save_artifact(str(store / "adver" / "1"), md, zeros)

    class _EnvelopeRuntime(_RecordingRuntime):
        def __init__(self):
            super().__init__()
            self.drafts = []
            self.admitted = []

        def generate(self, mid, ids, **kw):
            self.drafts.append(kw.get("draft_model_id"))
            self.admitted.append(kw.get("spec_admitted"))
            return np.zeros((1, 4), np.int32)

    rt_f = _EnvelopeRuntime()
    srv, port = _server(_RecordingManager(), rt_f)
    leader = _leader(port)
    manager = CacheManager(DiskModelProvider(str(store)),
                           ModelDiskCache(str(tmp_path / "cache"), capacity_bytes=1 << 30),
                           leader)
    try:
        big, adv = ModelId("target", 1), ModelId("adver", 1)
        manager.ensure_servable(big)
        manager.ensure_servable(adv)
        rng = np.random.default_rng(5)
        for _ in range(SPEC_DISABLE_AFTER + 2):
            ids = rng.integers(1, 128, (1, 8)).astype(np.int32)
            ref = leader.generate(big, ids, max_new_tokens=12, temperature=0.0)
            got = leader.generate(big, ids, max_new_tokens=12, temperature=0.0,
                                  draft_model_id=adv)
            np.testing.assert_array_equal(got, ref)
        assert leader._spec_health[(big, adv)]["disabled"]
        # the follower's envelopes show the gate flip: a draft early, none
        # once disabled
        assert adv in [d for d in rt_f.drafts if d is not None]
        assert rt_f.drafts[-1] is None, rt_f.drafts[-3:]
        # a shipped draft is the leader's decision: the follower's own gate
        # must not drop it (spec_admitted), and without one nothing is
        # admitted
        assert rt_f.admitted == [True if d is not None else None for d in rt_f.drafts]
    finally:
        manager.close()
        srv.close()


def test_symmetric_validation_failure_keeps_leader_error_type():
    """A malformed request every process refuses (same validation, before
    device work) surfaces the leader's TYPED error (RuntimeError_ answers
    400), not a builtin RuntimeError from the follower join, and does NOT
    tear the group down."""

    class _RejectingManager(_RecordingManager):
        def ensure_servable(self, mid):
            raise ValueError("bad temperature")  # an application 500 on the follower

    srv, port = _server(_RejectingManager(), _RecordingRuntime())
    leader = _leader(port)
    try:
        def fn():
            raise RuntimeError_("temperature must be >= 0")

        with pytest.raises(RuntimeError_, match="temperature"):
            leader._run_collective({"op": "ensure", "model": "m", "version": 1}, None, fn)
        assert leader._unhealthy_reason is None  # symmetric != the group's death
    finally:
        leader.close()
        srv.close()


def test_config_mismatch_blocks_group_and_reformation(monkeypatch):
    """serving.prefix_cache_bytes differing across a group is a PERMANENT
    misconfiguration: the follower refuses every envelope (the re-formation
    ping included) with a clear error, so the group fails once and stays
    down with its reason instead of churning teardown and re-formation."""
    monkeypatch.setattr(mh, "REFORM_PROBE_PERIOD_S", 0.2)
    srv, port = _server(_RecordingManager(), _RecordingRuntime())  # cache off here
    leader = _leader(port, prefix_cache_bytes=1 << 20)
    try:
        with pytest.raises(GroupUnhealthyError, match="config mismatch"):
            leader._run_collective({"op": "ensure", "model": "m", "version": 1}, None,
                                   lambda: None)
        assert leader._unhealthy_reason is not None
        time.sleep(1.2)
        assert leader._unhealthy_reason is not None
    finally:
        leader.close()
        srv.close()


def test_follower_drops_expired_queued_prefetch_only():
    """A PREFETCH whose budget elapsed while queued fails fast (the leader
    abandoned it), but a collective op runs however late: the leader has
    entered its half already."""
    mgr, rt = _RecordingManager(), _RecordingRuntime()
    srv, port = _server(mgr, rt)
    try:
        status, out = _post(port, {"op": "prefetch", "model": "m", "version": 1, "group": 0,
                                   "budget_s": 0.0})
        assert status == 500 and "expired" in out["error"]
        assert ("prefetch", ModelId("m", 1)) not in mgr.calls
        status, out = _post(port, {"op": "ensure", "model": "m", "version": 1, "group": 0,
                                   "budget_s": 0.0})
        assert status == 200 and out["ok"]
        assert ("ensure", ModelId("m", 1)) in mgr.calls
    finally:
        srv.close()


def test_closed_server_leaves_no_work_thread():
    """close() shuts the work pool down and joins its threads."""
    srv, port = _server(_RecordingManager(), _RecordingRuntime())
    assert _post(port, {"op": "ensure", "model": "m", "version": 1, "group": 0})[0] == 200
    srv.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("tpusc-gw", "tpusc-groupwork"))]


# -- the group's placement and the runtime's forced decisions -----------------

@pytest.mark.parametrize("n_proc,per,rank", [(2, 1, 0), (2, 1, 1), (2, 2, 1), (4, 2, 2)])
def test_cross_process_group_places_members_by_rank(n_proc, per, rank):
    import torch

    from tfservingcache_tpu_torch.parallel import mesh

    group = mesh.cross_process_group(["cpu"] * per, n_proc, rank)
    assert len(group) == n_proc * per and mesh.group_axes(group) == {"model": n_proc * per}
    own = list(range(rank * per, (rank + 1) * per))
    assert mesh.local_members(group) == own
    assert [d.type for d in group] == ["cpu" if i in own else "meta" for i in range(len(group))]
    assert mesh.local_lead(group) == torch.device("cpu") and mesh.spans_processes(group)
    assert not mesh.spans_processes((torch.device("cpu"),) * 2)
    with pytest.raises(ValueError):
        mesh.cross_process_group(["cpu"], n_proc, n_proc)


@pytest.mark.parametrize("n_proc,per,rank", [(2, 1, 0), (2, 1, 1), (2, 2, 1)])
def test_a_process_keeps_only_its_members_shards(n_proc, per, rank):
    """The rules cut the tree as on the one-process group of the same P;
    this process's members hold those shards bit for bit, another's hold
    meta tensors of the same shapes, a replicated leaf sits on this
    process's leader, and the TP module's halves run there."""
    import torch

    from tfservingcache_tpu_torch.models import registry as treg
    from tfservingcache_tpu_torch.parallel import mesh, sharding

    cfg = {"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 4, "n_kv_heads": 2,
           "d_ff": 48, "max_seq": 32, "dtype": "float32"}
    md = treg.build("transformer_lm", cfg)
    params = md.init(torch.Generator().manual_seed(0))
    p = n_proc * per
    group = mesh.cross_process_group(["cpu"] * per, n_proc, rank)
    plan = md.tensor_parallel(group)
    mine = treg.flatten_params(sharding.shard_params(params, plan.rules, group))
    ref = treg.flatten_params(sharding.shard_params(params, plan.rules, ("cpu",) * p))
    own = mesh.local_members(group)
    for (path, leaf), (_p, want) in zip(mine, ref, strict=True):
        assert leaf.spec == want.spec and leaf.shape == want.shape, path
        for i, (got, exp) in enumerate(zip(leaf.shards, want.shards, strict=True)):
            assert got.shape == exp.shape, path
            if i in own:
                assert got.device.type == "cpu" and torch.equal(got, exp), (path, i)
            else:
                assert got.is_meta, (path, i)
    module = plan.make_module(sharding.shard_params(params, plan.rules, group))
    assert module.lead == torch.device("cpu")
    attn = module.layers[0].attn
    assert attn.devices == (group if p <= 2 else (torch.device("cpu"),))
    kv = sharding.shard_kv_arena({"k": torch.empty((1, 2, 2, 4, 8), device="meta")}, group)
    if p <= 2:
        assert [t.device.type for t in kv["k"].shards] == [d.type for d in group]
        assert kv["k"].device == torch.device("cpu")
    else:  # P does not divide the KV heads: whole on this process's leader
        assert kv["k"].device == torch.device("cpu") and tuple(kv["k"].shape) == (1, 2, 2, 4, 8)


CFG_F32 = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
           "d_ff": 128, "max_seq": 128, "rope_theta": 10000.0, "dtype": "float32"}


@pytest.fixture(scope="module")
def f32_store(tmp_path_factory):
    base = tmp_path_factory.mktemp("forced_store")
    jreg.export_artifact("transformer_lm", str(base), name="m", version=1, config=CFG_F32)
    return base


def _runtimes(store, prefix_bytes):
    from tfservingcache_tpu.config import ServingConfig as JServingConfig
    from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
    from tfservingcache_tpu.types import Model as JModel
    from tfservingcache_tpu.types import ModelId as JModelId
    from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
    from tfservingcache_tpu_torch.types import Model

    port = TorchModelRuntime(ServingConfig(prefix_cache_bytes=prefix_bytes), device="cpu")
    port.ensure_loaded(Model(identifier=ModelId("m", 1), path=str(store / "m" / "1")))
    ref = TPUModelRuntime(JServingConfig(platform="cpu", prefix_cache_bytes=prefix_bytes))
    ref.ensure_loaded(JModel(identifier=JModelId("m", 1), path=str(store / "m" / "1")))
    return (port, ModelId("m", 1)), (ref, JModelId("m", 1))


def test_forced_prefix_decisions_match_the_reference(f32_store):
    """``generate(prefix_rows=...)``, the envelope's decision, on one device
    against the JAX runtime: 0 is a counted miss through the cache, the
    leader's peeked N reuses N rows (same tokens), more rows than this
    process holds and any decision without a cache refuse before a device
    op, -1 runs the plain path and stores nothing."""
    rng = np.random.default_rng(3)
    t1 = rng.integers(1, 128, (1, 20)).astype(np.int32)
    extra = rng.integers(1, 128, (1, 5)).astype(np.int32)
    (port, mid), (ref, jmid) = _runtimes(f32_store, 64 << 20)
    try:
        outs = []
        for rt, m in ((port, mid), (ref, jmid)):
            pc = rt._prefix_cache
            a = rt.generate(m, t1, max_new_tokens=12, prefix_rows=0)
            assert (pc.hits, pc.misses, len(pc)) == (0, 1, 1)
            t2 = np.concatenate([t1, np.asarray(a, np.int32), extra], 1)
            rows = pc.peek(m, t2[0])
            assert rows > 0 and (pc.hits, pc.misses) == (0, 1)  # peek counts nothing
            b = rt.generate(m, t2, max_new_tokens=8, prefix_rows=rows)
            assert pc.hits == 1
            with pytest.raises(Exception, match="prefix-cache divergence"):
                rt.generate(m, t2, max_new_tokens=8, prefix_rows=t2.shape[1] + 8)
            n, hits, misses = len(pc), pc.hits, pc.misses
            c = rt.generate(m, t2, max_new_tokens=8, prefix_rows=-1)
            assert (len(pc), pc.hits, pc.misses) == (n, hits, misses)  # no lookup, no insert
            outs.append((a, b, c, rows))
        (pa, pb, pcc, prow), (ja, jb, jc, jrow) = outs
        assert prow == jrow
        np.testing.assert_array_equal(pa, np.asarray(ja))
        np.testing.assert_array_equal(pb, np.asarray(jb))
        np.testing.assert_array_equal(pcc, np.asarray(jc))
        np.testing.assert_array_equal(pb, pcc)  # the reused rows change no token
    finally:
        port.close()
    (port, mid), (ref, jmid) = _runtimes(f32_store, 0)
    try:
        for rt, m in ((port, mid), (ref, jmid)):
            with pytest.raises(Exception, match="prefix-cache divergence"):
                rt.generate(m, t1, max_new_tokens=4, prefix_rows=0)
            np.asarray(rt.generate(m, t1, max_new_tokens=4, prefix_rows=-1))
    finally:
        port.close()


def test_reset_group_state_empties_the_runtime(f32_store):
    """``reset_group_state`` leaves nothing resident, an empty prefix cache
    and no draft-acceptance history, as the reference's does; the model
    loads again on demand."""
    from tfservingcache_tpu_torch.types import Model

    (port, mid), (ref, jmid) = _runtimes(f32_store, 64 << 20)
    try:
        for rt, m in ((port, mid), (ref, jmid)):
            rt.generate(m, np.arange(1, 21, dtype=np.int32)[None], max_new_tokens=12)
            rt._spec_health[(m, m)] = {"low_streak": 3, "disabled": False, "skipped": 0}
            assert rt.is_loaded(m) and len(rt._prefix_cache) == 1
            rt.reset_group_state()
            assert not rt.is_loaded(m) and len(rt._prefix_cache) == 0
            assert rt._spec_health == {} and rt.resident_models() == []
        port.ensure_loaded(Model(identifier=mid, path=str(f32_store / "m" / "1")))
        assert port.is_loaded(mid)
    finally:
        port.close()
