"""The port's group across processes (tfservingcache_tpu_torch/parallel/
multihost.py) on the CPU: two child processes (tests/torch_multihost_child.py)
join a gloo process group and serve one tensor-parallel group, the leader
over REST, the follower through the group-work service, with the reference
test's artifacts (tests/test_multihost.py:46-64). Two arms:

  - P = 2, one member in each process: attention and the FFN are both cut
    across the process boundary;
  - P = 4, two members in each process (the reference's topology, where
    ``n_kv_heads: 2`` leaves attention replicated in each process).

The leader writes its replies; this process holds them to the JAX package's
unsharded ``TPUModelRuntime`` on the same store (the reference child's
bars: logits within 5e-2 with correlation > 0.9999, greedy tokens and
conversation turns 1-2 exact) and to the port's one-process
``TorchModelRuntime(devices=["cpu"] * P)`` (logits ``torch.equal``, tokens
identical), run with one thread as the children are. The draft turn equals
the group's own plain greedy turn, the leader's prefix cache hits, a bert
request answers the named refusal without a hang, and (P = 2) moe_lm's
replies are the one-process group's. Each child has its own timeout; the
children close their nodes and destroy their process groups themselves.
Last, the follower is ``cli serve`` configured by ``TPUSC_MESH_*``
variables, stopped with SIGTERM.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tfservingcache_tpu.cache.disk_cache import ModelDiskCache as JModelDiskCache
from tfservingcache_tpu.cache.manager import CacheManager as JCacheManager
from tfservingcache_tpu.cache.providers.disk import DiskModelProvider as JDiskModelProvider
from tfservingcache_tpu.config import ServingConfig as JServingConfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.runtime.model_runtime import TPUModelRuntime
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
from tfservingcache_tpu_torch.types import ModelId

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_multihost_child.py")
CHILD_TIMEOUT_S = 300

# the reference test's artifacts (tests/test_multihost.py:46-64)
LM = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
      "d_ff": 128, "max_seq": 64, "dtype": "bfloat16"}
DRAFT = {"vocab_size": 128, "d_model": 32, "n_layers": 1, "n_heads": 2, "n_kv_heads": 1,
         "d_ff": 64, "max_seq": 64, "dtype": "bfloat16"}
MOE = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
       "d_ff": 64, "n_experts": 4, "max_seq": 64, "dtype": "bfloat16"}
BERT = {"vocab_size": 128, "d_model": 64, "n_layers": 1, "n_heads": 4, "d_ff": 128,
        "max_seq": 32, "dtype": "float32"}
IDS = [[3, 1, 4, 1, 5]]
CONV1 = list(range(2, 26))


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("multihost_store")
    jreg.export_artifact("transformer_lm", str(base), name="lm", version=1, config=LM)
    jreg.export_artifact("transformer_lm", str(base), name="draft", version=1, seed=1,
                         config=DRAFT)
    jreg.export_artifact("moe_lm", str(base), name="moe", version=1, seed=2, config=MOE)
    jreg.export_artifact("bert", str(base), name="bert", version=1, seed=3, config=BERT)
    return base


def _run_group(store, run_dir, members: int, cli_follower: bool = False) -> dict:
    """Two children, ``members`` CPU members each -> the leader's replies.
    ``cli_follower``: process 1 is ``cli serve`` configured by ``TPUSC_*``
    variables, stopped with SIGTERM once the leader is done."""
    ports = _free_ports(3)
    coord, workers = ports[0], ports[1:]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    args = [str(coord), *[str(w) for w in workers], str(store), str(run_dir), str(members)]
    cmds = [[sys.executable, CHILD, str(pid), *args] for pid in range(2)]
    envs = [env, env]
    if cli_follower:
        cmds[1] = [sys.executable, "-m", "tfservingcache_tpu_torch.cli", "serve"]
        envs[1] = dict(env, OMP_NUM_THREADS="1", **{
            "TPUSC_SERVING_DEVICE": "cpu", "TPUSC_SERVING_LOAD_TIMEOUT_S": "240",
            "TPUSC_SERVING_PREFIX_CACHE_BYTES": str(64 << 20),
            "TPUSC_MODEL_PROVIDER_BASE_DIR": str(store),
            "TPUSC_CACHE_BASE_DIR": os.path.join(str(run_dir), "cache_cli"),
            "TPUSC_OBSERVABILITY_FLIGHT_DIR": os.path.join(str(run_dir), "flight"),
            "TPUSC_MESH_CHIPS_PER_GROUP": str(2 * members),
            "TPUSC_MESH_COORDINATOR": f"127.0.0.1:{coord}",
            "TPUSC_MESH_NUM_PROCESSES": "2", "TPUSC_MESH_PROCESS_ID": "1",
            "TPUSC_MESH_WORKER_ADDRS": ",".join(f"127.0.0.1:{w}" for w in workers)})
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=e, cwd=str(run_dir) if cli_follower and i else REPO)
             for i, (cmd, e) in enumerate(zip(cmds, envs))]
    outs = [""] * 2
    try:
        for i in (0, 1):
            if i == 1 and cli_follower and procs[1].poll() is None:
                procs[1].send_signal(signal.SIGTERM)
            try:
                outs[i], _ = procs[i].communicate(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                procs[i].kill()
                outs[i] = procs[i].communicate()[0]
                pytest.fail(f"child {i} timed out; output:\n{outs[i][-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    log = "\n".join(f"proc{i}:\n{o[-3000:]}" for i, o in enumerate(outs))
    assert procs[0].returncode == 0 and "LEADER DONE" in outs[0], log
    if cli_follower:
        assert procs[1].returncode == 0 and "group follower (process 1)" in outs[1], log
    else:
        assert procs[1].returncode == 0 and "FOLLOWER READY" in outs[1], log
        assert "FOLLOWER DONE" in outs[1], log
    with open(os.path.join(run_dir, "replies.json")) as fh:
        return json.load(fh)


def _jax_reference(store, cache_dir):
    rt = TPUModelRuntime(JServingConfig(prefix_cache_bytes=64 << 20))
    mgr = JCacheManager(JDiskModelProvider(str(store)),
                        JModelDiskCache(str(cache_dir), capacity_bytes=1 << 30), rt)
    return rt, mgr


def _port_reference(store, cache_dir, p: int):
    rt = TorchModelRuntime(ServingConfig(prefix_cache_bytes=64 << 20), devices=["cpu"] * p)
    mgr = CacheManager(DiskModelProvider(str(store)),
                       ModelDiskCache(str(cache_dir), capacity_bytes=1 << 30), rt)
    return rt, mgr


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("members", [1, 2], ids=["P2", "P4"])
def test_group_across_processes_serves_like_one_process(store, tmp_path, members):
    p = 2 * members
    got = _run_group(store, tmp_path, members)
    conv2 = CONV1 + got["c1"] + [9, 10]
    conv3 = conv2 + got["c2"] + [11, 12]

    # the group's own invariants
    assert got["hits_turn2"] >= 1 and got["hits_draft"] > got["hits_turn2"]
    assert got["c3"] == got["c3_plain"]  # the draft changes when, never which
    assert got["spec_rounds"] >= 1
    status, text = got["bert"]
    assert status == 500 and "cross-process groups: later slice" in text, got["bert"]
    assert got["healthy_after_bert"]
    assert got["after_bert"] == got["logits"]

    # the port's one-process group of the same P, one thread like the children
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rt, mgr = _port_reference(store, tmp_path / "ref_port", p)
    try:
        mid, draft = ModelId("lm", 1), ModelId("draft", 1)
        mgr.ensure_servable(mid)
        ids = np.asarray(IDS, np.int32)
        want = rt.predict(mid, {"input_ids": ids}, output_filter=["logits"])["logits"]
        assert torch.equal(torch.from_numpy(_f32(got["logits"])), torch.from_numpy(want))
        last = rt.predict(mid, {"input_ids": ids})["last_token_logits"]
        assert torch.equal(torch.from_numpy(_f32(got["last"])), torch.from_numpy(last))
        assert got["toks"] == rt.generate(mid, ids, max_new_tokens=4, seed=3).tolist()
        w1 = rt.generate(mid, np.asarray([CONV1], np.int32), max_new_tokens=8, seed=7)
        w2 = rt.generate(mid, np.asarray([conv2], np.int32), max_new_tokens=8, seed=7)
        assert [got["c1"], got["c2"]] == [w1[0].tolist(), w2[0].tolist()]
        mgr.ensure_servable(draft)
        w3 = rt.generate(mid, np.asarray([conv3], np.int32), max_new_tokens=8,
                         temperature=0.0, draft_model_id=draft)
        assert got["c3"] == w3[0].tolist()
        if members == 1:
            moe = ModelId("moe", 1)
            mgr.ensure_servable(moe)
            want = rt.predict(moe, {"input_ids": ids}, output_filter=["logits"])["logits"]
            assert torch.equal(torch.from_numpy(_f32(got["moe_logits"])),
                               torch.from_numpy(want))
            assert got["moe_toks"] == rt.generate(moe, ids, max_new_tokens=6, seed=1).tolist()
    finally:
        mgr.close()
        torch.set_num_threads(threads)

    # the JAX package's unsharded runtime (the reference child's bars)
    jrt, jmgr = _jax_reference(store, tmp_path / "ref_jax")
    try:
        jmid = JModelId("lm", 1)
        jmgr.ensure_servable(jmid)
        want = np.asarray(jrt.predict(jmid, {"input_ids": np.asarray(IDS, np.int32)},
                                      output_filter=["logits"])["logits"])
        logits = _f32(got["logits"])
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits, want, atol=5e-2, rtol=5e-2)
        assert np.corrcoef(logits.ravel(), want.ravel())[0, 1] > 0.9999
        np.testing.assert_allclose(_f32(got["last"])[0], logits[0, -1], atol=5e-2, rtol=5e-2)
        assert got["toks"] == jrt.generate(jmid, np.asarray(IDS, np.int32), max_new_tokens=4,
                                           seed=3).tolist()
        j1 = jrt.generate(jmid, np.asarray([CONV1], np.int32), max_new_tokens=8, seed=7)
        j2 = jrt.generate(jmid, np.asarray([conv2], np.int32), max_new_tokens=8, seed=7)
        assert [got["c1"], got["c2"]] == [j1[0].tolist(), j2[0].tolist()]
        assert jrt._prefix_cache.hits >= 1
    finally:
        jmgr.close()


def test_cli_serve_runs_a_follower_until_stopped(store, tmp_path):
    """``cli serve`` with ``TPUSC_MESH_*`` set and ``process_id`` 1 runs a
    pure follower: the leader child's whole request set answers through it,
    and it leaves at SIGTERM with exit 0."""
    got = _run_group(store, tmp_path, 1, cli_follower=True)
    assert got["hits_turn2"] >= 1 and got["c3"] == got["c3_plain"]
    assert got["bert"][0] == 500 and got["after_bert"] == got["logits"]
