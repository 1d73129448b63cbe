"""One process of a port group that spans processes
(tests/test_torch_multihost.py): it joins a gloo process group, builds its
node with ``members`` CPU members, and either leads the group (process 0:
binds REST, answers the test's requests, writes the replies to
``<run_dir>/replies.json``) or follows it (the group-work service only,
until the leader writes ``<run_dir>/stop``). Every node is closed and the
process group destroyed before the process exits; neither role imports
JAX, which each asserts last.

argv: process_id coordinator_port worker_port... store_dir run_dir members
"""

import json
import os
import sys
import time
import urllib.error
import urllib.request

pid = int(sys.argv[1])
coord = sys.argv[2]
worker_ports = sys.argv[3:-3]
store, run_dir, members = sys.argv[-3], sys.argv[-2], int(sys.argv[-1])
nprocs = len(worker_ports)

import torch  # noqa: E402

# one thread: the replies are held bit for bit to a one-process runtime that
# runs with one thread too
torch.set_num_threads(1)

from tfservingcache_tpu_torch.config import config_from_dict  # noqa: E402
from tfservingcache_tpu_torch.server import build_node  # noqa: E402

IDS = [[3, 1, 4, 1, 5]]
CONV1 = list(range(2, 26))  # 24 tokens -> 32 valid rows -> 16 stored


def post(port: int, path: str, body: dict) -> tuple[int, dict | str]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=240) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def ok(port: int, path: str, body: dict) -> dict:
    status, out = post(port, path, body)
    assert status == 200, (path, status, out)
    return out


def lead(port: int, node) -> dict:
    from tfservingcache_tpu_torch.parallel.multihost import MultiHostGroupRuntime

    rt = node.runtime
    assert len(node.groups) == 1 and isinstance(rt, MultiHostGroupRuntime)
    assert rt.spans_processes and rt.mesh_lockstep and node.engine is None
    assert [d.type for d in rt.group] == ["cpu"] * members + ["meta"] * members * (nprocs - 1)
    out: dict = {}
    lm = "/v1/models/lm/versions/1"
    out["logits"] = ok(port, f"{lm}:predict", {"inputs": {"input_ids": IDS},
                                               "output_filter": ["logits"]})["outputs"]
    out["last"] = ok(port, f"{lm}:predict", {"inputs": {"input_ids": IDS}})["outputs"]
    out["toks"] = ok(port, f"{lm}:generate", {"input_ids": IDS, "max_new_tokens": 4,
                                              "seed": 3})["tokens"]
    # a two-turn conversation: turn 2 hits the prefix cache the leader
    # decides for the whole group
    out["c1"] = ok(port, f"{lm}:generate", {"input_ids": [CONV1], "max_new_tokens": 8,
                                            "seed": 7})["tokens"][0]
    conv2 = CONV1 + out["c1"] + [9, 10]
    out["c2"] = ok(port, f"{lm}:generate", {"input_ids": [conv2], "max_new_tokens": 8,
                                            "seed": 7})["tokens"][0]
    pc = rt._prefix_cache
    out["hits_turn2"] = pc.hits
    # a draft turn on the same conversation: the leader's prefix decision
    # rides the envelope into the cached-prefix speculative path
    conv3 = conv2 + out["c2"] + [11, 12]
    out["c3"] = ok(port, f"{lm}:generate", {"input_ids": [conv3], "max_new_tokens": 8,
                                            "temperature": 0.0,
                                            "draft_model": "draft"})["tokens"][0]
    out["hits_draft"] = pc.hits
    out["c3_plain"] = ok(port, f"{lm}:generate", {"input_ids": [conv3], "max_new_tokens": 8,
                                                  "temperature": 0.0})["tokens"][0]
    out["spec_rounds"] = rt.spec_rounds["solo"]
    # a family no cross-process group serves: every process refuses it
    # before any collective, and the group goes on serving
    out["bert"] = post(port, "/v1/models/bert/versions/1:predict",
                       {"inputs": {"input_ids": [[1, 2, 3]]}})
    out["healthy_after_bert"] = rt._unhealthy_reason is None
    if nprocs * members == 2:
        moe = "/v1/models/moe/versions/1"
        out["moe_logits"] = ok(port, f"{moe}:predict", {"inputs": {"input_ids": IDS},
                                                        "output_filter": ["logits"]})["outputs"]
        out["moe_toks"] = ok(port, f"{moe}:generate", {"input_ids": IDS, "max_new_tokens": 6,
                                                       "seed": 1})["tokens"]
    out["after_bert"] = ok(port, f"{lm}:predict", {"inputs": {"input_ids": IDS},
                                                   "output_filter": ["logits"]})["outputs"]
    return out


def main() -> None:
    cfg = config_from_dict({
        "model_provider": {"type": "disk", "base_dir": store},
        "cache": {"base_dir": os.path.join(run_dir, f"cache_{pid}")},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
        "serving": {"load_timeout_s": 240.0, "prefix_cache_bytes": 64 << 20},
        "mesh": {"chips_per_group": members * nprocs,
                 "coordinator": f"127.0.0.1:{coord}",
                 "num_processes": nprocs, "process_id": pid,
                 "worker_addrs": [f"127.0.0.1:{w}" for w in worker_ports]},
    })
    node = build_node(cfg, device="cpu")
    stop = os.path.join(run_dir, "stop")
    try:
        port = node.start("127.0.0.1")
        if pid != 0:
            assert not node.groups and node.work_handler is not None
            assert node.work_handler.group_indexes == [0]
            print("FOLLOWER READY", flush=True)
            deadline = time.monotonic() + 280
            while not os.path.exists(stop):
                assert time.monotonic() < deadline, "the leader never finished"
                time.sleep(0.05)
        else:
            out = lead(port, node)
            with open(os.path.join(run_dir, "replies.json.tmp"), "w") as fh:
                json.dump(out, fh)
            os.replace(os.path.join(run_dir, "replies.json.tmp"),
                       os.path.join(run_dir, "replies.json"))
    finally:
        node.close()
        if pid == 0:
            open(stop, "w").close()
    assert not torch.distributed.is_initialized()
    assert "jax" not in sys.modules, "a port process imported jax"
    print("LEADER DONE" if pid == 0 else "FOLLOWER DONE", flush=True)


main()
