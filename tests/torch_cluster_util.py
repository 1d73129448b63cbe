"""Shared pieces of the port's cluster tests (tests/test_torch_{cluster,
router,fleet_status,migration,discovery,...}.py): an event loop on a thread
of its own for the reference's asyncio objects, a model store of stub
artifacts, port cache nodes on ``runtime/fake.py`` and a wait with a
deadline. Every port is 0 and every node binds 127.0.0.1."""

from __future__ import annotations

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

from tfservingcache_tpu_torch.config import config_from_dict
from tfservingcache_tpu_torch.runtime.fake import FakeRuntime
from tfservingcache_tpu_torch.server import CacheNode
from tfservingcache_tpu_torch.utils.metrics import Metrics

TIMEOUT = 60.0  # every HTTP / gRPC call's deadline (s)


class LoopThread:
    """An asyncio loop on a daemon thread; ``run`` a coroutine on it and
    wait for its result (within ``timeout``)."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = TIMEOUT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        async def cancel_rest():
            tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            self.run(cancel_rest())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(TIMEOUT)
            self.loop.close()


def make_store(root, models, nbytes: int = 64):
    """Stub artifacts ``<root>/<name>/<version>/params.bin`` (the fake
    runtime loads anything)."""
    for name, version in models:
        d = root / name / str(version)
        d.mkdir(parents=True)
        (d / "params.bin").write_bytes(b"x" * nbytes)
    return root


def node_config(tmp_path, name, store, **sections) -> dict:
    cfg = {
        "cache": {"base_dir": str(tmp_path / f"cache_{name}"), "disk_capacity_bytes": 1 << 20},
        "model_provider": {"base_dir": str(store)},
        "cache_node": {"rest_port": 0, "grpc_port": 0},
        "proxy": {"rest_port": 0, "grpc_port": 0},
        "discovery": {"type": "static", "prefer_localhost": True},
    }
    for key, val in sections.items():
        cfg[key] = {**cfg.get(key, {}), **val}
    return cfg


def fake_node(tmp_path, name, store, **sections) -> CacheNode:
    """A started port node on the fake runtime (``predict(x) = x * version``)."""
    cfg = config_from_dict(node_config(tmp_path, name, store, **sections))
    node = CacheNode(cfg, FakeRuntime(), metrics=Metrics())
    try:
        node.start("127.0.0.1")
    except BaseException:
        node.close()
        raise
    return node


def ident_of(node) -> str:
    return f"127.0.0.1:{node.rest_port}:{node.grpc_port}"


def wait_until(pred, timeout_s: float = 10.0, what: str = "condition") -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def http(url: str, body=None, method: str | None = None, headers=None, raw: bytes | None = None):
    """-> (status, body bytes, headers)."""
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method or ("POST" if data else "GET"),
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers
