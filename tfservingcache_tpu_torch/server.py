"""Process wiring: build and run a cache node (counterpart of
``tfservingcache_tpu/server.py`` for one group: one device, or with
``mesh.chips_per_group`` > 1 one device group driven by this process).

provider -> disk cache -> runtime -> cache manager -> backend -> REST server,
plus the continuous generate engine when ``serving.generate_engine`` is
``"continuous"``.
"""

from __future__ import annotations

import logging

import torch

from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
from tfservingcache_tpu_torch.cache.manager import CacheManager
from tfservingcache_tpu_torch.cache.providers import create_provider
from tfservingcache_tpu_torch.config import Config
from tfservingcache_tpu_torch.parallel.mesh import chip_groups
from tfservingcache_tpu_torch.protocol.local_backend import LocalServingBackend
from tfservingcache_tpu_torch.protocol.rest import RestServingServer
from tfservingcache_tpu_torch.runtime.base import RuntimeError_
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime

log = logging.getLogger("tpusc_torch.server")


class CacheNode:
    """One serving host with one device or one device group: provider +
    disk cache + runtime behind a REST server."""

    def __init__(self, cfg: Config, runtime: TorchModelRuntime,
                 engine: ContinuousGenerateEngine | None = None) -> None:
        self.cfg = cfg
        self.provider = create_provider(cfg.model_provider)
        self.disk_cache = ModelDiskCache(cfg.cache.base_dir, cfg.cache.disk_capacity_bytes)
        self.runtime = runtime
        self.manager = CacheManager(
            self.provider, self.disk_cache, runtime,
            load_timeout_s=cfg.serving.load_timeout_s,
        )
        self.engine = engine
        self.backend = LocalServingBackend(
            self.manager, generator=engine, spec_draft_model=cfg.serving.spec_draft_model,
        )
        self.rest = RestServingServer(self.backend)
        self.rest_port = 0

    def start(self, host: str = "0.0.0.0") -> int:
        """Bind the REST server (``cache_node.rest_port``, 0 = ephemeral);
        returns the bound port."""
        self.rest_port = self.rest.start(self.cfg.cache_node.rest_port, host)
        return self.rest_port

    def is_healthy(self) -> bool:
        return self.manager.is_healthy()

    def close(self) -> None:
        self.rest.close()
        if self.engine is not None:  # the engine's threads use the runtime
            self.engine.close()
        self.manager.close()


def node_group(device: str | torch.device, chips_per_group: int) -> list[torch.device]:
    """The device group of a node with ``mesh.chips_per_group`` > 1 (the
    reference's ``chip_groups`` over the host's devices, server.py:113-150,
    cut to one group): on ``cuda`` the first ``chips_per_group`` CUDA
    devices; on ``cpu`` that many copies of the CPU device (the tests'
    virtual group). Raises when the host has fewer CUDA devices, or so many
    that it would form more than one group."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * chips_per_group
    if dev.type != "cuda":
        raise RuntimeError_(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError_(f"device {device!r} requested but CUDA is not available")
    n = torch.cuda.device_count()
    if n < chips_per_group:
        raise RuntimeError_(
            f"mesh.chips_per_group={chips_per_group} needs {chips_per_group} CUDA devices, "
            f"this host has {n}"
        )
    groups = chip_groups([torch.device("cuda", i) for i in range(n)], chips_per_group)
    if len(groups) > 1:
        raise RuntimeError_(
            f"multi-group nodes: later slice (router): {n} CUDA devices form {len(groups)} "
            f"groups of {chips_per_group}"
        )
    return list(groups[0])


def build_node(cfg: Config, device: str | torch.device | None = None) -> CacheNode:
    """A ``CacheNode`` on ``device`` (default: ``cfg.serving.device``, which
    defaults to ``cuda``; a missing card raises rather than falling back).
    With ``mesh.chips_per_group`` > 1 its runtime is bound to one device
    group (``node_group``)."""
    device = device or cfg.serving.device
    if cfg.mesh.chips_per_group > 1:
        runtime = TorchModelRuntime(
            cfg.serving, devices=node_group(device, cfg.mesh.chips_per_group))
    else:
        runtime = TorchModelRuntime(cfg.serving, device=device)
    engine = None
    if cfg.serving.generate_engine == "continuous":
        engine = ContinuousGenerateEngine(
            runtime, slots=cfg.serving.generate_slots,
            chunk_tokens=cfg.serving.generate_chunk_tokens,
            spec_draft_model=cfg.serving.spec_draft_model,
            spec_tokens=cfg.serving.spec_tokens,
        )
    return CacheNode(cfg, runtime, engine)
