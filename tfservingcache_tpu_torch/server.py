"""Process wiring: build and run a single-GPU cache node (counterpart of
``tfservingcache_tpu/server.py`` for one group on one device).

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
from tfservingcache_tpu_torch.protocol.local_backend import LocalServingBackend
from tfservingcache_tpu_torch.protocol.rest import RestServingServer
from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime

log = logging.getLogger("tpusc_torch.server")


class CacheNode:
    """One serving host with one device: provider + disk cache + runtime
    behind a REST server."""

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


def build_node(cfg: Config, device: str | torch.device | None = None) -> CacheNode:
    """A ``CacheNode`` on ``device`` (default: ``cfg.serving.device``, which
    defaults to ``cuda``; a missing card raises rather than falling back)."""
    runtime = TorchModelRuntime(cfg.serving, device=device or cfg.serving.device)
    engine = None
    if cfg.serving.generate_engine == "continuous":
        engine = ContinuousGenerateEngine(
            runtime, slots=cfg.serving.generate_slots,
            chunk_tokens=cfg.serving.generate_chunk_tokens,
            spec_draft_model=cfg.serving.spec_draft_model,
            spec_tokens=cfg.serving.spec_tokens,
        )
    return CacheNode(cfg, runtime, engine)
