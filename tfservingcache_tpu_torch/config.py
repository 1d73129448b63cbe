"""Config for the port's serving path (a subset of
``tfservingcache_tpu/config.py``, same section and field names).

Loaded from a JSON file or a dict; a ``.yaml``/``.yml`` path imports
``yaml`` lazily, so the package needs no YAML library otherwise. Unknown
keys are logged and ignored, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Mapping

log = logging.getLogger("tpusc_torch.config")


@dataclass
class ServingConfig:
    """The in-process PyTorch runtime."""

    max_concurrent_models: int = 16        # models resident on the GPU at once
    # byte budget for resident params (an H100 holds 80 GB; the rest is
    # left for activations and the allocator's cache)
    hbm_capacity_bytes: int = 64 << 30
    # cold-load (fetch + load) deadline; 0 disables
    load_timeout_s: float = 30.0
    # "cuda" (the default) or "cpu"; a missing card with "cuda" raises
    device: str = "cuda"


@dataclass
class CacheConfig:
    """Disk artifact cache."""

    base_dir: str = "/tmp/tpusc_models"
    disk_capacity_bytes: int = 10 << 30


@dataclass
class ModelProviderConfig:
    """Where artifacts are fetched from (the port has the disk provider)."""

    type: str = "disk"
    base_dir: str = "./models"


@dataclass
class CacheNodePorts:
    """The cache node's REST port (0 binds an ephemeral port)."""

    rest_port: int = 8094


@dataclass
class Config:
    serving: ServingConfig = field(default_factory=ServingConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    model_provider: ModelProviderConfig = field(default_factory=ModelProviderConfig)
    cache_node: CacheNodePorts = field(default_factory=CacheNodePorts)


def _apply_mapping(cfg: Any, data: Mapping[str, Any], path: str = "") -> None:
    known = {f.name for f in dataclasses.fields(cfg)}
    unknown = set(data) - known
    if unknown:
        log.warning(
            "ignoring unknown config key(s) %s under %r (known: %s)",
            sorted(unknown), path or ".", sorted(known),
        )
    for f in dataclasses.fields(cfg):
        if f.name not in data:
            continue
        val = data[f.name]
        cur = getattr(cfg, f.name)
        if dataclasses.is_dataclass(cur):
            if val is None:
                continue
            if not isinstance(val, Mapping):
                raise ValueError(
                    f"config section {path}{f.name} must be a mapping, got {type(val).__name__}"
                )
            _apply_mapping(cur, val, f"{path}{f.name}.")
        else:
            setattr(cfg, f.name, type(cur)(val))


def config_from_dict(data: Mapping[str, Any] | None) -> Config:
    cfg = Config()
    _apply_mapping(cfg, data or {})
    return cfg


def load_config(path: str | None = None) -> Config:
    """A ``Config`` from a JSON (or YAML) file; defaults without a path."""
    if not path:
        return Config()
    with open(path) as fh:
        if path.endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(fh) or {}
        else:
            data = json.load(fh)
    return config_from_dict(data)
