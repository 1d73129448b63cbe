"""Disk model provider (counterpart of
``tfservingcache_tpu/cache/providers/disk.py``). Version directories match by
numeric value, so ``000000042`` serves version 42; ``model_size`` is the
recursive tree size."""

from __future__ import annotations

import os
import shutil

from tfservingcache_tpu_torch.cache.disk_cache import dir_size_bytes
from tfservingcache_tpu_torch.cache.providers.base import (
    ModelNotFoundError,
    ModelProvider,
    ProviderError,
    atomic_dest,
)
from tfservingcache_tpu_torch.types import Model, ModelId


class DiskModelProvider(ModelProvider):
    def __init__(self, base_dir: str) -> None:
        self.base_dir = os.path.abspath(base_dir)

    def _find_src_path(self, name: str, version: int) -> str:
        model_dir = os.path.join(self.base_dir, name)
        if not os.path.isdir(model_dir):
            raise ModelNotFoundError(f"model dir not found: {model_dir}")
        for entry in sorted(os.listdir(model_dir)):
            full = os.path.join(model_dir, entry)
            if not os.path.isdir(full):
                continue
            try:
                if int(entry) == version:
                    return full
            except ValueError:
                continue
        raise ModelNotFoundError(f"version {version} of model {name!r} not found in {model_dir}")

    def load_model(self, name: str, version: int, dest_dir: str) -> Model:
        src = self._find_src_path(name, version)
        with atomic_dest(dest_dir) as tmp:
            shutil.copytree(src, tmp)
        return Model(
            identifier=ModelId(name, version),
            path=dest_dir,
            size_on_disk=dir_size_bytes(dest_dir),
        )

    def list_versions(self, name: str) -> list[int]:
        model_dir = os.path.join(self.base_dir, name)
        if not os.path.isdir(model_dir):
            raise ModelNotFoundError(f"model dir not found: {model_dir}")
        versions = set()
        for entry in os.listdir(model_dir):
            try:
                if os.path.isdir(os.path.join(model_dir, entry)):
                    versions.add(int(entry))
            except ValueError:
                continue
        if not versions:
            raise ModelNotFoundError(f"no versions of model {name!r} in {model_dir}")
        return sorted(versions)

    def model_size(self, name: str, version: int) -> int:
        return dir_size_bytes(self._find_src_path(name, version))

    def check(self) -> None:
        if not os.path.isdir(self.base_dir):
            raise ProviderError(f"provider base dir missing: {self.base_dir}")
