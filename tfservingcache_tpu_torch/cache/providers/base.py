"""Storage abstraction (counterpart of
``tfservingcache_tpu/cache/providers/base.py``): the narrow ``ModelProvider``
interface plus atomic staging of fetched artifacts."""

from __future__ import annotations

import abc
import os
import shutil
import uuid
from contextlib import contextmanager
from typing import Iterator

from tfservingcache_tpu_torch.types import Model


@contextmanager
def atomic_dest(dest_dir: str) -> Iterator[str]:
    """Stage writes in a unique ``<dest>.tmp-<pid>-<rand>`` dir and rename
    it onto ``dest_dir`` on success, so a crash mid-fetch never leaves a
    half-written artifact at the final path. Concurrent fetches of one
    artifact stay independent; the later rename wins with a complete tree."""
    tmp = f"{dest_dir}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(os.path.dirname(tmp) or ".", exist_ok=True)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(dest_dir):
        shutil.rmtree(dest_dir, ignore_errors=True)
    try:
        os.replace(tmp, dest_dir)
    except OSError:
        if os.path.isdir(dest_dir):
            # a concurrent fetch won the rename; its tree is complete
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            raise


class ProviderError(Exception):
    pass


class ModelNotFoundError(ProviderError):
    pass


class ModelProvider(abc.ABC):
    @abc.abstractmethod
    def load_model(self, name: str, version: int, dest_dir: str) -> Model:
        """Fetch ``<name>/<version>`` into ``dest_dir`` and return the Model."""

    @abc.abstractmethod
    def model_size(self, name: str, version: int) -> int:
        """Size in bytes of the stored artifact (used for pre-eviction)."""

    @abc.abstractmethod
    def check(self) -> None:
        """Health probe; raise ProviderError when the backing store is down."""

    def list_versions(self, name: str) -> list[int]:
        """All stored versions of ``name``, ascending."""
        raise ModelNotFoundError(
            f"provider {type(self).__name__} cannot list versions for {name!r}"
        )

    def latest_version(self, name: str) -> int:
        versions = self.list_versions(name)
        if not versions:
            raise ModelNotFoundError(f"no versions of model {name!r}")
        return max(versions)
