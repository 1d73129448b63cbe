"""Storage abstraction (counterpart of
``tfservingcache_tpu/cache/providers/base.py``): the narrow ``ModelProvider``
interface, its streaming variant and atomic staging of fetched artifacts."""

from __future__ import annotations

import abc
import logging
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


# files a streaming fetch lands (and announces) first
STREAM_META_FILES = ("model.json",)


def _notify_file(on_file, rel: str, local_path: str) -> None:
    """Call a streaming callback; it is advisory and never breaks the fetch
    it rides on."""
    if on_file is None:
        return
    try:
        on_file(rel, local_path)
    except Exception:  # noqa: BLE001 - advisory hook
        logging.getLogger("tpusc_torch.providers").debug(
            "streaming on_file callback failed for %s", rel, exc_info=True)


class ModelProvider(abc.ABC):
    @abc.abstractmethod
    def load_model(self, name: str, version: int, dest_dir: str) -> Model:
        """Fetch ``<name>/<version>`` into ``dest_dir`` and return the Model."""

    def load_model_streaming(self, name: str, version: int, dest_dir: str,
                             on_file=None) -> Model:
        """``load_model`` that calls ``on_file(rel_path, local_path)`` as each
        artifact file lands (metadata first where the backend allows). This
        default fetches fully, then announces every file; the object-store
        and peer providers override it."""
        model = self.load_model(name, version, dest_dir)
        if on_file is not None:
            for root, _dirs, files in os.walk(model.path):
                for fn in sorted(files, key=lambda f: f not in STREAM_META_FILES):
                    full = os.path.join(root, fn)
                    _notify_file(on_file, os.path.relpath(full, model.path), full)
        return model

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
