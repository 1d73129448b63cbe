"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (the same pattern as the JAX
package's ``native/`` tier). Libraries land in ``ops/_build/`` keyed by a
hash of the source, every ``csrc`` header and source it could include, and
the flags, so an edited kernel or header rebuilds and an unchanged one
loads at once. Nothing here runs at import time: the package
imports on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

KERNEL_SOURCES = ("flash_attention", "paged_attention")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


_lock = threading.RLock()  # held across a build: one nvcc per source
_loaded: dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
build_logs: dict[str, str] = {}       # guarded-by: _lock; nvcc's output per kernel


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: keyed by its source, every
    ``*.cu`` / ``*.cuh`` in ``CSRC_DIR`` (what an ``#include`` can reach),
    and ``NVCC_FLAGS``."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for path in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build(names: tuple[str, ...] = KERNEL_SOURCES) -> dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. -> {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        return _build_locked(names)


def _build_locked(names: tuple[str, ...]) -> dict[str, Path]:
    jobs = {}
    for name in names:
        if not library_path(name).exists():
            jobs[name] = _start(name)
    failures = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build((name,))[name]))
        return lib
