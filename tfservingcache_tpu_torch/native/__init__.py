"""The native (C++) host tier, loaded with ctypes (the port's copy of
``tfservingcache_tpu/native/__init__.py``; the source, ``src/tpusc_native.cc``,
is the reference's own):

  - BLAKE2b-64 hashing (the ring's placement hash, RFC 7693);
  - a consistent-hash ring (``NativeHashRing``: the same placement as the
    Python ``cluster.hashring.HashRing``);
  - a byte-budgeted LRU index (``NativeLRUCache``: the same semantics as
    ``cache.lru.LRUCache``);
  - the REST JSON tensor encoder (``json_encode_array``) and request parser
    (``json_parse_request``).

``load()`` builds the library at first use with ``g++`` (``CXX_FLAGS``, the
reference Makefile's) into ``_build/``, under a name keyed by a hash of the
source, the flags, the compiler's version and the machine, so an edited
source, or a ``_build/`` copied to another host, rebuilds and an unchanged
one loads at once. Each build writes a per-process temporary file and renames it
into place, so concurrent processes never load a half-written library. The
pure-Python fallbacks run in two cases only: ``TPUSC_NO_NATIVE=1``, or no
``g++`` on the ``PATH`` (and no library built yet). A compiler that refuses
the source, or a library that does not load, raises ``NativeBuildError``
with the compiler's output: a broken build is never served by the fallback.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import secrets
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable, Generic, Hashable, TypeVar

from tfservingcache_tpu_torch.cache.lru import CapacityError, LRUEntry
from tfservingcache_tpu_torch.utils.lockcheck import lockchecked

SOURCE = Path(__file__).resolve().parent / "src" / "tpusc_native.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


class NativeBuildError(RuntimeError):
    """The compiler refused the native source, or its library did not load."""


_load_lock = threading.Lock()
_lib: ctypes.CDLL | None = None        # guarded-by: _load_lock (written once)
_error: NativeBuildError | None = None  # guarded-by: _load_lock
_attempted = False                      # guarded-by: _load_lock


@functools.cache
def toolchain() -> str:
    """The first line of ``g++ --version`` ("" without g++) and the machine:
    what, beside the source and the flags, decides whether a built library
    loads here."""
    cxx = shutil.which("g++")
    version = ""
    if cxx is not None:
        try:
            out = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout
            version = out.splitlines()[0] if out else ""
        except (OSError, subprocess.SubprocessError):
            pass
    return f"{version}\n{platform.machine()}"


def library_path(source: Path | None = None, build_dir: Path | None = None) -> Path:
    """Where the library built from ``source`` (default ``SOURCE``) lives in
    ``build_dir`` (default ``BUILD_DIR``): keyed by the source's bytes,
    ``CXX_FLAGS`` and ``toolchain()``."""
    source = SOURCE if source is None else Path(source)
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(toolchain().encode())
    return build_dir / f"libtpusc_native-{h.hexdigest()[:16]}.so"


def build(source: Path | None = None, build_dir: Path | None = None) -> Path:
    """Compile ``source`` (default ``SOURCE``) with ``g++`` unless its
    library exists. -> the library's path. Raises ``NativeBuildError`` when
    g++ is missing or refuses the source (its output in the message)."""
    source = SOURCE if source is None else Path(source)
    out = library_path(source, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found on PATH")
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed to run on {source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ exit {proc.returncode} building {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tpusc_blake2b64.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.tpusc_blake2b64.restype = ctypes.c_ulonglong
    lib.tpusc_ring_new.argtypes = [ctypes.c_int]
    lib.tpusc_ring_new.restype = ctypes.c_void_p
    lib.tpusc_ring_free.argtypes = [ctypes.c_void_p]
    lib.tpusc_ring_free.restype = None
    lib.tpusc_ring_set_members.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
    ]
    lib.tpusc_ring_set_members.restype = None
    lib.tpusc_ring_len.argtypes = [ctypes.c_void_p]
    lib.tpusc_ring_len.restype = ctypes.c_int
    lib.tpusc_ring_members.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.tpusc_ring_members.restype = ctypes.c_int
    lib.tpusc_ring_get_n.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.tpusc_ring_get_n.restype = ctypes.c_int
    lib.tpusc_lru_new.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.tpusc_lru_new.restype = ctypes.c_void_p
    lib.tpusc_lru_free.argtypes = [ctypes.c_void_p]
    lib.tpusc_lru_free.restype = None
    lib.tpusc_lru_total.argtypes = [ctypes.c_void_p]
    lib.tpusc_lru_total.restype = ctypes.c_longlong
    lib.tpusc_lru_len.argtypes = [ctypes.c_void_p]
    lib.tpusc_lru_len.restype = ctypes.c_int
    lib.tpusc_lru_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tpusc_lru_contains.restype = ctypes.c_int
    lib.tpusc_lru_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.tpusc_lru_get.restype = ctypes.c_longlong
    lib.tpusc_lru_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.tpusc_lru_put.restype = ctypes.c_int
    lib.tpusc_lru_remove.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tpusc_lru_remove.restype = ctypes.c_longlong
    lib.tpusc_lru_ensure_free.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.tpusc_lru_ensure_free.restype = ctypes.c_int
    lib.tpusc_lru_keys.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.tpusc_lru_keys.restype = ctypes.c_int
    lib.tpusc_lru_clear.argtypes = [ctypes.c_void_p]
    lib.tpusc_lru_clear.restype = None
    lib.tpusc_json_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong,
    ]
    lib.tpusc_json_encode.restype = ctypes.c_longlong
    lib.tpusc_json_parse.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p]
    lib.tpusc_json_parse.restype = ctypes.c_void_p
    lib.tpusc_jp_ok.argtypes = [ctypes.c_void_p]
    lib.tpusc_jp_ok.restype = ctypes.c_int
    lib.tpusc_jp_declined.argtypes = [ctypes.c_void_p]
    lib.tpusc_jp_declined.restype = ctypes.c_int
    lib.tpusc_jp_error.argtypes = [ctypes.c_void_p]
    lib.tpusc_jp_error.restype = ctypes.c_char_p
    lib.tpusc_jp_skeleton.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    lib.tpusc_jp_skeleton.restype = ctypes.c_void_p
    lib.tpusc_jp_ntensors.argtypes = [ctypes.c_void_p]
    lib.tpusc_jp_ntensors.restype = ctypes.c_int
    lib.tpusc_jp_tensor_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.tpusc_jp_tensor_info.restype = ctypes.c_int
    lib.tpusc_jp_tensor_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpusc_jp_tensor_data.restype = ctypes.c_void_p
    lib.tpusc_jp_free.argtypes = [ctypes.c_void_p]
    lib.tpusc_jp_free.restype = None
    return lib


def load() -> ctypes.CDLL | None:
    """The native library, built on first use; None under
    ``TPUSC_NO_NATIVE=1`` or when there is no ``g++`` and no built library.
    A failed build or load raises ``NativeBuildError``, on this call and
    every later one. The library is opened ``RTLD_LOCAL`` (ctypes' default):
    the JAX package's library exports the same symbols, and each package
    calls through its own handle."""
    global _lib, _error, _attempted
    if _lib is not None:
        return _lib
    with _load_lock:
        if _error is not None:
            raise _error
        if _attempted:
            return _lib
        _attempted = True
        if os.environ.get("TPUSC_NO_NATIVE"):
            return None
        if shutil.which("g++") is None and not library_path().exists():
            return None
        try:
            path = build()
        except NativeBuildError as e:
            _error = e
            raise
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError) as e:
            _error = NativeBuildError(f"native library {path} did not load: {e}")
            raise _error from e
        return _lib


def native_available() -> bool:
    return load() is not None


def active_path() -> str:
    """``"native"`` when the C++ tier serves the ring, LRU and JSON codec,
    ``"python"`` when the fallbacks do."""
    return "native" if native_available() else "python"


def blake2b64(data: bytes) -> int:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return int(lib.tpusc_blake2b64(data, len(data)))


def _call_buffered(fn: Callable[[ctypes.Array, int], int], initial: int = 4096) -> list[str]:
    """Run a needed-size-returning C call, growing the buffer on demand;
    decode the '\\n'-joined result."""
    cap = initial
    while True:
        buf = ctypes.create_string_buffer(cap)
        needed = fn(buf, cap)
        if needed < 0:
            raise CapacityError("native tier reported a capacity violation")
        if needed <= cap:
            raw = buf.value.decode()
            return raw.split("\n") if raw else []
        cap = needed


class NativeHashRing:
    """Drop-in for ``cluster.hashring.HashRing`` backed by the C++ ring:
    the same BLAKE2b-64 points, vnode naming ``member#i`` and tie-break, so
    native and fallback nodes agree on every key's owners."""

    def __init__(self, vnodes: int = 160) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.vnodes = vnodes
        self._ptr = lib.tpusc_ring_new(vnodes)

    def __del__(self) -> None:
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr and getattr(self, "_lib", None) is not None:
            self._lib.tpusc_ring_free(ptr)

    def set_members(self, members: list[str]) -> None:
        for m in members:
            if not m or "\n" in m or "\x00" in m:
                raise ValueError(f"member {m!r} not representable in the native ring")
        arr = (ctypes.c_char_p * len(members))(*[m.encode() for m in members])
        self._lib.tpusc_ring_set_members(self._ptr, arr, len(members))

    @property
    def members(self) -> set[str]:
        return set(_call_buffered(lambda b, c: self._lib.tpusc_ring_members(self._ptr, b, c)))

    def __len__(self) -> int:
        return int(self._lib.tpusc_ring_len(self._ptr))

    def get_n(self, key: str, n: int) -> list[str]:
        kb = key.encode()
        return _call_buffered(lambda b, c: self._lib.tpusc_ring_get_n(self._ptr, kb, n, b, c))

    def get(self, key: str) -> str | None:
        nodes = self.get_n(key, 1)
        return nodes[0] if nodes else None


def make_ring(vnodes: int = 160):
    """The native ring when the library is available, else the Python one."""
    if native_available():
        return NativeHashRing(vnodes)
    from tfservingcache_tpu_torch.cluster.hashring import HashRing

    return HashRing(vnodes)


K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


def _key_str(key: Any) -> str:
    # a ModelId carries its routing key; any other key needs a stable,
    # unique str(). Keys cross the C ABI as NUL-terminated, '\n'-joined
    # strings, so those bytes (and the empty string) are refused
    s = key.key if hasattr(key, "key") else str(key)
    if not s or "\n" in s or "\x00" in s:
        raise ValueError(f"key {key!r} not representable in the native tier")
    return s


@lockchecked
class NativeLRUCache(Generic[K, V]):
    """Drop-in for ``cache.lru.LRUCache``: the (key, size, order, budget)
    index lives in C++, payloads and evict callbacks on the Python side.
    Thread-safe; one eviction pass per put; oversized items refused;
    callbacks run outside the lock."""

    _tpusc_guarded = {"_payloads": "_lock"}

    def __init__(
        self,
        capacity_bytes: int,
        on_evict: Callable[[K, LRUEntry[V]], None] | None = None,
        max_items: int | None = None,
    ) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.capacity_bytes = int(capacity_bytes)
        self.max_items = max_items
        self._on_evict = on_evict
        self._lock = threading.RLock()  # guards the payload map
        self._payloads: dict[str, tuple[K, LRUEntry[V]]] = {}
        self._ptr = lib.tpusc_lru_new(
            self.capacity_bytes, -1 if max_items is None else int(max_items))

    def __del__(self) -> None:
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr and getattr(self, "_lib", None) is not None:
            self._lib.tpusc_lru_free(ptr)

    # -- introspection ------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return int(self._lib.tpusc_lru_total(self._ptr))

    def __len__(self) -> int:
        return int(self._lib.tpusc_lru_len(self._ptr))

    def __contains__(self, key: K) -> bool:
        return bool(self._lib.tpusc_lru_contains(self._ptr, _key_str(key).encode()))

    def _keys(self, mru_first: bool) -> list[str]:
        return _call_buffered(
            lambda b, c: self._lib.tpusc_lru_keys(self._ptr, int(mru_first), b, c))

    def keys_mru_first(self) -> list[K]:
        with self._lock:
            return [self._payloads[s][0] for s in self._keys(True) if s in self._payloads]

    def items_lru_first(self) -> list[tuple[K, LRUEntry[V]]]:
        with self._lock:
            return [self._payloads[s] for s in self._keys(False) if s in self._payloads]

    # -- core ---------------------------------------------------------------
    def get(self, key: K, touch: bool = True) -> V | None:
        s = _key_str(key)
        # the lock spans the native call, so a concurrent put/remove of the
        # same key cannot desync the native index from the payload map
        with self._lock:
            if self._lib.tpusc_lru_get(self._ptr, s.encode(), int(touch)) < 0:
                return None
            held = self._payloads.get(s)
        return held[1].payload if held is not None else None

    def put(self, key: K, size_bytes: int, payload: V) -> list[K]:
        s = _key_str(key)
        size_bytes = int(size_bytes)
        if size_bytes > self.capacity_bytes:
            raise CapacityError(
                f"item {key!r} ({size_bytes}B) exceeds cache capacity {self.capacity_bytes}B")
        sb = s.encode()
        with self._lock:
            old = self._payloads.get(s)
            evicted_keys = _call_buffered(
                lambda b, c: self._lib.tpusc_lru_put(self._ptr, sb, size_bytes, b, c))
            evicted: list[tuple[K, LRUEntry[V]]] = []
            if old is not None:
                evicted.append(old)
            for ek in evicted_keys:
                held = self._payloads.pop(ek, None)
                if held is not None:
                    evicted.append(held)
            self._payloads[s] = (key, LRUEntry(size_bytes, payload))
        self._run_callbacks(evicted)
        return [k for k, _ in evicted if _key_str(k) != s]

    def remove(self, key: K, run_callback: bool = False) -> V | None:
        s = _key_str(key)
        with self._lock:
            if self._lib.tpusc_lru_remove(self._ptr, s.encode()) < 0:
                return None
            held = self._payloads.pop(s, None)
        if held is None:
            return None
        if run_callback and self._on_evict is not None:
            self._on_evict(held[0], held[1])
        return held[1].payload

    def ensure_free_bytes(self, n: int) -> list[K]:
        n = int(n)
        if n > self.capacity_bytes:
            raise CapacityError(
                f"requested {n}B free exceeds cache capacity {self.capacity_bytes}B")
        with self._lock:
            keys = _call_buffered(
                lambda b, c: self._lib.tpusc_lru_ensure_free(self._ptr, n, b, c))
            evicted = [self._payloads.pop(s) for s in keys if s in self._payloads]
        self._run_callbacks(evicted)
        return [k for k, _ in evicted]

    def clear(self) -> None:
        with self._lock:
            evicted = list(self._payloads.values())
            self._payloads.clear()
            self._lib.tpusc_lru_clear(self._ptr)
        self._run_callbacks(evicted)

    def _run_callbacks(self, evicted: list[tuple[K, LRUEntry[V]]]) -> None:
        if self._on_evict is None:
            return
        for key, entry in evicted:
            self._on_evict(key, entry)


def make_lru_cache(
    capacity_bytes: int,
    on_evict: Callable[[Any, LRUEntry[Any]], None] | None = None,
    max_items: int | None = None,
):
    """The native LRU when the library is available, else the Python one."""
    if native_available():
        return NativeLRUCache(capacity_bytes, on_evict, max_items)
    from tfservingcache_tpu_torch.cache.lru import LRUCache

    return LRUCache(capacity_bytes, on_evict, max_items)


# -- JSON tensor encoder ------------------------------------------------------

# numpy dtype name -> tpusc_json_encode kind (src/tpusc_native.cc)
_JSON_KINDS = {"float32": 1, "float64": 2, "int32": 3, "int64": 4, "bool": 5, "uint8": 6}


def json_encode_array(arr) -> bytes | None:
    """JSON nested-list text of a numeric ndarray, written from its buffer
    by the native encoder. None when the library is unavailable or the dtype
    or byte order is not one it takes (the caller takes the Python path).
    Float text is the shortest round-trip text for the SOURCE dtype
    (float32 0.1 is ``0.1``); non-finite values are Python json's tokens
    (NaN, Infinity, -Infinity)."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    a = np.asarray(arr)
    if not a.dtype.isnative:
        return None  # the C++ side reads host byte order
    if not a.flags["C_CONTIGUOUS"]:
        # not ascontiguousarray on every array: it turns 0-d into 1-d, which
        # would wrap a scalar response in brackets
        a = np.ascontiguousarray(a)
    kind = _JSON_KINDS.get(a.dtype.name)
    if kind is None:
        return None
    shape = (ctypes.c_int64 * max(a.ndim, 1))(*(a.shape or (0,)))
    # a first guess; the C side owns the real bound and returns -(needed)
    # when this is short
    cap = int(a.size) * 14 + 64
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        wrote = lib.tpusc_json_encode(a.ctypes.data_as(ctypes.c_void_p), kind, shape, a.ndim,
                                      buf, cap)
        if wrote >= 0:
            return buf.raw[:wrote]
        if wrote == -1:
            return None
        cap = -wrote
    return None


# -- JSON request parser ------------------------------------------------------

_PARSE_NONCE = secrets.token_hex(8)


def json_parse_request(body: bytes):
    """A JSON request body parsed, with every dense numeric array of 64 or
    more elements extracted as a numpy array (int64 when every token is
    integral, else float64). None when the library is unavailable or
    declines the body (the caller uses ``json.loads``); ``ValueError`` for a
    body the parser proves malformed (its message differs from json's).

    Extracted subtrees travel through the skeleton as placeholder strings
    under a per-process nonce, so no payload string can name another
    request's tensor."""
    import json

    import numpy as np

    lib = load()
    if lib is None:
        return None
    nonce = _PARSE_NONCE
    h = lib.tpusc_json_parse(body, len(body), nonce.encode())
    if not h:
        return None
    try:
        if not lib.tpusc_jp_ok(h):
            if lib.tpusc_jp_declined(h):
                return None  # beyond this parser (e.g. depth), not malformed
            raise ValueError((lib.tpusc_jp_error(h) or b"invalid JSON").decode())
        slen = ctypes.c_longlong()
        sptr = lib.tpusc_jp_skeleton(h, ctypes.byref(slen))
        tree = json.loads(ctypes.string_at(sptr, slen.value))
        nt = lib.tpusc_jp_ntensors(h)
        if nt == 0:
            return tree
        arrays = []
        for k in range(nt):
            is_int = ctypes.c_int()
            nelems = ctypes.c_longlong()
            shape = (ctypes.c_int64 * 32)()
            ndim = lib.tpusc_jp_tensor_info(h, k, ctypes.byref(is_int), shape, 32,
                                            ctypes.byref(nelems))
            ctype = ctypes.c_int64 if is_int.value else ctypes.c_double
            flat = np.ctypeslib.as_array(
                ctypes.cast(lib.tpusc_jp_tensor_data(h, k), ctypes.POINTER(ctype)),
                shape=(max(nelems.value, 0),),
            )
            dt = np.int64 if is_int.value else np.float64
            arrays.append(flat.astype(dt, copy=True).reshape(tuple(shape[:ndim])))
        prefix = "\x07" + nonce + ":"

        def swap(v):
            if isinstance(v, dict):
                return {k2: swap(x) for k2, x in v.items()}
            if isinstance(v, list):
                return [swap(x) for x in v]
            if isinstance(v, str) and v.startswith(prefix):
                return arrays[int(v[len(prefix):])]
            return v

        return swap(tree)
    finally:
        lib.tpusc_jp_free(h)
