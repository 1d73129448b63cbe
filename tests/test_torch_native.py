"""The port's native host tier (tfservingcache_tpu_torch/native/) against
the JAX package's: the same C++ source built by the port's own loader into
its own library, loaded side by side with the reference's (each package
calls through its own RTLD_LOCAL handle).

Ring placement and LRU behaviour are held, on seeded op sequences, to the
reference's native classes and to both packages' pure-Python fallbacks;
the loader's fallback rules (``TPUSC_NO_NATIVE=1``, no compiler) and its
refusal to serve the fallback after a failed build are checked too."""

import hashlib
import os
import platform
import random
import string
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from tfservingcache_tpu import native as jnative
from tfservingcache_tpu.cache.lru import LRUCache as JLRUCache
from tfservingcache_tpu.cluster.hashring import HashRing as JHashRing
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch import native
from tfservingcache_tpu_torch.cache.lru import CapacityError, LRUCache
from tfservingcache_tpu_torch.cluster.hashring import HashRing
from tfservingcache_tpu_torch.types import ModelId

ROOT = Path(__file__).resolve().parent.parent

RINGS = {
    "port_native": native.NativeHashRing,
    "port_python": HashRing,
    "ref_native": jnative.NativeHashRing,
    "ref_python": JHashRing,
}
LRUS = {
    "port_native": native.NativeLRUCache,
    "port_python": LRUCache,
    "ref_native": jnative.NativeLRUCache,
    "ref_python": JLRUCache,
}


def test_the_port_builds_and_loads_its_own_library():
    """Here g++ exists, so the native path is active, from a library under
    the port's build directory (not the reference's ``.so``)."""
    lib = native.load()
    assert lib is not None and native.native_available()
    assert native.active_path() == "native"
    assert Path(lib._name).parent == native.BUILD_DIR
    assert Path(lib._name) == native.library_path()
    assert jnative.load() is not None and Path(jnative.load()._name) != Path(lib._name)


@pytest.mark.parametrize("seed", [0, 7])
def test_blake2b64_matches_reference_and_hashlib(seed):
    rnd = random.Random(seed)
    cases = [b"", b"a", b"x" * 127, b"x" * 128, b"x" * 129, b"y" * 4096]
    cases += ["".join(rnd.choices(string.printable, k=rnd.randint(0, 500))).encode()
              for _ in range(200)]
    for data in cases:
        want = int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")
        assert native.blake2b64(data) == jnative.blake2b64(data) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_placement_matches_the_reference(seed):
    """A seeded fuzz of member sets (empty, one member, long names) and keys:
    every (members, key, n) maps to the same owners in the port's native
    and Python rings and the reference's two rings."""
    rnd = random.Random(seed)
    rings = {name: cls(vnodes=40) for name, cls in RINGS.items()}
    pool = [f"10.{i}.{j}.{k}:8094:8095" for i in range(2) for j in range(4) for k in range(4)]
    pool += [f"{'h' * rnd.randint(200, 700)}{i}:8094:8095" for i in range(3)]
    pool += ["solo:1:2", "ünïcode-host:8094:8095"]
    for trial in range(8):
        if trial == 0:
            members = []
        elif trial == 1:
            members = [rnd.choice(pool)]
        else:
            members = rnd.sample(pool, rnd.randint(2, len(pool)))
        for ring in rings.values():
            ring.set_members(members)
        want = rings["ref_python"]
        for ring in rings.values():
            assert ring.members == want.members and len(ring) == len(want)
        for _ in range(60):
            key = f"tenant{rnd.randint(0, 9999)}##{rnd.randint(1, 4)}"
            n = rnd.randint(0, 6)
            owners = want.get_n(key, n)
            assert len(owners) == min(max(n, 1), len(members))
            for name, ring in rings.items():
                assert ring.get_n(key, n) == owners, (name, key, n)
                assert ring.get(key) == (owners[0] if owners else None), name


@pytest.mark.parametrize("ring_name", ["port_native", "port_python"])
def test_ring_empty_degenerate_and_long_names(ring_name):
    ring = RINGS[ring_name](vnodes=16)
    assert ring.get_n("k", 3) == [] and ring.get("k") is None
    ring.set_members(["solo:1:2"])
    assert ring.get_n("k", 5) == ["solo:1:2"]  # n clamped to the member count
    members = [f"{'h' * 500}{i}:8094:8095" for i in range(20)]
    ring.set_members(members)  # the native result outgrows its first buffer
    assert sorted(ring.get_n("key", 20)) == sorted(members)


def _lru_ops(seed: int, steps: int = 600):
    rnd = random.Random(seed)
    keys = [f"m{i}" for i in range(24)]
    for step in range(steps):
        op = rnd.random()
        key = rnd.choice(keys)
        if op < 0.45:
            yield step, "put", key, rnd.randint(1, 60)
        elif op < 0.65:
            yield step, "get", key, rnd.random() < 0.8  # touch or peek
        elif op < 0.8:
            yield step, "remove", key, rnd.random() < 0.5  # run the callback
        elif op < 0.97:
            yield step, "ensure_free", key, rnd.randint(0, 150)
        else:
            yield step, "clear", key, None


@pytest.mark.parametrize("max_items", [None, 9])
@pytest.mark.parametrize("seed", [3, 4])
def test_lru_evicts_like_the_reference(seed, max_items):
    """One seeded sequence of put / get (touch or peek) / remove /
    ensure_free / clear on the port's native and Python LRUs and the
    reference's two: identical returns, evicted keys, totals, lengths and
    MRU and LRU orders after every step. The one difference is the
    reference's own: ``clear()`` runs its callbacks in LRU order in the
    Python class and in insertion order in the native one, so a clear's
    callbacks match the same package's counterpart in order and the other
    class as a set."""
    names = ("port_native", "port_python", "ref_native", "ref_python")
    step_evicted = {name: [] for name in names}
    caches = {
        name: LRUS[name](200, on_evict=lambda k, e, log=step_evicted[name]:
                         log.append((k, e.size_bytes, e.payload)), max_items=max_items)
        for name in names
    }
    total_evicted = 0
    for step, op, key, arg in _lru_ops(seed):
        got = {}
        for name, c in caches.items():
            step_evicted[name].clear()
            if op == "put":
                got[name] = c.put(key, arg, (key, step))
            elif op == "get":
                got[name] = c.get(key, touch=arg)
            elif op == "remove":
                got[name] = c.remove(key, run_callback=arg)
            elif op == "ensure_free":
                got[name] = c.ensure_free_bytes(arg)
            else:
                got[name] = c.clear()
        want = caches["ref_native"]
        for name, c in caches.items():
            assert got[name] == got["ref_native"], (step, op, name)
            assert c.total_bytes == want.total_bytes, (step, name)
            assert len(c) == len(want), (step, name)
            assert (key in c) == (key in want), (step, name)
            assert c.keys_mru_first() == want.keys_mru_first(), (step, name)
            assert [(k, e.size_bytes) for k, e in c.items_lru_first()] == \
                [(k, e.size_bytes) for k, e in want.items_lru_first()], (step, name)
            if op == "clear":
                assert sorted(step_evicted[name]) == sorted(step_evicted["ref_native"]), step
            else:
                assert step_evicted[name] == step_evicted["ref_native"], (step, op, name)
        for port, ref in (("port_native", "ref_native"), ("port_python", "ref_python")):
            assert step_evicted[port] == step_evicted[ref], (step, op, port)
        total_evicted += len(step_evicted["ref_native"])
    assert total_evicted  # the sequence did evict


@pytest.mark.parametrize("lru_name", ["port_native", "port_python"])
def test_lru_reference_scenarios(lru_name):
    """The reference's LRU scenarios (tests/test_native.py): sequential
    eviction order, touch, replace re-accounting, max_items, oversize."""
    cls = LRUS[lru_name]
    evicted = []
    c = cls(30, on_evict=lambda k, e: evicted.append(k))
    for i in range(3):
        c.put(f"m{i}", 10, i)
    c.get("m0")  # touch: m1 is now the coldest
    assert c.put("m3", 10, 3) == ["m1"] and evicted == ["m1"]
    # replace: the old entry's callback runs, and the new size evicts m2
    assert c.put("m0", 15, "big") == ["m2"]
    assert evicted == ["m1", "m0", "m2"] and c.total_bytes == 25 and c.get("m0") == "big"
    with pytest.raises(CapacityError):
        c.put("huge", 31, None)
    with pytest.raises(CapacityError):
        c.ensure_free_bytes(31)
    capped = cls(1000, max_items=2)
    capped.put("a", 1, 1)
    capped.put("b", 1, 2)
    assert capped.put("c", 1, 3) == ["a"] and capped.keys_mru_first() == ["c", "b"]


def test_model_and_conversation_keys_cross_the_abi_as_the_reference_does():
    """A ModelId crosses as its routing key and a (model, conversation)
    tuple as its str(): the same strings as the reference's ``_key_str``,
    and the original keys come back out."""
    pairs = [(ModelId("lm", 3), JModelId("lm", 3)),
             (("lm@1", "conv#r0"), ("lm@1", "conv#r0")),
             (("lm@1", "a\nb"), ("lm@1", "a\nb"))]  # repr escapes the newline
    for port_key, ref_key in pairs:
        assert native._key_str(port_key) == jnative._key_str(ref_key)
    c = native.NativeLRUCache(100)
    for port_key, _ in pairs:
        c.put(port_key, 1, port_key)
        assert c.get(port_key) == port_key
    assert c.keys_mru_first() == [k for k, _ in reversed(pairs)]


@pytest.mark.parametrize("bad", ["a\nb", "", "nul\x00key"])
def test_unrepresentable_keys_raise_value_error(bad):
    c = native.NativeLRUCache(100)
    for call in (lambda: c.put(bad, 1, None), lambda: c.get(bad), lambda: bad in c,
                 lambda: c.remove(bad)):
        with pytest.raises(ValueError):
            call()
    ring = native.NativeHashRing()
    with pytest.raises(ValueError):
        ring.set_members(["ok:1:2", bad])
    # the reference refuses the same keys
    with pytest.raises(ValueError):
        jnative.NativeLRUCache(100).put(bad, 1, None)


def test_factories_pick_the_native_classes_here():
    assert isinstance(native.make_ring(), native.NativeHashRing)
    assert isinstance(native.make_lru_cache(100), native.NativeLRUCache)


def test_factories_pick_the_python_classes_under_tpusc_no_native(tmp_path):
    """``TPUSC_NO_NATIVE=1`` selects the fallbacks (a fresh interpreter:
    ``load()`` caches its answer)."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from tfservingcache_tpu_torch import native
        from tfservingcache_tpu_torch.cache.lru import LRUCache
        from tfservingcache_tpu_torch.cluster.hashring import HashRing
        from tfservingcache_tpu_torch.protocol import codec
        import numpy as np
        assert native.load() is None and native.active_path() == "python"
        assert type(native.make_ring()) is HashRing
        assert type(native.make_lru_cache(100)) is LRUCache
        assert native.json_encode_array(np.ones(3, np.float32)) is None
        assert native.json_parse_request(b"[1]") is None
        assert codec.loads_request(b'{{"a": [1, 2]}}') == {{"a": [1, 2]}}
        body = codec.encode_predict_json_bytes({{"y": np.float32([0.5, 2])}}, False)
        assert body == b'{{"outputs": [0.5, 2.0]}}', body
        print("PYTHON PATH OK")
    """)
    env = dict(os.environ, TPUSC_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "PYTHON PATH OK" in r.stdout, r.stdout + r.stderr


@pytest.fixture()
def fresh_loader(monkeypatch):
    """``load()``'s cached state reset for one test (restored after)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_attempted", False)
    monkeypatch.delenv("TPUSC_NO_NATIVE", raising=False)
    return monkeypatch


def test_no_compiler_and_no_library_selects_the_python_path(fresh_loader, tmp_path):
    fresh_loader.setattr(native, "BUILD_DIR", tmp_path / "build")
    fresh_loader.setattr(native.shutil, "which", lambda _name: None)
    assert native.load() is None and native.active_path() == "python"
    assert type(native.make_lru_cache(10)) is LRUCache


def test_a_failed_build_raises_with_the_compilers_output(fresh_loader, tmp_path):
    """With g++ present, a source it refuses raises NativeBuildError (its
    diagnostics in the message) from ``build()``, from ``load()`` on every
    call, and from the factories: the fallback is never served instead."""
    broken = tmp_path / "tpusc_native.cc"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    with pytest.raises(native.NativeBuildError, match="this is not C"):
        native.build(broken, tmp_path / "direct")
    assert not list((tmp_path / "direct").glob("*"))  # no half-written library
    fresh_loader.setattr(native, "SOURCE", broken)
    fresh_loader.setattr(native, "BUILD_DIR", tmp_path / "build")
    for _ in range(2):
        with pytest.raises(native.NativeBuildError, match="g\\+\\+ exit"):
            native.load()
    with pytest.raises(native.NativeBuildError):
        native.make_lru_cache(10)
    with pytest.raises(native.NativeBuildError):
        native.make_ring()


def test_the_library_is_keyed_by_source_and_flags(fresh_loader, tmp_path):
    src = tmp_path / "tpusc_native.cc"
    src.write_text(native.SOURCE.read_text())
    first = native.library_path(src, tmp_path)
    assert first == native.library_path(src, tmp_path) and first.parent == tmp_path
    src.write_text(native.SOURCE.read_text() + "\n// an edit\n")
    assert native.library_path(src, tmp_path) != first
    src.write_text(native.SOURCE.read_text())
    fresh_loader.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-g"))
    assert native.library_path(src, tmp_path) != first


@pytest.mark.parametrize("other", ["g++ (GCC) 99.0.0\nx86_64", "\naarch64"])
def test_the_library_is_keyed_by_compiler_and_machine(fresh_loader, tmp_path, other):
    """A ``_build/`` carried to a host with another g++ or another machine
    type names another library there, so it is built anew, never loaded."""
    here = native.library_path(native.SOURCE, tmp_path)
    assert native.toolchain().endswith("\n" + platform.machine())
    fresh_loader.setattr(native, "toolchain", lambda: other)
    assert native.library_path(native.SOURCE, tmp_path) != here


def test_concurrent_builds_of_one_library_all_load(tmp_path):
    """Three processes build the same source into one empty directory at
    once (as xdist workers do): each renames its own temporary file into
    place, and every process loads a whole library."""
    script = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {str(ROOT)!r})
        from tfservingcache_tpu_torch import native
        path = native.build(native.SOURCE, {str(tmp_path / "build")!r})
        lib = native._bind(ctypes.CDLL(str(path)))
        assert lib.tpusc_blake2b64(b"a", 1) == native.blake2b64(b"a")
        print("LOADED", path)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(3)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 and "LOADED" in out for p, out in zip(procs, outs)), outs
    built = list((tmp_path / "build").iterdir())
    assert [b.suffix for b in built] == [".so"]  # no temporary file left behind
