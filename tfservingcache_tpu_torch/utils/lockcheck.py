"""TPUSC_LOCKCHECK=1 — runtime check of declared lock guards (a copy of
``tfservingcache_tpu/utils/lockcheck.py``; the port keeps its own).

A class carrying a ``_tpusc_guarded`` registry (``{"_field": "_lock"}``) and
the ``@lockchecked`` decorator gets every guarded-field access checked at
runtime: the declared lock must be held (``Lock.locked()`` /
``RLock._is_owned()`` / ``Condition._is_owned()``) or a violation is
recorded.  Violations are collected — not raised — so a soak run surfaces
every distinct unguarded access instead of dying on the first; tests call
``assert_clean()`` at the end.

When ``TPUSC_LOCKCHECK`` is unset the decorator is an exact no-op: classes
are returned unchanged and there is zero steady-state overhead.

Known imprecision (shared with every sampling checker): ``Lock.locked()``
is true when *any* thread holds the lock, so a cross-thread race where the
other thread holds the lock at the sampled instant can pass.  RLocks and
Conditions use owner-aware ``_is_owned`` and do not have this gap.  The
static rule (TPUSC001) has no such blind spot for ``self.`` accesses.
"""

from __future__ import annotations

import os
import sys
import threading

ENABLED = os.environ.get("TPUSC_LOCKCHECK", "") == "1"

_violations: list[str] = []
_seen: set[tuple] = set()
_reg_lock = threading.Lock()
_MAX_VIOLATIONS = 1000
_READY_FLAG = "_tpusc_lc_ready"


def violations() -> list[str]:
    with _reg_lock:
        return list(_violations)


def reset() -> None:
    with _reg_lock:
        _violations.clear()
        _seen.clear()


def assert_clean() -> None:
    """No-op when disabled; raises with every recorded violation otherwise."""
    if not ENABLED:
        return
    got = violations()
    if got:
        raise AssertionError(
            "TPUSC_LOCKCHECK recorded guarded-field violations:\n  "
            + "\n  ".join(got)
        )


def _held(lock: object) -> bool:
    is_owned = getattr(lock, "_is_owned", None)  # RLock, Condition
    if callable(is_owned):
        try:
            return bool(is_owned())
        except Exception:
            pass
    locked = getattr(lock, "locked", None)
    if callable(locked):
        try:
            return bool(locked())
        except Exception:
            pass
    return True  # not a lock-like object: don't generate noise


def _record(cls_name: str, field: str, lockname: str, op: str) -> None:
    # stack: caller -> __getattribute__/__setattr__ -> _check -> _record
    frame = sys._getframe(3)
    site = f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"
    key = (cls_name, field, op, site)
    with _reg_lock:
        if key in _seen or len(_violations) >= _MAX_VIOLATIONS:
            return
        _seen.add(key)
        _violations.append(
            f"{cls_name}.{field} {op} at {site} without holding {lockname}"
        )


def lockchecked(cls):
    """Class decorator: instrument ``_tpusc_guarded`` fields when enabled."""
    if not ENABLED:
        return cls
    guarded: dict[str, str] = {}
    for base in reversed(cls.__mro__):
        guarded.update(getattr(base, "_tpusc_guarded", None) or {})
    if not guarded:
        return cls

    orig_init = cls.__init__
    orig_getattribute = cls.__getattribute__
    orig_setattr = cls.__setattr__

    def _check(self, name: str, op: str) -> None:
        try:
            object.__getattribute__(self, _READY_FLAG)
        except AttributeError:
            return  # still constructing: single-owner
        lockname = guarded[name]
        try:
            lock = object.__getattribute__(self, lockname)
        except AttributeError:
            _record(cls.__name__, name, lockname, f"{op} (lock missing)")
            return
        if not _held(lock):
            _record(cls.__name__, name, lockname, op)

    def __init__(self, *args, **kwargs):
        # Depth-track nested wrapped __init__s (decorated subclass calling a
        # decorated base via super()): only the OUTERMOST completion arms the
        # checks, else the base's return would flag the subclass's remaining
        # construction writes.
        try:
            depth = object.__getattribute__(self, "_tpusc_lc_depth")
        except AttributeError:
            depth = 0
        object.__setattr__(self, "_tpusc_lc_depth", depth + 1)
        try:
            orig_init(self, *args, **kwargs)
        finally:
            object.__setattr__(self, "_tpusc_lc_depth", depth)
        if depth == 0:
            object.__setattr__(self, _READY_FLAG, True)

    def __getattribute__(self, name):
        if name in guarded:
            _check(self, name, "read")
        return orig_getattribute(self, name)

    def __setattr__(self, name, value):
        if name in guarded:
            _check(self, name, "write")
        return orig_setattr(self, name, value)

    cls.__init__ = __init__
    cls.__getattribute__ = __getattribute__
    cls.__setattr__ = __setattr__
    return cls
