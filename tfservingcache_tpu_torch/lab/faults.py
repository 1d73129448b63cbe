"""Scenario-lab fault injector: chaos hooks in serving paths (a stdlib copy
of ``tfservingcache_tpu/lab/faults.py``).

Serving code calls ``fire(site, ...)`` at a hook site. The port hooks all
four of the reference's:

* ``engine_step`` — the top of the continuous scheduler's chunk boundary
  (runtime/batcher.py). ``kill_engine`` raises :class:`InjectedFault` there,
  down the same path an organic device failure takes (the scheduler's crash
  triage, requeue and re-prefill); ``freeze_scheduler`` sleeps the scheduler
  thread for ``duration_s`` so that queued rows age.
* ``status_ingest`` — fleet status ingestion (cluster/status.py
  ``FleetView.ingest``). ``drop_peer`` swallows the snapshot (``fire``
  returns None for the payload), so the peer's health decays through the
  normal staleness path; ``peer`` filters on the snapshot's ident.
* ``store_fetch`` — the cache manager's provider miss (cache/manager.py
  ``_fetch``). ``stall_store`` sleeps ``duration_s`` there, a hung object
  store under the caller's cold-load deadline.
* ``peer_chunk`` — each C frame the peer-transfer receiver takes
  (protocol/peer_transfer.py ``PeerStreamReceiver.feed``).
  ``corrupt_peer_chunk`` flips the frame's last byte: the headers parse,
  the chunk's hash fails, and the provider falls back to the store.

A spec of any other kind is refused: arming it would succeed and it would
never fire.

Disarmed (the default, and the only state a node reaches without
``observability.lab_faults``) every hook is one bool read and a return of
the payload. Every firing tallies into the flight recorder
(``RECORDER.note_fault``), increments ``tpusc_fault_injected_total{kind}``
when a ``Metrics`` was armed alongside the specs, and writes one
``fault_injected:<kind>`` flight dump under the recorder's cooldown.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER

log = logging.getLogger("tpusc_torch.lab.faults")

KILL_KINDS = ("kill_engine",)
SLEEP_KINDS = ("freeze_scheduler", "stall_store")
KINDS = (
    "kill_engine",
    "freeze_scheduler",
    "stall_store",
    "corrupt_peer_chunk",
    "drop_peer",
)
# which hook site each fault kind attaches to (only kinds whose site is hooked)
SITE_OF = {
    "kill_engine": "engine_step",
    "freeze_scheduler": "engine_step",
    "stall_store": "store_fetch",
    "corrupt_peer_chunk": "peer_chunk",
    "drop_peer": "status_ingest",
}


class InjectedFault(RuntimeError):
    """Raised by an armed kill-class fault at its hook site. A plain
    RuntimeError subclass on purpose: the victim path must handle it exactly
    like the organic failure it stands in for, never special-case it."""


@dataclass
class FaultSpec:
    """One armed fault. ``after`` skips the first N matching visits (fire on
    visit N+1), ``count`` bounds the firings (0 = unlimited), ``model``
    and ``peer`` filter the site's context when set. ``visits``/``fired`` are tallies
    owned by the injector's lock."""

    kind: str
    after: int = 0
    count: int = 1
    duration_s: float = 0.05
    model: str | None = None
    peer: str | None = None
    visits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self) -> None:
        if self.kind not in SITE_OF:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {sorted(SITE_OF)}")

    @property
    def site(self) -> str:
        return SITE_OF[self.kind]


class FaultInjector:
    """Process-global spec store. ``armed`` is a plain bool read on each
    hook's fast path (flipped only in arm/disarm); the specs and their
    tallies are lock-owned."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []  # guarded-by: _lock
        self._metrics: Any = None  # guarded-by: _lock
        self.armed = False

    def arm(self, specs: list[FaultSpec], metrics: Any = None) -> None:
        """Arm ``specs``, replacing any earlier arming. ``metrics`` is the
        node's ``Metrics`` for the fault counter family; optional, so an
        engine-only harness arms without a registry."""
        with self._lock:
            self._specs = list(specs)
            self._metrics = metrics
        self.armed = True
        log.warning("fault injector ARMED: %s",
                    [f"{s.kind}(after={s.after},count={s.count})" for s in specs])

    def disarm(self) -> None:
        self.armed = False
        with self._lock:
            self._specs = []
            self._metrics = None

    def snapshot(self) -> list[dict[str, Any]]:
        """Per-spec tallies."""
        with self._lock:
            return [{"kind": s.kind, "visits": s.visits, "fired": s.fired} for s in self._specs]

    def fire(self, site: str, model: str | None = None, peer: str | None = None,
             payload: Any = None) -> Any:
        """The armed slow path: apply every matching spec in arming order; a
        kill raises after its bookkeeping, so the firing is counted even
        though the site dies. Returns the payload (None once dropped)."""
        to_sleep = 0.0
        to_raise: InjectedFault | None = None
        fired_kinds: list[str] = []
        with self._lock:
            metrics = self._metrics
            for s in self._specs:
                if s.site != site:
                    continue
                if s.model is not None and s.model != model:
                    continue
                if s.peer is not None and s.peer != peer:
                    continue
                s.visits += 1
                if s.visits <= s.after or (s.count and s.fired >= s.count):
                    continue
                s.fired += 1
                fired_kinds.append(s.kind)
                if s.kind in SLEEP_KINDS:
                    to_sleep = max(to_sleep, s.duration_s)
                elif s.kind in KILL_KINDS:
                    to_raise = InjectedFault(
                        f"injected {s.kind} at {site}" + (f" (model={model})" if model else ""))
                elif s.kind == "corrupt_peer_chunk":
                    payload = _corrupt(payload)
                elif s.kind == "drop_peer":
                    payload = None
        for kind in fired_kinds:
            RECORDER.note_fault(kind)
            if metrics is not None:
                metrics.fault_injected.labels(kind).inc()
            # one dump per (reason, model) inside the recorder's cooldown: a
            # storm of firings is one spool file, not one each
            RECORDER.dump(f"fault_injected:{kind}", model=model, site=site, peer=peer)
            log.warning("fault fired: %s at %s model=%s peer=%s", kind, site, model, peer)
        if to_sleep > 0.0:
            time.sleep(to_sleep)
        if to_raise is not None:
            raise to_raise
        return payload


def _corrupt(payload: Any) -> Any:
    """Flip the last byte of a bytes-like payload (a peer-transfer frame):
    the headers stay intact, so the frame parses and the receiver's
    per-chunk hash catches the damage, as it would wire bitrot."""
    if payload is None or len(payload) == 0:
        return payload
    buf = bytearray(payload)
    buf[-1] ^= 0xFF
    return bytes(buf)


_INJECTOR = FaultInjector()


def fire(site: str, model: str | None = None, peer: str | None = None,
         payload: Any = None) -> Any:
    """Hook entry point for serving call sites; returns ``payload`` (None
    when a fault dropped it). Disarmed: one attribute read and a return."""
    if not _INJECTOR.armed:
        return payload
    return _INJECTOR.fire(site, model=model, peer=peer, payload=payload)


def arm(specs: list[FaultSpec], metrics: Any = None) -> None:
    _INJECTOR.arm(specs, metrics=metrics)


def disarm() -> None:
    _INJECTOR.disarm()


def armed() -> bool:
    return _INJECTOR.armed


def snapshot() -> list[dict[str, Any]]:
    return _INJECTOR.snapshot()


def arm_json(spec_json: str, metrics: Any = None) -> None:
    """Arm from the ``observability.lab_faults`` string (also the
    ``TPUSC_OBSERVABILITY_LAB_FAULTS`` override): a JSON list of FaultSpec
    dicts, e.g. ``[{"kind": "freeze_scheduler", "after": 10, "duration_s":
    0.25}]``. A malformed spec raises: a drill that silently armed nothing
    would report a meaningless green result."""
    raw = json.loads(spec_json)
    if not isinstance(raw, list):
        raise ValueError("lab_faults must be a JSON list of fault specs")
    arm([FaultSpec(**d) for d in raw], metrics=metrics)
