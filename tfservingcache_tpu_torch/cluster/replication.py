"""Load-adaptive per-model replication (counterpart of
``tfservingcache_tpu/cluster/replication.py``).

A ``ReplicaController`` turns the router's per-key in-flight counts into a
per-model ring replica count N: ``evaluate`` smooths each key's demand
(EWMA of the peak in flight since the last tick), sets
N = clamp(ceil(ewma / load_target), base, max), grows at once, and shrinks
only after ``decay_ticks`` evaluations in a row want less. The ring's walk
is prefix-stable in N, so a new N only adds or drops the tail replica;
growth warms the newly assigned local group on a thread. A thread runs
``evaluate`` every ``interval_s``; tests call it directly.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Mapping

from tfservingcache_tpu_torch.types import ModelId
from tfservingcache_tpu_torch.utils.lockcheck import lockchecked

log = logging.getLogger("tpusc_torch.replication")

_DEMAND_ALPHA = 0.5   # EWMA weight of a tick's demand sample
# a key back at the floor with smoothed demand below this is forgotten
_IDLE_EPSILON = 0.05


class _KeyState:
    __slots__ = ("ewma", "target", "decay", "inflight", "peak")

    def __init__(self, base: int) -> None:
        self.ewma = 0.0
        self.target = base
        self.decay = 0
        self.inflight = 0
        self.peak = 0


@lockchecked
class ReplicaController:
    """Per-model replica target from routed in-flight load: the read side
    is ``ClusterConnection.replicas_for_key`` (``replicas_for``), the write
    side ``RoutingBackend``'s ``note_start`` / ``note_end`` around each
    request."""

    _tpusc_guarded = {"_keys": "_lock", "_warming": "_lock"}

    def __init__(
        self,
        cluster,
        base_replicas: int = 1,
        max_replicas: int = 4,
        load_target: float = 2.0,
        decay_ticks: int = 3,
        interval_s: float = 2.0,
        metrics=None,
        local_managers: Mapping[str, object] | None = None,
    ) -> None:
        self.cluster = cluster
        self.base = max(1, int(base_replicas))
        self.max = max(self.base, int(max_replicas))
        self.load_target = max(1e-6, float(load_target))
        self.decay_ticks = max(1, int(decay_ticks))
        self.interval_s = float(interval_s)
        self.metrics = metrics
        # ring ident -> CacheManager of this host's groups (growth warms them)
        self.local_managers = dict(local_managers or {})
        self._lock = threading.Lock()
        self._keys: dict[str, _KeyState] = {}
        self._warming: set[tuple[str, str]] = set()   # (key, ident) in flight
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- demand notes -------------------------------------------------------
    def note_start(self, key: str) -> None:
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = _KeyState(self.base)
            st.inflight += 1
            if st.inflight > st.peak:
                st.peak = st.inflight

    def note_end(self, key: str) -> None:
        with self._lock:
            st = self._keys.get(key)
            if st is not None and st.inflight > 0:
                st.inflight -= 1

    # -- read side ----------------------------------------------------------
    def replicas_for(self, key: str) -> int:
        with self._lock:
            st = self._keys.get(key)
        return st.target if st is not None else self.base

    # -- control loop -------------------------------------------------------
    def evaluate(self) -> dict[str, int]:
        """One tick: smooth demand, retarget with hysteresis, publish the
        gauge, warm grown replicas, forget idle keys -> {key: target}."""
        grown: list[tuple[str, int, int]] = []
        with self._lock:
            for key, st in list(self._keys.items()):
                demand = max(st.inflight, st.peak)
                st.peak = st.inflight
                st.ewma = _DEMAND_ALPHA * demand + (1 - _DEMAND_ALPHA) * st.ewma
                desired = max(self.base, min(self.max, math.ceil(st.ewma / self.load_target)))
                if desired > st.target:
                    grown.append((key, st.target, desired))
                    st.target = desired
                    st.decay = 0
                elif desired < st.target:
                    st.decay += 1
                    if st.decay >= self.decay_ticks:
                        st.target = desired
                        st.decay = 0
                else:
                    st.decay = 0
                if st.target <= self.base and st.inflight == 0 and st.ewma < _IDLE_EPSILON:
                    del self._keys[key]
                    self._remove_gauge(key)
                else:
                    self._publish(key, st.target)
            result = {k: s.target for k, s in self._keys.items()}
        for key, old_n, new_n in grown:
            log.info("replica target for %s: %d -> %d", key, old_n, new_n)
            self._warm_new_replicas(key, old_n, new_n)
        return result

    def _publish(self, key: str, target: int) -> None:
        if self.metrics is not None:
            self.metrics.model_replicas_target.labels(key).set(target)

    def _remove_gauge(self, key: str) -> None:
        if self.metrics is not None:
            try:
                self.metrics.model_replicas_target.remove(key)
            except KeyError:  # the series may never have existed
                pass

    def _warm_new_replicas(self, key: str, old_n: int, new_n: int) -> None:
        """Load the key on the newly assigned local groups: the ring's
        prefix stability makes exactly ``idents[old_n:new_n]`` new."""
        try:
            idents = self.cluster.ring.get_n(key, new_n)
        except Exception:  # noqa: BLE001 - an empty ring etc.
            return
        name, _, version = key.rpartition("##")
        if not name:
            return
        mid = ModelId(name, int(version))
        for ident in idents[old_n:]:
            manager = self.local_managers.get(ident)
            if manager is None:
                continue
            token = (key, ident)
            with self._lock:
                if token in self._warming:
                    continue
                self._warming.add(token)

            def work(manager=manager, mid=mid, token=token) -> None:
                try:
                    manager.ensure_servable(mid)
                    log.info("proactively warmed %s on %s", mid, token[1])
                except Exception as e:  # noqa: BLE001 - advisory warm
                    log.warning("proactive warm of %s failed: %s", mid, e)
                finally:
                    with self._lock:
                        self._warming.discard(token)

            threading.Thread(target=work, daemon=True, name="tpusc-replica-warm").start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 - the controller survives a tick
                log.exception("replica evaluation failed")

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="tpusc-replicas",
                                            daemon=True)
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
