"""Per-tenant resource accounting: the cost-attribution ledger (counterpart
of ``tfservingcache_tpu/utils/accounting.py``).

Every tier feeds one per-tenant (``name@version``) ledger of monotonic
resource integrals:

- **Engine steps** (runtime/batcher.py): each chunk boundary lands its
  prefill and decode step-seconds plus tokens in/out on the one tenant the
  dispatch served (each scheduler thread is single-model).
- **KV pages** (runtime/batcher.py page gauge sites): page-seconds as the
  integral of DISTINCT pages held over time — a shared-prefix page mapped
  by N lanes of the tenant counts once, matching ``page_stats()``'s
  shared+private census, so the per-tenant page-seconds sum to the arena
  occupancy integral.
- **Residency** (runtime/model_runtime.py, cache/manager.py): device and
  disk byte-seconds from gauge stamps at load/evict sites, plus cold-load
  seconds and counts by source tier.
- **Peer streams** (protocol/peer_transfer.py): the packed bytes a node
  streamed to a peer on the tenant's behalf (``peer_bytes_served``).

Integrals use the gauge-integral trick: a level change at time t folds
``prev_level * (t - t_prev)`` into the running total, so reads just settle
the live levels to "now". Everything is monotonic; the ``/monitoring/
tenants`` endpoint additionally keeps reset-on-scrape marks (like the
flight ring's watermarks) so each scrape interval can read its own window.

The **dominant-share** score ranks tenants the DRF way: a tenant's share
of each dimension's total, maxed over dimensions. When one tenant's share
of recent step-time exceeds ``noisy_neighbor_share`` while another tenant
has rows queued, the ledger fires a ``noisy_neighbor`` flight dump
(RECORDER's per-(reason, model) cooldown dedupes the stream to one file
per incident).

Like the recorder, the ledger is a process-wide default instance
(``LEDGER``): accounting is write-mostly, bounded, and never raises on the
hot path. Tests construct their own instances or clear the global.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any

from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER
from tfservingcache_tpu_torch.utils.lockcheck import lockchecked
from tfservingcache_tpu_torch.utils.logging import get_logger

log = get_logger("accounting")

# Monotonic integral dimensions, in the reference's wire order (summary()
# sends each tenant as a plain list of these values), so — like
# flight_recorder.STEP_FIELDS — new names go at the END and existing
# positions never change.
DIMENSIONS = (
    "tokens_in",              # prompt tokens admitted
    "tokens_out",             # tokens emitted (excludes wasted overshoot)
    "prefill_step_seconds",   # wall seconds spent prefilling this tenant
    "decode_step_seconds",    # wall seconds of decode dispatches
    "kv_page_seconds",        # integral of distinct KV pages held x time
    "hbm_byte_seconds",       # integral of HBM residency bytes x time
    "host_byte_seconds",      # integral of host-tier DRAM bytes x time
    "disk_byte_seconds",      # integral of disk-cache bytes x time
    "cold_load_seconds",      # wall seconds of cold loads (all tiers)
    "peer_bytes_served",      # bytes streamed to peers for this tenant
)

# Live levels the ledger integrates over time -> the integral they feed.
GAUGE_DIMS = {
    "kv_pages": "kv_page_seconds",
    "hbm_bytes": "hbm_byte_seconds",
    "host_bytes": "host_byte_seconds",
    "disk_bytes": "disk_byte_seconds",
}


class _Account:
    """One tenant's ledger row. Mutated only under TenantLedger._lock."""

    __slots__ = ("totals", "gauges", "owners", "loads", "load_counts",
                 "marks", "published", "published_loads")

    def __init__(self) -> None:
        self.totals: dict[str, float] = dict.fromkeys(DIMENSIONS, 0.0)
        self.gauges: dict[str, tuple[float, float]] = {}  # dim -> (level, t)
        self.owners: dict[str, str] = {}  # dim -> gauge_sync owner token
        self.loads: dict[str, float] = {}        # tier -> cold seconds
        self.load_counts: dict[str, int] = {}    # tier -> reload count
        self.marks: dict[str, float] = {}        # totals at last reset scrape
        self.published: dict[str, float] = {}    # totals at last publish()
        self.published_loads: dict[str, float] = {}

    def settle(self, now: float) -> None:
        """Fold live gauge levels into their integrals up to ``now``."""
        for gdim, (level, t) in self.gauges.items():
            if now > t:
                if level:
                    self.totals[GAUGE_DIMS[gdim]] += level * (now - t)
                self.gauges[gdim] = (level, now)


@lockchecked
class TenantLedger:
    """Per-tenant resource integrals, one small lock around plain dicts:
    every write is a handful of float adds (the < 50 us chunk-boundary
    budget shared with the flight recorder), every read settles gauges to
    now first so integrals are exact at observation time."""

    _tpusc_guarded = {"_accounts": "_lock", "_win": "_lock"}

    def __init__(
        self,
        enabled: bool = True,
        noisy_share: float = 0.8,
        noisy_window_s: float = 5.0,
        noisy_min_step_s: float = 0.25,
    ) -> None:
        self.enabled = bool(enabled)
        self.noisy_share = float(noisy_share)
        self.noisy_window_s = float(noisy_window_s)
        self.noisy_min_step_s = float(noisy_min_step_s)
        self._lock = threading.Lock()
        self._accounts: dict[str, _Account] = {}
        # noisy-neighbor sliding window over note_step calls: the deque
        # holds (t, tenant, step_s, queued); the sums are maintained
        # incrementally so the hot path never rescans the window.
        self._win: collections.deque = collections.deque()
        self._win_step: dict[str, float] = {}    # guarded-by: _lock (via _win)
        self._win_queued: dict[str, int] = {}    # guarded-by: _lock (via _win)
        self._win_total = 0.0                    # guarded-by: _lock (via _win)
        # global arena occupancy integral (conservation check's other side)
        self._arena_level = 0.0
        self._arena_t: float | None = None
        self._arena_integral = 0.0

    def configure(
        self,
        enabled: bool | None = None,
        noisy_share: float | None = None,
        noisy_window_s: float | None = None,
        noisy_min_step_s: float | None = None,
    ) -> None:
        """Apply config to the process-wide ledger (server startup)."""
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if noisy_share is not None:
                self.noisy_share = float(noisy_share)
            if noisy_window_s is not None:
                self.noisy_window_s = float(noisy_window_s)
            if noisy_min_step_s is not None:
                self.noisy_min_step_s = float(noisy_min_step_s)

    # -- write side (hot path) ----------------------------------------------
    def _account(self, tenant: str) -> _Account:  # lock-held: _lock
        acct = self._accounts.get(tenant)
        if acct is None:
            acct = self._accounts[tenant] = _Account()
        return acct

    def note_step(
        self,
        tenant: str,
        engine: str,
        prefill_s: float = 0.0,
        decode_s: float = 0.0,
        tokens_in: int = 0,
        tokens_out: int = 0,
        queue_depth: int = 0,
    ) -> None:
        """One engine chunk boundary / batch drain for ``tenant``. Also
        advances the noisy-neighbor window; the dump (if any) fires outside
        the lock so file IO never blocks a scheduler thread's next admit."""
        if not self.enabled:
            return
        now = time.monotonic()
        step_s = prefill_s + decode_s
        noisy = None
        with self._lock:
            t = self._account(tenant).totals
            t["prefill_step_seconds"] += prefill_s
            t["decode_step_seconds"] += decode_s
            t["tokens_in"] += tokens_in
            t["tokens_out"] += tokens_out
            noisy = self._advance_window(now, tenant, step_s, queue_depth > 0)
        if noisy is not None:
            share, win_total = noisy
            # RECORDER's per-(reason, model) cooldown turns the per-step
            # stream of exceedances into one dump per incident.
            RECORDER.dump(
                "noisy_neighbor", model=tenant, engine=engine,
                step_share=round(share, 4),
                window_step_seconds=round(win_total, 6),
                window_s=self.noisy_window_s,
                share_threshold=self.noisy_share,
                tenants=self.snapshot(top=8)["top"],
            )

    def _advance_window(  # lock-held: _lock
        self, now: float, tenant: str, step_s: float, queued: bool
    ) -> tuple[float, float] | None:
        """Slide the step-time window; returns (share, window_total) when
        ``tenant`` is over the noisy threshold while ANOTHER tenant has
        rows queued. Caller holds _lock."""
        win = self._win
        win.append((now, tenant, step_s, queued))
        self._win_step[tenant] = self._win_step.get(tenant, 0.0) + step_s
        if queued:
            self._win_queued[tenant] = self._win_queued.get(tenant, 0) + 1
        self._win_total += step_s
        horizon = now - self.noisy_window_s
        while win and win[0][0] < horizon:
            t0, ten, s0, q0 = win.popleft()
            self._win_step[ten] -= s0
            self._win_total -= s0
            if q0:
                left = self._win_queued.get(ten, 1) - 1
                if left <= 0:
                    self._win_queued.pop(ten, None)
                else:
                    self._win_queued[ten] = left
        total = self._win_total
        if total < self.noisy_min_step_s:
            return None
        share = self._win_step.get(tenant, 0.0) / total
        if share < self.noisy_share:
            return None
        if not any(t != tenant for t in self._win_queued):
            return None
        return share, total

    def gauge_set(self, tenant: str, dim: str, level: float) -> None:
        """Stamp a live level (pages or bytes); integrates the PREVIOUS
        level over the elapsed interval into the dimension's integral."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            acct = self._account(tenant)
            prev = acct.gauges.get(dim)
            if prev is not None:
                lv, t = prev
                if lv and now > t:
                    acct.totals[GAUGE_DIMS[dim]] += lv * (now - t)
            acct.gauges[dim] = (float(level), now)

    def gauge_sync(
        self, dim: str, levels: dict[str, float], owner: str = ""
    ) -> None:
        """Bulk stamp one gauge dimension from a residency walk: tenants in
        ``levels`` get their level set; tenants this ``owner`` previously
        stamped that are absent from ``levels`` are zeroed (the evict side
        of a load/evict pair, without a hook at every evict site). The
        owner token scopes the zeroing so several runtimes/tiers in one
        process (multi-group, in-process test fleets) never zero each
        other's residents."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            for tenant, level in levels.items():
                acct = self._account(tenant)
                prev = acct.gauges.get(dim)
                if prev is not None:
                    lv, t = prev
                    if lv and now > t:
                        acct.totals[GAUGE_DIMS[dim]] += lv * (now - t)
                acct.gauges[dim] = (float(level), now)
                acct.owners[dim] = owner
            for tenant, acct in self._accounts.items():
                if tenant in levels or acct.owners.get(dim) != owner:
                    continue
                prev = acct.gauges.get(dim)
                if prev is None or prev[0] == 0.0:
                    continue
                lv, t = prev
                if now > t:
                    acct.totals[GAUGE_DIMS[dim]] += lv * (now - t)
                acct.gauges[dim] = (0.0, now)

    def note_arena(self, pages: int) -> None:
        """Global arena occupancy level (summed distinct pages across
        models) — the independent integral the conservation test compares
        Σ per-tenant kv_page_seconds against."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            if self._arena_t is not None and now > self._arena_t:
                self._arena_integral += self._arena_level * (now - self._arena_t)
            self._arena_level = float(pages)
            self._arena_t = now

    def note_load(self, tenant: str, tier: str, seconds: float) -> None:
        """One ensure_servable resolution: which tier satisfied the reload
        (hbm | host | disk | peer | store) and what it cost in wall time."""
        if not self.enabled:
            return
        with self._lock:
            acct = self._account(tenant)
            acct.totals["cold_load_seconds"] += seconds
            acct.loads[tier] = acct.loads.get(tier, 0.0) + seconds
            acct.load_counts[tier] = acct.load_counts.get(tier, 0) + 1

    def note_peer_served(self, tenant: str, nbytes: int) -> None:
        """Bytes this node streamed TO a peer on the tenant's behalf."""
        if not self.enabled:
            return
        with self._lock:
            self._account(tenant).totals["peer_bytes_served"] += nbytes

    # -- read side -----------------------------------------------------------
    def arena_page_seconds(self) -> float:
        now = time.monotonic()
        with self._lock:
            if self._arena_t is not None and now > self._arena_t:
                self._arena_integral += self._arena_level * (now - self._arena_t)
                self._arena_t = now
            return self._arena_integral

    @staticmethod
    def _shares(
        accounts: dict[str, _Account],
    ) -> dict[str, tuple[float, str]]:
        """Dominant share per tenant: its fraction of each dimension's
        cross-tenant total, maxed over dimensions (DRF-style)."""
        sums = dict.fromkeys(DIMENSIONS, 0.0)
        for acct in accounts.values():
            for d in DIMENSIONS:
                sums[d] += acct.totals[d]
        out: dict[str, tuple[float, str]] = {}
        for tenant, acct in accounts.items():
            best, best_dim = 0.0, DIMENSIONS[0]
            for d in DIMENSIONS:
                if sums[d] > 0.0:
                    s = acct.totals[d] / sums[d]
                    if s > best:
                        best, best_dim = s, d
            out[tenant] = (best, best_dim)
        return out

    def snapshot(
        self,
        top: int = 0,
        dim: str | None = None,
        model: str | None = None,
        reset: bool = False,
    ) -> dict[str, Any]:
        """JSON-ready ledger state: the ``/monitoring/tenants`` payload.
        ``top`` keeps the k highest tenants (by ``dim``, default dominant
        share); ``model`` restricts to one tenant key and stamps
        ``model_filter``/``model_found`` so an unknown tenant is
        distinguishable from an idle one; ``reset`` consumes the
        reset-on-scrape marks (each scrape reads its own window)."""
        now = time.monotonic()
        with self._lock:
            for acct in self._accounts.values():
                acct.settle(now)
            shares = self._shares(self._accounts)
            found = model is None or model in self._accounts
            keys = list(self._accounts)
            if model is not None:
                keys = [k for k in keys if k == model]
            tenants: dict[str, Any] = {}
            for tenant in keys:
                acct = self._accounts[tenant]
                share, share_dim = shares[tenant]
                tenants[tenant] = {
                    "totals": {d: round(acct.totals[d], 6) for d in DIMENSIONS},
                    "window": {
                        d: round(acct.totals[d] - acct.marks.get(d, 0.0), 6)
                        for d in DIMENSIONS
                    },
                    "gauges": {
                        g: lv for g, (lv, _t) in acct.gauges.items() if lv
                    },
                    "loads": {
                        tier: {
                            "seconds": round(acct.loads[tier], 6),
                            "count": acct.load_counts.get(tier, 0),
                        }
                        for tier in acct.loads
                    },
                    "dominant_share": round(share, 6),
                    "dominant_dim": share_dim,
                }
                if reset:
                    acct.marks = dict(acct.totals)
            if self._arena_t is not None and now > self._arena_t:
                self._arena_integral += self._arena_level * (now - self._arena_t)
                self._arena_t = now
            arena = self._arena_integral
        if dim is not None and dim in DIMENSIONS:
            order = sorted(
                tenants, key=lambda t: tenants[t]["totals"][dim], reverse=True
            )
        else:
            order = sorted(
                tenants, key=lambda t: tenants[t]["dominant_share"],
                reverse=True,
            )
        if top > 0:
            order = order[:top]
            tenants = {t: tenants[t] for t in order}
        out: dict[str, Any] = {
            "dimensions": list(DIMENSIONS),
            "tenants": tenants,
            "top": order,
            "arena_page_seconds": round(arena, 6),
        }
        if model is not None:
            out["model_filter"] = model
            out["model_found"] = found
        return out

    def summary(self, max_tenants: int = 8) -> dict[str, list[float]]:
        """Compact wire form for the fleet status plane: tenant key -> the
        DIMENSIONS vector (positional, like STEP_FIELDS), top tenants by
        dominant share. FleetView sums these across nodes and recomputes
        fleet-wide dominant shares from the sums."""
        now = time.monotonic()
        with self._lock:
            for acct in self._accounts.values():
                acct.settle(now)
            shares = self._shares(self._accounts)
            order = sorted(
                self._accounts, key=lambda t: shares[t][0], reverse=True
            )[: max(0, max_tenants)]
            return {
                t: [round(self._accounts[t].totals[d], 3) for d in DIMENSIONS]
                for t in order
            }

    def publish(self, metrics: Any) -> None:
        """Mirror the ledger into the ``tpusc_tenant_*`` families at scrape
        time (delta-inc since the last publish, so the hot path never
        touches prometheus). No-op unless ``metrics.model_labels`` is on —
        per-tenant series without per-model labels would all fold into one
        meaningless all_models pile. Never raises (diagnostics path)."""
        if metrics is None or not getattr(metrics, "model_labels", False):
            return
        now = time.monotonic()
        try:
            with self._lock:
                shares = self._shares(self._accounts)
                work = []
                for tenant, acct in self._accounts.items():
                    acct.settle(now)
                    deltas = {}
                    for d in DIMENSIONS:
                        dv = acct.totals[d] - acct.published.get(d, 0.0)
                        if dv > 0.0:
                            deltas[d] = dv
                            acct.published[d] = acct.totals[d]
                    load_deltas = {}
                    for tier, secs in acct.loads.items():
                        dv = secs - acct.published_loads.get(tier, 0.0)
                        if dv > 0.0:
                            load_deltas[tier] = dv
                            acct.published_loads[tier] = secs
                    work.append((tenant, deltas, load_deltas, shares[tenant][0]))
            for tenant, deltas, load_deltas, share in work:
                name, _, version = tenant.rpartition("@")
                label = metrics.model_label(name or tenant, version)
                for d, dv in deltas.items():
                    if d == "tokens_in":
                        metrics.tenant_tokens.labels(label, "in").inc(dv)
                    elif d == "tokens_out":
                        metrics.tenant_tokens.labels(label, "out").inc(dv)
                    elif d == "prefill_step_seconds":
                        metrics.tenant_step_seconds.labels(label, "prefill").inc(dv)
                    elif d == "decode_step_seconds":
                        metrics.tenant_step_seconds.labels(label, "decode").inc(dv)
                    elif d == "kv_page_seconds":
                        metrics.tenant_kv_page_seconds.labels(label).inc(dv)
                    elif d == "hbm_byte_seconds":
                        metrics.tenant_byte_seconds.labels(label, "hbm").inc(dv)
                    elif d == "host_byte_seconds":
                        metrics.tenant_byte_seconds.labels(label, "host").inc(dv)
                    elif d == "disk_byte_seconds":
                        metrics.tenant_byte_seconds.labels(label, "disk").inc(dv)
                    elif d == "peer_bytes_served":
                        metrics.tenant_peer_bytes_served.labels(label).inc(dv)
                    # cold_load_seconds lands tier-split below
                for tier, dv in load_deltas.items():
                    metrics.tenant_cold_load_seconds.labels(label, tier).inc(dv)
                metrics.tenant_dominant_share.labels(label).set(share)
        except Exception as e:  # noqa: BLE001 — diagnostics must stay non-fatal
            log.warning("tenant metrics publish failed: %s", e)

    def clear(self) -> None:
        with self._lock:
            self._accounts.clear()
            self._win.clear()
            self._win_step.clear()
            self._win_queued.clear()
            self._win_total = 0.0
            self._arena_level = 0.0
            self._arena_t = None
            self._arena_integral = 0.0


# Process-wide default (same rationale as RECORDER / TRACER): accounting is
# always on, write-mostly, and bounded by tenant count; server startup
# applies config.observability knobs via configure(). Tests construct their
# own instances or clear the global.
LEDGER = TenantLedger()
