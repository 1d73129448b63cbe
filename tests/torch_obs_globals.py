"""The process-wide tracer, flight recorder and tenant ledger of both
packages, cleared and confined for one test: cleared before and after, a
small ring, dumps only into the test's own directory (or off), and every
knob the test may change put back. Used by the ``tests/test_torch_*``
observability files."""

from contextlib import contextmanager

from tfservingcache_tpu.utils import accounting as jaccounting
from tfservingcache_tpu.utils import flight_recorder as jflight
from tfservingcache_tpu.utils import tracing as jtracing
from tfservingcache_tpu_torch.utils import accounting, flight_recorder, tracing

RING_ENTRIES = 256

_TRACER_KNOBS = ("capacity", "slow_threshold_s", "slow_capacity", "slow_hook")
_RECORDER_KNOBS = ("flight_dir", "ring_entries", "max_dumps", "dump_cooldown_s")
_LEDGER_KNOBS = ("enabled", "noisy_share", "noisy_window_s", "noisy_min_step_s")


def _globals():
    return [(jtracing.TRACER, _TRACER_KNOBS), (tracing.TRACER, _TRACER_KNOBS),
            (jflight.RECORDER, _RECORDER_KNOBS), (flight_recorder.RECORDER, _RECORDER_KNOBS),
            (jaccounting.LEDGER, _LEDGER_KNOBS), (accounting.LEDGER, _LEDGER_KNOBS)]


def _clear():
    for obj, _knobs in _globals():
        obj.clear()


@contextmanager
def confined_globals(flight_dir=None):
    """Both packages' TRACER, RECORDER and LEDGER, cleared, with
    ``ring_entries`` small and dumps into ``flight_dir`` (None = off)."""
    saved = [(obj, {k: getattr(obj, k) for k in knobs}) for obj, knobs in _globals()]
    _clear()
    for rec in (jflight.RECORDER, flight_recorder.RECORDER):
        rec.configure(flight_dir=str(flight_dir) if flight_dir else "",
                      ring_entries=RING_ENTRIES)
    for tracer in (jtracing.TRACER, tracing.TRACER):
        tracer.slow_hook = None  # no SLO-breach dumps unless a test asks
    try:
        yield
    finally:
        _clear()
        for obj, knobs in saved:
            for k, v in knobs.items():
                setattr(obj, k, v)
