"""Bounded child-process probe of the CUDA device (counterpart of
``tfservingcache_tpu/utils/backend_probe.py``).

A wedged CUDA stack or a card stuck in a bad state can make the first CUDA call
in a process hang or fail deep inside an unrelated request. A caller that
wants to know whether the card answers, and why not, asks a child process
with a timeout instead of initialising CUDA itself.

This is a diagnostic: it says whether the card answers and what was missing
when it does not. It is never a switch to the CPU: a caller that needs the
card and finds none stops with the diagnostic.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time

# the child: torch's view of the card, or why there is none
_CHILD = (
    "import sys, torch\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit('torch.cuda.is_available() is False (torch '\n"
    "             + torch.__version__ + ', CUDA ' + str(torch.version.cuda) + ')')\n"
    "n = torch.cuda.device_count()\n"
    "torch.zeros(1, device='cuda').add_(1)\n"
    "torch.cuda.synchronize()\n"
    "print('ok gpu', n, torch.cuda.get_device_name(0))\n"
)

# per-process memo for cached_backend_answers(); None = never probed
_memo: tuple[bool, str] | None = None  # guarded-by: _memo_lock
_memo_lock = threading.Lock()


def cached_backend_answers(
    timeout_s: float = 90.0, retries: int = 0, backoff_s: float = 5.0
) -> tuple[bool, str]:
    """``backend_answers`` with the verdict memoized per process: the first
    call probes, later calls (any arguments) return its verdict. Defaults to
    ``retries=0``: the memo makes the verdict permanent, so minutes of
    backoff to avoid memoizing a blip buy little. ``backend_answers`` stays
    uncached for callers that need a fresh probe."""
    global _memo
    with _memo_lock:
        if _memo is None:
            _memo = backend_answers(
                timeout_s=timeout_s, retries=retries, backoff_s=backoff_s
            )
        return _memo


def backend_answers(
    timeout_s: float = 90.0, retries: int = 2, backoff_s: float = 5.0
) -> tuple[bool, str]:
    """(ok, diagnostic): does the card come up in a child process?

    ``ok`` with ``"ok gpu <count> <name>"`` when the child saw a card, ran a
    kernel on it and synchronised; otherwise the end of what the child said
    (``torch.cuda.is_available()`` false, an import or CUDA error) or that
    it did not answer within ``timeout_s``. A failure is retried
    ``retries`` times. The child inherits the environment, so it sees the
    devices the caller would.
    """
    last = ""
    for attempt in range(retries + 1):
        try:
            r = subprocess.run(
                [sys.executable, "-c", _CHILD], timeout=timeout_s,
                capture_output=True, text=True,
            )
            if r.returncode == 0 and r.stdout.startswith("ok"):
                return True, r.stdout.strip()
            last = (r.stderr or r.stdout).strip()[-300:]
        except subprocess.TimeoutExpired:
            last = f"CUDA init did not answer within {timeout_s:.0f}s"
        if attempt < retries:
            time.sleep(backoff_s * (attempt + 1))
    return False, last
