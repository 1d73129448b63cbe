"""Device timing of a tensor function by chained runs (counterpart of
``tfservingcache_tpu/utils/benchtime.py``).

One call timed alone says little on a card: the launch returns before the
work is done, the host's launch overhead can be longer than a small
kernel, and a cache warmed by the call before flatters the next. So the N
runs are chained by a data dependency (each run's first output element
perturbs the next run's first input), captured as one CUDA graph per chain
length and replayed between CUDA events; a 1-run graph replayed the same way
is subtracted, which cancels the replay's own launch and the event
overhead. Every timed replay gets a freshly perturbed first input, so no
timed run repeats the inputs of the warm-up.

On the CPU the same chain runs eagerly under ``time.perf_counter`` (the
tests hold the chaining there; a CPU time is not a device time).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch


def _first_leaf(out: Any) -> torch.Tensor:
    """The first tensor of ``out`` (a tensor, or a tuple, list or dict of
    them; a dict in key order, as a JAX tree's leaves come)."""
    while not isinstance(out, torch.Tensor):
        if isinstance(out, dict):
            out = out[sorted(out)[0]]
        elif isinstance(out, (tuple, list)) and out:
            out = out[0]
        else:
            raise TypeError(f"chained_device_time: fn returned {type(out).__name__}, "
                            "not a tensor or a tuple, list or dict of tensors")
    return out


def _chain(fn: Callable[..., Any], a0: torch.Tensor, rest: tuple, n: int) -> torch.Tensor:
    """``n`` runs of ``fn(a, *rest)``, run i + 1 on ``a + 1e-6 * (run i's
    first output element)``; -> the f32 sum of those elements (the value a
    caller must wait for)."""
    acc = torch.zeros((), dtype=torch.float32, device=a0.device)
    a = a0
    for _ in range(n):
        first = _first_leaf(fn(a, *rest)).reshape(-1)[0].float()
        a = a + (first * 1e-6).to(a.dtype)
        acc = acc + first
    return acc


def _eager_seconds(fn: Callable[..., Any], a0: torch.Tensor, rest: tuple, n: int) -> float:
    """Host seconds of one eager chain of ``n`` runs, waited for."""
    t0 = time.perf_counter()
    float(_chain(fn, a0, rest, n))
    return time.perf_counter() - t0


class _GraphChain:
    """A chain of ``n`` runs captured once as a CUDA graph over a static
    copy of the first input; ``seconds(a0)`` copies ``a0`` in and times one
    replay between CUDA events."""

    def __init__(self, fn: Callable[..., Any], a0: torch.Tensor, rest: tuple, n: int) -> None:
        self.static = a0.clone()
        side = torch.cuda.Stream(device=a0.device)
        side.wait_stream(torch.cuda.current_stream(a0.device))
        with torch.cuda.stream(side):  # the warm-up a capture needs, off the capture
            _chain(fn, self.static, rest, n)
        torch.cuda.current_stream(a0.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.acc = _chain(fn, self.static, rest, n)
        except RuntimeError as e:
            raise RuntimeError(
                f"chained_device_time: a chain of {n} runs of {getattr(fn, '__name__', fn)!r} "
                f"cannot be captured in a CUDA graph (a host read of a device value, a "
                f"synchronisation or a launch off the current stream): {e}") from e

    def seconds(self, a0: torch.Tensor) -> float:
        self.static.copy_(a0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def chained_device_time(
    fn: Callable[..., Any],
    args: Sequence[Any],
    iters: int = 16,
    repeats: int = 3,
    max_iters: int = 1024,
    return_valid: bool = False,
) -> float | tuple[float, bool]:
    """Seconds per call of ``fn(*args)``, measured on the device of
    ``args[0]``.

    ``fn`` returns a tensor (or a tuple, list or dict of them; the first
    feeds the chain). ``args[0]`` must be a floating tensor: run i + 1 gets
    it perturbed by ``1e-6 * out[0]``, so no two runs are identical and none
    can be skipped or reordered. Every timed call gets a freshly perturbed
    ``args[0]`` too, with a step of 8 eps of its dtype scaled by
    ``max|args[0]|`` (an absolute step would round away at magnitude >~ 8
    in f32, and already at 1 in bf16). The estimate is the median over
    ``repeats`` (1-run, n-run) pairs of (long - short) / (n - 1).

    ``iters`` is a starting chain length: while the n-run call does not
    take at least twice the 1-run call (medians of a round), the difference
    is launch noise, and the chain grows 4x up to ``max_iters``, captured
    anew each time. If it never dominates, the ``max_iters`` estimate is
    returned; pass ``return_valid=True`` to get ``(estimate, dominated)``
    and mark such a row noisy.

    On CUDA a chain is one CUDA graph: ``fn`` must launch only on the
    current stream and read nothing back to the host. One that does raises
    (naming the failure) instead of being timed some other way. Launch
    counters bumped in Python wrappers count each capture once and no
    replay, so a caller resets them after this call.
    """
    args = tuple(args)
    a0, rest = args[0], args[1:]
    if not isinstance(a0, torch.Tensor) or not a0.is_floating_point():
        raise TypeError("chained_device_time: args[0] must be a floating-point tensor")
    iters, max_iters = max(2, int(iters)), max(2, int(max_iters))

    salt = 0
    scale = max(1.0, float(a0.detach().float().abs().max()))
    step = 8 * torch.finfo(a0.dtype).eps * scale

    def fresh() -> torch.Tensor:
        nonlocal salt
        salt += 1
        return a0 + salt * step

    def measure(n: int) -> list[tuple[float, float]]:
        if a0.is_cuda:
            short, long_ = _GraphChain(fn, a0, rest, 1), _GraphChain(fn, a0, rest, n)
            run_short, run_long = short.seconds, long_.seconds
            run_short(a0)  # each graph's first replay, on the warm-up's inputs
            run_long(a0)
        else:
            def run_short(a):
                return _eager_seconds(fn, a, rest, 1)

            def run_long(a):
                return _eager_seconds(fn, a, rest, n)

            run_short(a0)  # the warm-up, on the caller's inputs
            run_long(a0)
        pairs = []
        for _ in range(repeats):
            a_short, a_long = fresh(), fresh()
            pairs.append((run_short(a_short), run_long(a_long)))
        return pairs

    # a fast fn at a short chain vanishes under launch overhead: the n-run
    # call takes barely longer than the 1-run call and the difference is
    # noise. Grow the chain until the long call clearly dominates.
    dominated = False
    while True:
        pairs = measure(iters)
        shorts = sorted(s for s, _ in pairs)
        longs = sorted(lg for _, lg in pairs)
        if longs[len(longs) // 2] >= 2.0 * shorts[len(shorts) // 2]:
            dominated = True
            break
        if iters >= max_iters:
            break
        iters = min(iters * 4, max_iters)
    estimates = sorted(max(lg - s, 1e-9) / (iters - 1) for s, lg in pairs)
    est = estimates[len(estimates) // 2]
    if return_valid:
        return est, dominated
    return est
