"""Pipeline parallelism: the GPipe microbatch schedule over a device group
(counterpart of ``tfservingcache_tpu/parallel/pipeline.py``), forward only.

Stage i's params, sliced off the leading dimension of the stacked tree, live
on ``devices[i]``. The batch is split into M microbatches along dim 0, and
the schedule runs ``T = M + P - 1`` ticks in lockstep, as
``parallel/ring_attention.py`` drives its hops from one process: at tick t,
stage i runs ``stage_fn`` on microbatch ``t - i`` (when there is one), every
stage's tick enqueued on its own device before any output moves; then each
output moves to the next stage's device with ``.to(..., non_blocking=True)``,
and the last stage banks microbatch ``t - (P - 1)`` on ``devices[0]``. On
distinct cards the stages of one tick run concurrently; on a group that
repeats a device they run one after another there. The reference runs the
same schedule as one SPMD program (``shard_map``, ``ppermute``) in which
idle stages compute on placeholder inputs; here an idle stage runs nothing,
which changes no output.

The bubble is (P - 1) / (M + P - 1) of the ticks, so callers pick M well
above P. Inter-stage activations keep one shape (the usual transformer
block contract). The port serves and does not train: nothing here records
a gradient (the reference's schedule is differentiable).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from tfservingcache_tpu_torch.models.registry import flatten_params, unflatten_params


def _map(fn: Callable[..., torch.Tensor], *trees: Any) -> Any:
    pairs = [flatten_params(tree) for tree in trees]
    paths = [path for path, _leaf in pairs[0]]
    return unflatten_params(paths, [fn(*(p[k][1] for p in pairs)) for k in range(len(paths))])


def stack_stage_params(stage_params: list[Any]) -> Any:
    """Per-stage trees stacked into one tree with leading dim n_stages (the
    dim ``pipeline_apply`` deals out one stage per device)."""
    return _map(lambda *leaves: torch.stack(leaves), *stage_params)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    devices: Sequence[str | torch.device],
    n_microbatches: int | None = None,
) -> torch.Tensor:
    """``x`` (batch, ...) through ``len(devices)`` chained applications of
    ``stage_fn``, pipelined over ``devices``: exactly ``stage_fn(p[P-1], ...
    stage_fn(p[0], x))``, in x's dtype, on ``devices[0]``. ``stage_params``
    has leading dim P (``stack_stage_params``); ``n_microbatches`` defaults
    to P and must divide the batch."""
    devs = [torch.device(d) for d in devices]
    n_stages = len(devs)
    leading = {leaf.shape[0] for _path, leaf in flatten_params(stage_params)}
    if leading != {n_stages}:
        # each device would otherwise hold more than one stage and run only
        # its first: a wrong answer, no error
        raise ValueError(
            f"stage_params leading dim(s) {sorted(leading)} != {n_stages} mesh stages"
        )
    n_micro = n_stages if n_microbatches is None else n_microbatches
    if n_micro < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_micro}")
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible into {n_micro} microbatches")
    mb = x.shape[0] // n_micro
    xm = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    local = [_map(lambda a, i=i: a[i].to(devs[i], non_blocking=True), stage_params)
             for i in range(n_stages)]
    with torch.inference_mode():
        held: list[torch.Tensor | None] = [None] * n_stages  # stage i's input this tick
        banked: list[torch.Tensor | None] = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            if t < n_micro:
                held[0] = xm[t].to(devs[0], non_blocking=True)
            ys = [None if held[i] is None else stage_fn(local[i], held[i])
                  for i in range(n_stages)]
            slot = t - (n_stages - 1)
            if slot >= 0:
                banked[slot] = ys[-1].to(devs[0], non_blocking=True)
            held = [None] + [None if y is None else y.to(devs[i + 1], non_blocking=True)
                             for i, y in enumerate(ys[:-1])]
    return torch.cat(banked).to(x.dtype)
