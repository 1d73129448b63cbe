"""Ring attention: context parallelism over a device group.

Counterpart of ``tfservingcache_tpu/parallel/ring_attention.py``. The
sequence axis of q/k/v ``(B, H, S, D)`` is split into P = ``len(devices)``
shards, shard i on ``devices[i]``. Each step, every shard attends its local
Q against the K/V block it holds, carrying the online-softmax state (acc, m,
l) in f32, then the K/V blocks move one hop around the ring, block i to
``devices[(i + 1) % P]``. After P steps every Q shard has seen every K/V
block while each device held O(S/P) of K/V at a time.

The reference runs the shards as one SPMD program (``shard_map`` and
``ppermute``). The port drives the group from one process in lockstep: for
each step it enqueues every shard's hop on that shard's device (they run
concurrently on distinct cards), then rotates the Python list of K/V blocks
with ``.to(devices[i + 1], non_blocking=True)``. PyTorch orders a peer copy
after the work already queued on both devices' current streams; on a
repeated device the copy is the same tensor and nothing moves, so no hop may
write into a K/V block. K/V ride the ring in their input dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tfservingcache_tpu_torch.ops.attention import NEG_INF, attention_carry


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    devices: Sequence[str | torch.device],
    causal: bool = True,
) -> torch.Tensor:
    """(B, H, S, D) attention with S split over ``devices`` (K/V heads equal
    to q's or grouped under them). Each hop runs through
    ``ops.attention.attention_carry``: the carry kernel on a CUDA shard, the
    plain version on a CPU one; P^2 hops in all, hop (step, i) with the
    block that started on shard src = (i - step) % P at rel = (src - i) *
    S/P. The output, in q's dtype, is gathered on ``devices[0]``."""
    devs = [torch.device(d) for d in devices]
    n_shards = len(devs)
    if n_shards < 1:
        raise ValueError("ring_attention needs at least one device")
    b, h, s, d = q.shape
    if s % n_shards:
        raise ValueError(f"sequence {s} not divisible by {n_shards} ring shards")
    s_local = s // n_shards

    def shard(x: torch.Tensor, i: int) -> torch.Tensor:
        return x[:, :, i * s_local:(i + 1) * s_local].contiguous().to(devs[i], non_blocking=True)

    qs = [shard(q, i) for i in range(n_shards)]
    ks = [shard(k, i) for i in range(n_shards)]
    vs = [shard(v, i) for i in range(n_shards)]
    acc = [torch.zeros(qi.shape, dtype=torch.float32, device=qi.device) for qi in qs]
    m = [torch.full((b, h, s_local, 1), NEG_INF, dtype=torch.float32, device=qi.device)
         for qi in qs]
    l = [torch.zeros((b, h, s_local, 1), dtype=torch.float32, device=qi.device) for qi in qs]
    for step in range(n_shards):
        for i in range(n_shards):
            # after `step` rotations shard i holds the block that started at
            # ring position (i - step) mod P
            src = (i - step) % n_shards
            acc[i], m[i], l[i] = attention_carry(
                qs[i], ks[i], vs[i], acc[i], m[i], l[i], (src - i) * s_local, causal,
            )
        if step + 1 < n_shards:
            ks = [ks[i - 1].to(devs[i], non_blocking=True) for i in range(n_shards)]
            vs = [vs[i - 1].to(devs[i], non_blocking=True) for i in range(n_shards)]
    outs = [(acc[i] / torch.clamp(l[i], min=1e-30)).to(q.dtype).to(devs[0], non_blocking=True)
            for i in range(n_shards)]
    return torch.cat(outs, dim=2)
