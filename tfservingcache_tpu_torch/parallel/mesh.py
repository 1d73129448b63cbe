"""Device groups (counterpart of ``tfservingcache_tpu/parallel/mesh.py``).

A model too large for one device's attention working set is served by a
*group* of devices. In the port a group is a tuple of ``torch.device`` that
one process drives; it may name a device more than once, and its members
then run one after another on that device (the CPU tests' virtual groups,
and a ring on one card). ``make_mesh``/``compat_shard_map`` have no
counterpart: nothing here compiles a program over a mesh.
"""

from __future__ import annotations

from typing import Sequence

import torch


def chip_groups(devices: Sequence[str | torch.device],
                group_size: int) -> list[tuple[torch.device, ...]]:
    """Partition ``devices`` into contiguous groups of ``group_size``, with
    the reference's two errors."""
    if group_size < 1:
        raise ValueError("group_size must be >= 1")
    if len(devices) % group_size:
        raise ValueError(f"{len(devices)} devices not divisible into groups of {group_size}")
    devs = [torch.device(d) for d in devices]
    return [tuple(devs[i:i + group_size]) for i in range(0, len(devs), group_size)]


def group_mesh(devices: Sequence[str | torch.device], group_size: int,
               group_index: int) -> tuple[torch.device, ...]:
    """The ``group_index``-th group of ``chip_groups(devices, group_size)``:
    the port's stand-in for the reference's one-axis group mesh."""
    return chip_groups(devices, group_size)[group_index]
