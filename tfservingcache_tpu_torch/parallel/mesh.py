"""Device groups (counterpart of ``tfservingcache_tpu/parallel/mesh.py``).

A model too large for one device is served by a *group* of devices. In the
port a group is a tuple of ``torch.device`` that one process drives; it may
name a device more than once, and its members then run one after another on
that device (the CPU tests' virtual groups, and a ring or a tensor-parallel
model on one card). Its axis sizes are one ``"model"`` axis of the group's
size (``group_axes``): partition rules (``parallel/sharding.py``) cut
weights over it for tensor parallelism, a ``"ring"`` model splits its
sequence over it. ``make_mesh``/``compat_shard_map`` have no counterpart:
nothing here compiles a program over a mesh; the modules that run on a
group move their tensors between its devices themselves.

A group may span processes (``parallel/multihost.py``): P members, of which
each of ``num_processes`` processes owns a contiguous block of
``P / num_processes``. Each process holds the whole tuple, in member order,
so that partition specs and cut sizes are the one-process group's; a member
another process owns is a ``torch.device("meta")`` placeholder
(``cross_process_group``), and every tensor placed on it is a meta tensor,
which holds no memory. The modules run only their own members
(``local_members``), the replicated parts on ``local_lead``, and the
partials of all members meet through ``gather_members``, a
``torch.distributed`` all-gather over the default process group (gloo: on a
card the partials are staged through page-locked host memory).
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

# a member another process owns
REMOTE = torch.device("meta")

# host seconds and bytes spent in gather_members since the last reset
# (chip_smoke reads the collective's share of a forward from it)
GATHER_STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}


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


def group_axes(group: Sequence[str | torch.device]) -> dict[str, int]:
    """The axis sizes of a group of P devices: ``{"model": P}`` (the
    reference's one-axis group mesh ``group_mesh`` builds)."""
    return {"model": len(group)}


def is_remote(dev: torch.device) -> bool:
    """Is ``dev`` a member another process owns (a meta placeholder)?"""
    return dev.type == "meta"


def cross_process_group(local: Sequence[str | torch.device], num_processes: int,
                        process_id: int) -> tuple[torch.device, ...]:
    """The whole group of a process that owns ``local`` (L members) of a
    group spanning ``num_processes`` processes of L members each: process r
    owns members ``r * L .. (r + 1) * L - 1``, every other member is a
    ``REMOTE`` placeholder."""
    own = [torch.device(d) for d in local]
    if not own or any(is_remote(d) for d in own):
        raise ValueError("a process owns at least one real member of its group")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside 0..{num_processes - 1}")
    n = len(own)
    return ((REMOTE,) * (process_id * n) + tuple(own)
            + (REMOTE,) * ((num_processes - process_id - 1) * n))


def spans_processes(group: Sequence[torch.device] | None) -> bool:
    """Does ``group`` have members that another process owns?"""
    return group is not None and any(is_remote(torch.device(d)) for d in group)


def local_members(group: Sequence[torch.device]) -> list[int]:
    """The indexes of the members this process owns, in member order."""
    return [i for i, d in enumerate(group) if not is_remote(torch.device(d))]


def local_lead(group: Sequence[torch.device]) -> torch.device:
    """The first member this process owns: where it keeps the replicated
    stream, the norms and the halves a group does not cut (``group[0]`` in
    a one-process group)."""
    for d in group:
        if not is_remote(torch.device(d)):
            return torch.device(d)
    raise ValueError("this process owns no member of the group")


def gather_members(parts: Sequence[torch.Tensor],
                   group: Sequence[torch.device]) -> list[torch.Tensor]:
    """Every member's tensor, in member order, f32, on ``parts[0]``'s device:
    ``parts`` are this process's members' tensors (one shape), the others
    come from the other processes through one ``all_gather`` over the
    default ``torch.distributed`` process group, whose rank r owns the r-th
    block of members. The f32 copy of a bf16 value is exact, so a sum in
    member order afterwards is the one-process group's sum bit for bit. A
    CUDA tensor is staged through page-locked host memory (gloo gathers host
    tensors)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if len(group) != world * len(parts):
        raise ValueError(f"{len(parts)} local members of a {len(group)}-member group over "
                         f"{world} processes")
    dev = parts[0].device
    local = torch.stack([p.float() for p in parts])
    on_card = dev.type == "cuda"
    if on_card:
        host = torch.empty(local.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(local, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    else:
        host = local.contiguous()
    t0 = time.perf_counter()
    out = torch.empty((world, *host.shape), dtype=torch.float32, pin_memory=on_card)
    dist.all_gather(list(out.unbind(0)), host)
    full = out.reshape(len(group), *host.shape[1:])
    if on_card:
        full = full.to(dev, non_blocking=True)
    GATHER_STATS["calls"] += 1
    GATHER_STATS["bytes"] += out.nbytes
    GATHER_STATS["seconds"] += time.perf_counter() - t0
    return list(full.unbind(0))
