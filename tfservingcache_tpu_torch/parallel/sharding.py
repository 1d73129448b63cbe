"""Partition rules over a device group (counterpart of
``tfservingcache_tpu/parallel/sharding.py``).

A family declares path-regex -> axes rules (Megatron tensor parallelism in
``models/transformer_lm.py``): one entry per dimension of the leaf, a mesh
axis name or None. The reference turns them into ``NamedSharding``s and lets
XLA insert the collectives; the port has no compiler to do that, so the
rules only decide where each slice of a weight lives, and a family's
tensor-parallel module (``TensorParallelLM``) does the collectives itself.

A group is the tuple of ``torch.device`` that one process drives
(``parallel/mesh.py``); its axis sizes are ``{"model": len(group)}``. Leaves
are named by their ``registry.flatten_params`` paths (``layers/0/attn/wq``,
the reference's ``_path_str``). Specs are plain tuples (the reference's
``PartitionSpec`` entries). Rules name an axis the group may lack: such an
entry, and one on an axis of size 1, degrades to None, so one rule set
serves a single device and any group.

A group that spans processes (``parallel/mesh.py``) keeps all P members in
order, so specs and cut sizes are the one-process group's; each process
reads the whole artifact and keeps only its own members' slices (the
reference's multi-process ``shard_params`` through
``make_array_from_callback``, :55-73): a slice or copy placed on another
process's member is a meta tensor, which holds no memory.
``is_single_process`` has no counterpart (``mesh.spans_processes``).

The KV cache of a tensor-parallel model, dense or paged, is cut over its
KV-head axis (dimension 2 of every buffer, ``KV_HEAD_DIM``) where the
group's size divides the head count (``kv_arena_spec``), so that each shard
holds the K/V rows of the heads its slice of ``wk``/``wv`` computes; an int8
arena's scales are cut with the payload (``kv_arena_shardings``).
``shard_kv_arena`` places a cache dict on a group: a cut buffer becomes a
``KVShards``, one contiguous tensor of its own on each device (the paged
kernels take no strided view), an uncut one stays one tensor on the leader.
The page bookkeeping (free lists, refcounts, the prefix index) counts pages
on the host and never needs a gather across shards.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

from tfservingcache_tpu_torch.models.registry import flatten_params, unflatten_params
from tfservingcache_tpu_torch.parallel.mesh import group_axes, is_remote, local_lead

Spec = tuple  # one mesh axis name (or None) per dimension of a leaf


def spec_for(path: str, rules: Mapping[str, Spec], axes: Mapping[str, int]) -> Spec:
    """The spec of the leaf at ``path`` (reference :32): the first rule whose
    pattern ``re.fullmatch``es the path wins; an axis that ``axes`` lacks or
    holds at size 1 becomes None; a path no rule matches is replicated
    (``()``)."""
    for pattern, spec in rules.items():
        if re.fullmatch(pattern, path):
            return tuple(
                axis if (axis is None or axes.get(axis, 1) > 1) else None for axis in spec
            )
    return ()


def param_specs(params: Any, rules: Mapping[str, Spec], axes: Mapping[str, int]) -> dict[str, Spec]:
    """``{path: spec}`` for every leaf of ``params``, in ``flatten_params``
    order (the counterpart of ``param_shardings``, reference :45)."""
    return {path: spec_for(path, rules, axes) for path, _leaf in flatten_params(params)}


def sharded_dim(spec: Spec, axes: Mapping[str, int]) -> tuple[int, int] | None:
    """-> (the dimension ``spec`` cuts, into how many slices), or None for a
    replicated leaf. The port cuts a leaf along one dimension at most."""
    cut = [(dim, axes[axis]) for dim, axis in enumerate(spec)
           if axis is not None and axes.get(axis, 1) > 1]
    if len(cut) > 1:
        raise ValueError(f"spec {spec} cuts {len(cut)} dimensions; the port cuts one")
    return cut[0] if cut else None


@dataclass
class ShardedLeaf:
    """One leaf placed on a group: ``shards[i]`` lives on ``group[i]``. A
    replicated leaf's shards are one tensor per distinct device (the same
    object wherever a device repeats); a cut leaf's are its contiguous
    slices along ``dim`` in order. ``numel``/``element_size`` are the
    global array's, so ``tree_nbytes`` of a sharded tree counts each leaf
    once, as the reference's ``tree_nbytes`` of its global arrays."""

    spec: Spec
    dim: int | None
    shape: tuple[int, ...]
    shards: tuple[torch.Tensor, ...]

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.shards[0].element_size()


def shard_leaf(leaf: torch.Tensor, spec: Spec, group: Sequence[torch.device]) -> ShardedLeaf:
    """Place ``leaf`` on ``group`` by ``spec``. A cut dimension must divide
    by the group's size. Each slice is a contiguous tensor of its own on its
    device, the one on ``leaf``'s device too, where a view would be strided
    (a column cut of a row-major weight): the layout the sharded packed
    transfer lands, and ``leaf`` can be freed once it is cut. A replicated
    leaf is ``leaf`` itself on its own device and one copy on each other
    device."""
    devs = [torch.device(d) for d in group]
    axes = group_axes(devs)
    cut = sharded_dim(spec, axes)
    one_device = len(set(devs)) == 1
    if cut is None:
        placed: dict[torch.device, torch.Tensor] = {}
        for dev in devs:
            if dev not in placed:
                placed[dev] = leaf.to(dev, copy=not one_device and dev != leaf.device)
        return ShardedLeaf(spec, None, tuple(leaf.shape), tuple(placed[d] for d in devs))
    dim, n = cut
    if leaf.shape[dim] % n:
        raise ValueError(f"dimension {dim} of a {tuple(leaf.shape)} leaf does not divide "
                         f"into {n} shards")
    size = leaf.shape[dim] // n
    shards = tuple(torch.empty(part.shape, dtype=part.dtype, device=dev).copy_(part)
                   for dev, part in ((dev, leaf.narrow(dim, i * size, size))
                                     for i, dev in enumerate(devs)))
    return ShardedLeaf(spec, dim, tuple(leaf.shape), shards)


def shard_params(params: Any, rules: Mapping[str, Spec], group: Sequence[torch.device]) -> Any:
    """The tree with every leaf a ``ShardedLeaf`` on ``group`` (reference
    :55, its single-process branch): a leaf whose spec puts an axis on
    ``"model"`` is cut into ``len(group)`` contiguous slices along that
    axis, slice i on ``group[i]``; any other leaf goes to every device of
    the group."""
    axes = group_axes(group)
    pairs = flatten_params(params)
    return unflatten_params(
        [path for path, _leaf in pairs],
        [shard_leaf(leaf, spec_for(path, rules, axes), group) for path, leaf in pairs])


def gather_leaf(leaf: ShardedLeaf) -> torch.Tensor:
    """The whole array of a placed leaf on the group's leader: a cut leaf's
    shards concatenated on their dimension in shard order, a replicated
    leaf's leader copy (the host tier's demotion of a tensor-parallel
    model)."""
    if leaf.dim is None:
        return leaf.shards[0]
    lead = leaf.shards[0].device
    return torch.cat([t.to(lead, non_blocking=True) for t in leaf.shards], dim=leaf.dim)


def kv_arena_spec(axes: Mapping[str, int], n_kv: int, axis: str = "model") -> Spec:
    """The spec of a KV cache or arena (reference :88), whose KV-head axis is
    dimension 2 in both the dense slot array and the paged arena: that axis
    cut over ``axis`` when the group has it at a size above 1 that divides
    ``n_kv`` (each shard holds ``n_kv / size`` heads' pages, as the Megatron
    split of wk/wv puts a lane's K/V on the shard that computed it);
    replicated otherwise: indivisible head counts degrade rather than
    fail."""
    size = axes.get(axis, 1)
    if size > 1 and n_kv % size == 0:
        return (None, None, axis, None, None)
    return ()


# the KV-head axis of a dense cache (layers, B, n_kv, L, hd), a paged arena
# (layers, pages, n_kv, pt, hd) and an int8 arena's scales (layers, pages,
# n_kv, pt) alike (reference :83)
KV_HEAD_DIM = 2


class KVShards:
    """One KV buffer (a cache's ``k``, ``v``, ``k_scale`` or ``v_scale``) cut
    over the KV-head axis: ``shards[i]`` holds the i-th block of heads,
    contiguous, on the group's i-th device. ``shape`` and ``dtype`` are the
    one-device buffer's, ``device`` the leader's, and ``nbytes`` the sum of
    the shards' bytes: what the group really allocated (reference
    ``model_runtime.py:2188-2205``)."""

    def __init__(self, shards: Sequence[torch.Tensor]) -> None:
        self.shards = tuple(shards)

    @property
    def shape(self) -> torch.Size:
        shape = list(self.shards[0].shape)
        shape[KV_HEAD_DIM] = sum(t.shape[KV_HEAD_DIM] for t in self.shards)
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The leader's device: the first shard this process holds."""
        return next((t.device for t in self.shards if not is_remote(t.device)),
                    self.shards[0].device)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.shards)

    def gather(self) -> torch.Tensor:
        """The one-device buffer on the leader: the shards concatenated on
        the head axis in shard order."""
        lead = self.device
        return torch.cat([t.to(lead, non_blocking=True) for t in self.shards], dim=KV_HEAD_DIM)


def kv_shards(buf: torch.Tensor | KVShards) -> tuple[torch.Tensor, ...]:
    """The per-device tensors of a KV buffer: a ``KVShards``'s shards, or the
    one tensor of an uncut buffer."""
    return buf.shards if isinstance(buf, KVShards) else (buf,)


def like_kv(buf: torch.Tensor | KVShards,
            parts: Sequence[torch.Tensor]) -> torch.Tensor | KVShards:
    """``parts`` (one tensor per shard of ``buf``) in ``buf``'s kind."""
    return KVShards(parts) if isinstance(buf, KVShards) else parts[0]


def kv_arena_shardings(axes: Mapping[str, int], cache: Mapping[str, Any],
                       axis: str = "model") -> dict[str, Spec]:
    """The spec of each buffer of an ``init_cache``/``init_paged_cache`` dict
    (reference :100): ``k``/``v`` by ``kv_arena_spec``, an int8 arena's
    ``k_scale``/``v_scale`` cut over the same axis (their dimension 2)
    whenever the payload is, replicated otherwise."""
    spec = kv_arena_spec(axes, int(cache["k"].shape[KV_HEAD_DIM]), axis)
    scale = (None, None, axis) if axis in spec else ()
    return {name: spec if name in ("k", "v") else scale for name in cache}


def _placed(buf: torch.Tensor, shape: tuple[int, ...], dev: torch.device,
            part: torch.Tensor | None) -> torch.Tensor:
    """A contiguous tensor of its own on ``dev``: zeros for a buffer on the
    meta device, else a copy of ``part``."""
    if buf.is_meta:
        return torch.zeros(shape, dtype=buf.dtype, device=dev)
    return torch.empty(shape, dtype=buf.dtype, device=dev).copy_(part)


def shard_kv_arena(cache: Mapping[str, torch.Tensor], group: Sequence[torch.device],
                   axis: str = "model") -> dict[str, torch.Tensor | KVShards]:
    """Place a KV cache dict on ``group`` by ``kv_arena_shardings`` (reference
    :121): a cut buffer becomes a ``KVShards`` whose i-th shard holds heads
    ``i * n/P .. (i+1) * n/P`` on ``group[i]``, each allocated contiguous on
    its own device, on a group that repeats one device too; an uncut buffer
    is one tensor on the leader (this process's first member). A buffer on
    the meta device only gives its shape and dtype: the placed tensors are
    zeros, and nothing of the whole buffer is ever allocated (how
    ``init_cache``/``init_paged_cache`` build a group's cache). A member
    another process owns gets a meta tensor."""
    devs = tuple(torch.device(d) for d in group)
    axes = group_axes(devs)
    specs = kv_arena_shardings(axes, cache, axis)
    out: dict[str, torch.Tensor | KVShards] = {}
    for name, buf in cache.items():
        cut = sharded_dim(specs[name], axes)
        if cut is None:
            out[name] = _placed(buf, tuple(buf.shape), local_lead(devs), buf)
            continue
        dim, n = cut
        size = buf.shape[dim] // n
        shape = tuple(size if d == dim else s for d, s in enumerate(buf.shape))
        out[name] = KVShards([
            _placed(buf, shape, dev, None if buf.is_meta else buf.narrow(dim, i * size, size))
            for i, dev in enumerate(devs)])
    return out


def batch_sharding(axes: Mapping[str, int], axis: str = "data") -> Spec:
    """The spec of a batch-major array (reference :134): its leading axis
    over ``axis`` where the group has it above size 1, replicated
    otherwise. A port group has only ``"model"``, so a batch replicates."""
    return (axis,) if axes.get(axis, 1) > 1 else ()


def replicated(axes: Mapping[str, int]) -> Spec:
    """The spec of a replicated array (reference :140)."""
    return ()
