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

``is_single_process`` has no counterpart: a port group is one process by
construction (cross-process groups are a later slice). The KV-arena and
batch helpers of the reference (``kv_arena_shardings``, ``shard_kv_arena``,
``batch_sharding``, ``replicated``) wait for the sharded arena;
``kv_arena_spec`` is here already, a pure function of the axis sizes.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

from tfservingcache_tpu_torch.models.registry import flatten_params, unflatten_params
from tfservingcache_tpu_torch.parallel.mesh import group_axes

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
    by the group's size. Where every member of the group is one device (a
    group of one card, the CPU tests' groups) the slices are views of
    ``leaf``; on a group of distinct devices each slice is a copy of its
    own, the one on ``leaf``'s device too, so that the whole leaf can be
    freed once it is placed. A replicated leaf is ``leaf`` itself on its own
    device and one copy on each other device."""
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
    shards = tuple(leaf.narrow(dim, i * size, size).to(dev, copy=not one_device)
                   for i, dev in enumerate(devs))
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
