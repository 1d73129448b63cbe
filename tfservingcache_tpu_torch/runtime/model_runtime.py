"""The PyTorch model runtime: artifact -> pinned host tensors -> GPU module.

Counterpart of ``tfservingcache_tpu/runtime/model_runtime.py`` for the
``:predict`` and ``:generate`` paths: the solo ``generate`` (greedy
speculative with ``draft_model_id``; B = 1 requests through the prefix KV
cache with ``serving.prefix_cache_bytes``) and the slot surface the
continuous engine (``runtime/batcher.py``) drives, over a dense slot array
or a paged KV arena (``SlotDecodeState``), with an optional draft state for
speculative rounds (``slot_attach_draft`` / ``slot_decode_spec_round``), a
radix prefix index whose pages lanes share read-only
(``serving.kv_share_prefix_bytes``: ``shared_prefix_plan``,
``slot_prefill_shared``, ``slot_cow``, ``shared_prefix_publish``,
``reclaim_prefix_pages``), chunked prefill into a lane's pages
(``slot_prefill_chunk`` / ``sample_first_token``) and conversation parking
(``park_lane``, ``plan_conversation_resume``, ``slot_resume_prefill``).
A cold load (``serving.cold_load_pipeline``, reference :95-:420, :1100-
:1465) maps ``params.bin``, packs the leaves into ~256 MiB page-locked
chunks on an assembler thread while earlier chunks copy to the device on a
copy stream, and wraps the leaves (views into their device chunk) in the
family's ``nn.Module``; with the knob off it reads the file into page-locked
memory and copies every leaf out of it. Resident models live in a
byte-budgeted LRU (capped at ``serving.max_concurrent_models``) whose
eviction drops the module so its device memory is freed, and, with
``cache.host_tier_bytes``, leaves the model's packed chunks in the host RAM
tier (``cache/host_tier.py``), from which the next load promotes it. An int8
artifact is read raw (reference :1268): its int8 weights and f32 scales cross
the link, and each weight is dequantized on the device with plain torch ops
(``_dequantize_on_device``) after the serialized copy, or as both of its
halves land on the pipelined copy and on a promotion; the host tier keeps the
int8 chunks. Variable request shapes are padded to
power-of-two buckets per named axis, as in the reference, so each model sees
O(log) distinct shapes.

The runtime runs on ``cuda`` unless constructed with ``device="cpu"``; with
no card and no explicit device it raises. Forwards run eagerly under
``torch.inference_mode()``.

A runtime constructed with ``devices=[...]`` is bound to that device group
(the reference's runtime on a chip-group mesh). ``devices[0]`` is the
leader. A family with a ``bind_group`` factory (a ``"ring"``
transformer_lm) loads onto the leader as one device does and builds its
module bound to the group, so that each forward splits attention's sequence
over the group's devices. The reference replicates a ring model's weights
on every chip of the group (partition rule ``{".*": ()}``) and computes the
projections redundantly on each; the port computes them once on the leader
and shards only attention, with the same output; its ``:generate`` runs on
the leader, as the reference's generation never rings. A family whose
partition rules cut weights over ``"model"`` (transformer_lm, moe_lm, bert,
t5) is tensor parallel on a group of more than one device through its
``tensor_parallel`` plan: an int8 artifact is expanded on the host first
(``_dequantize_on_host``, a ``host_dequant`` stage), then each device gets
its own shard bytes through the pipelined ``packed_device_put_sharded``
(with ``cold_load_pipeline`` off, ``packed_device_put_group`` copies each
leaf to the leader and cuts it there); both land contiguous shards, so the
two loads give the same module. The load span says which halves are cut
(``tp_attn``, ``tp_mlp``, ``tp_embed``) and the resident bytes stay the
tree's logical bytes. The group keeps a host tier (whole leaves, replayed
through the sharded transfer by ``_promote``) and promotes adopted peer
entries the same way. ``serving.mesh_fast_path: false`` makes the group
lockstep (``mesh_lockstep``): serialized loads, no tier, adopted entries
dropped, ``:generate`` on the solo path. A group that spans processes
(``parallel/mesh.py``: members another process owns are meta placeholders,
``devices[0]`` may be one) is always lockstep; ``self.device`` is this
process's first member, every process loads the whole artifact and keeps
its own members' shards, and the leader process's
``parallel.multihost.MultiHostGroupRuntime`` has every other process replay
each op (bert, t5 and ring models refuse such a group). ``:generate`` and
the slot surface serve a tensor-parallel LM on the group: its KV cache,
dense or paged, is cut over the KV-head axis where the group divides it
(``parallel.sharding.shard_kv_arena``), else whole on the leader, and each
shard's cached forward runs the paged kernels on its own heads (the
reference turns its Pallas kernel off on a mesh, model_runtime.py:2102; the
port's shards are whole local tensors, so ``serving.kv_paged_kernel`` keeps
its one-card meaning). The page bookkeeping stays on the host, the host
mirrors and sampling on the leader. ``mesh_topology`` stamps the group on
``/monitoring/engine``.

Observability (reference :1129-1436, :1733, :3404-3427): a load runs under a
``load`` span (``tier`` disk or host) with the reference's stage children
(``artifact_read``, ``device_dequant`` for an int8 artifact only, or
``host_dequant`` before a tensor-parallel group's transfer,
``device_transfer``, ``transfer_sync``, ``compile_warmup`` for the warm-up
forward), which feed
``tpusc_cold_stage_seconds{stage}`` and ``tpusc_cold_overlap_ratio``; a predict under
``infer`` and a solo generate under ``generate``; loads and evictions
re-stamp ``tpusc_hbm_bytes_in_use{group}`` (``torch.cuda.memory_allocated``
on a card, the resident parameter bytes on the CPU), its ``_peak`` twin
through the flight recorder's watermark, ``tpusc_models_resident`` and the
tenant ledger's device levels. The prefix cache, the arena's size and the
speculative acceptance feed their families.
"""

from __future__ import annotations

import collections
import logging
import math
import mmap
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from tfservingcache_tpu_torch.cache.conversation_kv import (
    ParkedConversation,
    device_pages,
    host_pages,
)
from tfservingcache_tpu_torch.cache.host_tier import HostRamTier, PackedModelEntry
from tfservingcache_tpu_torch.cache.lru import LRUEntry
from tfservingcache_tpu_torch.config import ServingConfig
from tfservingcache_tpu_torch.models.registry import (
    ModelDef,
    QuantLeaf,
    TensorParallelPlan,
    TensorSpec,
    flatten_params,
    load_artifact,
    torch_dtype,
    unflatten_params,
)
from tfservingcache_tpu_torch.native import make_lru_cache
from tfservingcache_tpu_torch.parallel.mesh import (
    group_axes,
    is_remote,
    local_lead,
    spans_processes,
)
from tfservingcache_tpu_torch.parallel.sharding import (
    KVShards,
    ShardedLeaf,
    gather_leaf,
    kv_shards,
    like_kv,
    shard_leaf,
    sharded_dim,
    spec_for,
)
from tfservingcache_tpu_torch.runtime.base import (
    BaseRuntime,
    ModelNotLoadedError,
    RuntimeError_,
)
from tfservingcache_tpu_torch.runtime.prefix_cache import (
    PagePrefixIndex,
    PrefixCache,
    PrefixEntry,
    SharedPrefixPlan,
)
from tfservingcache_tpu_torch.types import Model, ModelId, ModelState
from tfservingcache_tpu_torch.utils.accounting import LEDGER
from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER
from tfservingcache_tpu_torch.utils.tracing import TRACER

log = logging.getLogger("tpusc_torch.runtime")

# Speculative-decoding health gate (reference :56-65): at acceptance ~0 every
# verify round still pays spec_tokens draft forwards + one chunked target
# forward to emit ONE token — more target work per token than plain decode.
# Below this tokens-per-round a sustained run of generates disables the
# (target, draft) pair; disabled pairs re-audition periodically.
SPEC_MIN_TOKENS_PER_ROUND = 1.5
SPEC_DISABLE_AFTER = 8      # consecutive low-acceptance generates
SPEC_REPROBE_EVERY = 64     # every Nth gated request runs the draft again
SPEC_TOKENS_MAX = 8         # spec_tokens clamps to a power of two <= this


def next_bucket(n: int) -> int:
    """Smallest power of two >= n (padding bucket)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_nbytes(tree: Any) -> int:
    """The leaves' bytes, each leaf counted by its own elements: leaves that
    are views into one chunk (a pipelined load's) add up to the chunk's
    bytes once, the reference's ``tree_nbytes`` of the same artifact."""
    total = 0

    def add(t: torch.Tensor) -> None:
        nonlocal total
        total += t.numel() * t.element_size()

    _tree_map(add, tree)
    return total


# -- packed transfer (reference :95-:420) ------------------------------------

_PACK_CHUNK_BYTES = 256 << 20


def _leaf_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pack_plan(arrs: list[torch.Tensor]) -> list[list[int]]:
    """Deterministic transfer plan (reference :98): flat indices grouped per
    dtype in order of first appearance, each group cut into chunks that
    close once they reach ``_PACK_CHUNK_BYTES`` (a chunk ends with the leaf
    that crosses the bound). The pipelined load, the host tier's entries
    and the promotion all follow it, so the copies a load issues are a pure
    function of the artifact."""
    groups: dict[torch.dtype, list[int]] = {}
    for i, a in enumerate(arrs):
        groups.setdefault(a.dtype, []).append(i)
    chunks: list[list[int]] = []
    for idxs in groups.values():
        chunk: list[int] = []
        chunk_bytes = 0
        for i in idxs:
            chunk.append(i)
            chunk_bytes += _leaf_nbytes(arrs[i])
            if chunk_bytes >= _PACK_CHUNK_BYTES:
                chunks.append(chunk)
                chunk, chunk_bytes = [], 0
        if chunk:
            chunks.append(chunk)
    return chunks


def _flatten_for_pack(host_params: Any):
    """-> (outer leaves, treedef, flat tensors, owner map) (reference :154):
    the one flatten shared by the pipelined transfer and
    ``build_packed_entry``. ``treedef`` is the leaves' paths (``registry.flatten_params``
    order, the reference's pytree order). A ``QuantLeaf`` stays one outer
    leaf and adds two flat tensors, of roles ``q`` and ``scale``; every
    other outer leaf is one flat tensor of role ``plain``."""
    pairs = flatten_params(host_params)
    outer = [leaf for _path, leaf in pairs]
    arrs: list[torch.Tensor] = []
    owner: list[tuple[int, str]] = []  # flat idx -> (outer idx, plain | q | scale)
    for oi, leaf in enumerate(outer):
        if isinstance(leaf, QuantLeaf):
            arrs += [torch.as_tensor(leaf.q), torch.as_tensor(leaf.scale)]
            owner += [(oi, "q"), (oi, "scale")]
        else:
            arrs.append(leaf)
            owner.append((oi, "plain"))
    return outer, [path for path, _leaf in pairs], arrs, owner


def _dequantize_on_device(params: Any) -> Any:
    """Expand every ``QuantLeaf`` (int8 ``q`` and f32 ``scale``, already on
    the device) into ``orig_dtype`` there (reference :475): ``(q as f32 *
    scale)`` cast once, plain torch ops on the tensors' device, the
    reference's jitted ``_dequant_fn``. Each leaf drops its ``q`` and
    ``scale`` as its output is made, so the transient memory stays about
    one leaf above the params."""

    def leaf(x: Any) -> Any:
        if not isinstance(x, QuantLeaf):
            return x
        out = (x.q.to(torch.float32) * x.scale).to(torch_dtype(x.orig_dtype))
        x.q = x.scale = None
        return out

    return _tree_map(leaf, params)


def _has_quant(params: Any) -> bool:
    return any(isinstance(leaf, QuantLeaf) for _path, leaf in flatten_params(params))


def _to_device(params: Any, device: torch.device, **kw: Any) -> Any:
    """``Tensor.to`` over a params tree; a ``QuantLeaf`` moves as its two
    tensors, still quantized."""

    def move(x: Any) -> Any:
        if isinstance(x, QuantLeaf):
            return QuantLeaf(x.q.to(device, **kw), x.scale.to(device, **kw), x.orig_dtype)
        return x.to(device, **kw)

    return _tree_map(move, params)


class _QuantLanding:
    """The pipelined transfer's and the promotion's int8 bookkeeping
    (reference :400-439, :581-605): a quantized leaf's ``q`` and ``scale``
    land in different chunks (the int8 and the f32 group), and the leaf is
    dequantized on the device as soon as both have landed. On a card the
    dequant runs on the current stream, which first waits for the copies
    (on the copy stream) that wrote its two halves. ``seconds`` sums the
    dispatch time of the dequants."""

    def __init__(self, orig_dtypes: Mapping[int, str], device: torch.device) -> None:
        self.orig_dtypes = orig_dtypes
        self.device = device
        self.landed: dict[int, dict[str, tuple[torch.Tensor, Any]]] = {}
        self.seconds = 0.0

    def land(self, oi: int, role: str, view: torch.Tensor, ev: Any) -> torch.Tensor | None:
        """-> the dequantized leaf once both halves are in, else None."""
        got = self.landed.setdefault(oi, {})
        got[role] = (view, ev)
        if len(got) < 2:
            return None
        del self.landed[oi]
        t0 = time.monotonic()
        for _view, event in got.values():
            if event is not None:
                torch.cuda.current_stream(self.device).wait_event(event)
        (q, _), (scale, _) = got["q"], got["scale"]
        del got
        out = _dequantize_on_device(QuantLeaf(q, scale, self.orig_dtypes[oi]))
        self.seconds += time.monotonic() - t0
        return out


_PAGE = mmap.PAGESIZE  # cudaHostRegister locks whole pages
_locked_guard = threading.Lock()
_locked = {"bytes": 0, "peak": 0}  # guarded-by: _locked_guard


def locked_chunk_bytes(reset_peak: bool = False) -> tuple[int, int]:
    """-> (bytes the host tier's chunks hold page-locked now, the most since
    the last reset): ``cudaHostRegister`` memory, which
    ``torch.cuda.host_memory_stats`` (the caching host allocator's) does
    not count."""
    with _locked_guard:
        got = (_locked["bytes"], _locked["peak"])
        if reset_peak:
            _locked["peak"] = _locked["bytes"]
    return got


def _count_locked(nbytes: int) -> None:
    with _locked_guard:
        _locked["bytes"] += nbytes
        _locked["peak"] = max(_locked["peak"], _locked["bytes"])


def _unlock(cudart: Any, ptr: int, nbytes: int) -> None:
    cudart.cudaHostUnregister(ptr)
    _count_locked(-nbytes)


def _page_exclusive_empty(numel: int, dtype: torch.dtype) -> tuple[torch.Tensor, int]:
    """-> (a 1-D tensor of ``numel`` elements that starts on a page, the
    bytes of the whole pages it spans). Those pages lie inside this one
    allocation, so no other tensor's memory shares them: a page that an
    earlier ``cudaHostRegister`` locked for another chunk would make this
    chunk's lock fail."""
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    span = -(-nbytes // _PAGE) * _PAGE
    raw = torch.empty(span + _PAGE, dtype=torch.uint8)
    off = -raw.data_ptr() % _PAGE
    return raw[off:off + nbytes].view(dtype), span


def _page_lock(buf: torch.Tensor, span: int) -> None:
    """Page-lock the ``span`` bytes of whole pages from ``buf``'s first
    element (``_page_exclusive_empty``), a chunk the host tier keeps; the
    lock goes with the tensor object.
    ``torch.empty(pin_memory=True)`` takes blocks from PyTorch's caching host
    allocator, which rounds each up to a power of two (a ~270 MB chunk would
    lock 512 MiB). Locking pages a fill has already touched took ~1.1 s for
    7 x 270 MiB against ~1.6 s for fresh ones (tools/pinned_chunk_bench.py
    on the host of an H100 80GB HBM3 at 700 W), so a chunk is filled
    first."""
    cudart = torch.cuda.cudart()
    ptr = buf.data_ptr()
    err = int(cudart.cudaHostRegister(ptr, span, 0))
    if err:
        raise RuntimeError(f"cudaHostRegister of a {span}-byte chunk: cudaError {err}")
    _count_locked(span)
    weakref.finalize(buf, _unlock, cudart, ptr, span)


def _packed_chunk(arrs: list[torch.Tensor], chunk: list[int], pin: bool) -> torch.Tensor:
    """An owned 1-D host tensor holding the chunk's leaves, page-locked with
    ``pin``: what the host tier keeps."""
    numel, dtype = sum(arrs[i].numel() for i in chunk), arrs[chunk[0]].dtype
    if not (pin and numel):
        buf = torch.empty(numel, dtype=dtype)
        _fill_chunk(buf, arrs, chunk)
        return buf
    buf, span = _page_exclusive_empty(numel, dtype)
    _fill_chunk(buf, arrs, chunk)
    _page_lock(buf, span)
    return buf


def _fill_chunk(buf: torch.Tensor, arrs: list[torch.Tensor], chunk: list[int]) -> None:
    """Copy the chunk's leaves, flattened, into ``buf`` back to back."""
    off = 0
    for i in chunk:
        n = arrs[i].numel()
        buf[off:off + n].copy_(arrs[i].reshape(-1))
        off += n


def _chunk_views(dev: torch.Tensor, chunk: list[int],
                 shapes: list[tuple[int, ...]]) -> list[torch.Tensor]:
    """The chunk's leaves as views into its device buffer: the split costs
    no copy and no second buffer."""
    views = []
    off = 0
    for i in chunk:
        n = math.prod(shapes[i])
        views.append(dev[off:off + n].view(shapes[i]))
        off += n
    return views


class _ChunkCopier:
    """The device half of a packed transfer. Each chunk lands in a fresh
    device buffer through ``copy_(..., non_blocking=True)`` on a dedicated
    copy stream, ordered after the work the current stream holds when the
    buffer is taken, so the copies queue behind each other while the calling
    thread goes on; ``land`` returns the copy's event (what gates the reuse
    of a staging buffer) and ``finish`` makes the device's current stream
    wait for the last copy, returning the event to sync on. On the CPU a
    copy is a plain ``copy_`` and there are no events."""

    def __init__(self, device: torch.device, stream: Any = None) -> None:
        self.device = device
        self.stream = stream  # torch.cuda.Stream on a card

    def land(self, buf: torch.Tensor) -> tuple[torch.Tensor, Any]:
        dev = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
        if self.stream is None:
            dev.copy_(buf)
            return dev, None
        # the block comes from the current stream's pool, which every
        # serving thread shares: another thread's forward may have freed it
        # with kernels that read it still queued there, so the copy waits
        # for what that stream holds now
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            dev.copy_(buf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        # allocated on the current stream, written on the copy stream: a
        # load that fails midway must not free it into another allocation
        # before the copy is done
        dev.record_stream(self.stream)
        return dev, ev

    def drain(self) -> None:
        """Wait for every copy issued so far (a failed transfer, before its
        host buffers go)."""
        if self.stream is not None:
            self.stream.synchronize()

    def finish(self) -> Any:
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(ev)
        return ev


def packed_device_put(host_params: Any, device: torch.device) -> Any:
    """The serialized transfer (reference :121; the load path with
    ``cold_load_pipeline: false``): every leaf copied with
    ``.to(device, non_blocking=True)`` out of the artifact's one page-locked
    buffer, the copies queued on the current stream, one sync at the end.
    The reference packs leaves per dtype because each ``jax.device_put``
    pays a round trip; here the leaves already sit in one pinned buffer,
    and async copies out of it queue back to back. A ``QuantLeaf`` ships
    its int8 and scale bytes and lands still quantized: the caller
    dequantizes it on the device (``_dequantize_on_device``)."""
    params = _to_device(host_params, device, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return params


def _run_pipeline(sizes: list[int], dtypes: list[torch.dtype], fill, land, drain,
                  buffer_depth: int, pin: bool, own=None, workers: set | None = None,
                  name: str = "tpusc-chunk-assembler") -> int:
    """The two threads of a pipelined packed transfer (reference :313) over
    ``len(sizes)`` chunks -> the bytes of staging memory it allocated.

    An assembler thread packs chunk k (``fill(k, buf)``, ``buf`` a 1-D
    tensor of ``dtypes[k]`` holding ``sizes[k]`` bytes) into a staging
    buffer, page-locked with ``pin``, and hands it over through a queue
    bounded at ``buffer_depth``; the calling thread issues its copy with
    ``land(k, buf)`` -> the copy's event, so the assembly of chunk k + 1
    overlaps the copy of chunk k. There are ``buffer_depth`` staging
    buffers, each refilled only after the copy that last read it is done
    (its event). Every copy issues from the calling thread in plan order.
    ``own(k)``, when given, returns an owned buffer holding chunk k that
    takes the staging buffer's place (the host tier keeps it). The
    assembler's every put and take can be abandoned, so a failure on
    either side ends both; ``drain()`` then waits for the copies already
    issued before the error goes up (no copy may still read a buffer the
    caller drops). ``workers``, when given, holds the assembler thread
    while it lives (the runtime's ``close`` joins it)."""
    depth = max(1, buffer_depth)
    done = object()
    q: queue.Queue = queue.Queue(maxsize=depth)
    free: queue.Queue = queue.Queue()  # staging slots the assembler may refill
    stop = threading.Event()
    staging: list[torch.Tensor] = []   # appended by the assembler only
    gates: dict[int, Any] = {}         # slot -> event of the copy that read it last
    if own is None:
        for slot in range(min(depth, len(sizes))):
            free.put(slot)

    def put(item) -> bool:
        # bounded put that can always be abandoned: a failure on the
        # consumer's side sets ``stop`` and the assembler must not block
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def take_slot() -> int | None:
        while not stop.is_set():
            try:
                return free.get(timeout=0.05)
            except queue.Empty:
                continue
        return None

    def assemble() -> None:
        try:
            for k, nbytes in enumerate(sizes):
                if own is not None:
                    slot = None
                    buf = own(k)
                else:
                    slot = take_slot()
                    if slot is None:
                        return
                    if slot == len(staging):
                        staging.append(torch.empty(max(sizes), dtype=torch.uint8,
                                                   pin_memory=pin))
                    gate = gates.pop(slot, None)
                    if gate is not None:
                        gate.synchronize()  # the copy that read it last is done
                    buf = staging[slot][:nbytes].view(dtypes[k])
                    fill(k, buf)
                if not put((k, buf, slot)):
                    return
                del buf
            put(done)
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            put(e)

    worker = threading.Thread(target=assemble, name=name, daemon=True)
    if workers is not None:
        workers.add(worker)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            k, buf, slot = item
            ev = land(k, buf)
            if slot is not None:
                gates[slot] = ev
                free.put(slot)
            del buf
    except BaseException:
        drain()
        raise
    finally:
        stop.set()
        worker.join(timeout=5.0)
        if workers is not None:
            workers.discard(worker)
    return len(staging) * max(sizes, default=0) if pin else 0


def packed_device_put_pipelined(
    host_params: Any,
    copier: _ChunkCopier,
    buffer_depth: int = 2,
    capture: list | None = None,
    workers: set | None = None,
) -> tuple[Any, Any, dict]:
    """Pipelined packed transfer (reference :313) -> (device params, the
    event to sync on or None, stats). The ``_pack_plan`` chunks go through
    ``_run_pipeline``: each chunk's leaves are read from the mapped artifact
    into a staging buffer while the previous chunk copies to the device on
    the copy stream, into a fresh device buffer. Every ``QuantLeaf`` is
    dequantized on the device as soon as both of its halves have landed,
    while later chunks still copy; ``stats["dequant_s"]`` is the seconds
    spent dispatching those dequants.

    ``capture``, when given, collects ``(chunk, buffer)`` pairs for the host
    tier: each chunk is then assembled into a page-locked buffer of its own
    (``_packed_chunk``), which the tier keeps, never into a staging buffer
    that is reused.

    The leaves are views into their chunk's device buffer. Page-locked host
    memory held by the load: the staging buffers (``stats["staging_bytes"]``)
    or the captured chunks, not the artifact."""
    outer, treedef, arrs, owner = _flatten_for_pack(host_params)
    if len(arrs) <= 2:
        # leaf by leaf (reference :350); a copy even on the CPU, where the
        # leaves would otherwise stay views into the mapped artifact
        params = _to_device(host_params, copier.device, copy=True)
        t0 = time.monotonic()
        params = _dequantize_on_device(params)
        return params, None, {"chunks": 0, "bytes": sum(map(_leaf_nbytes, arrs)),
                              "staging_bytes": 0, "dequant_s": time.monotonic() - t0}
    chunks = _pack_plan(arrs)
    shapes = [tuple(a.shape) for a in arrs]
    sizes = [sum(_leaf_nbytes(arrs[i]) for i in chunk) for chunk in chunks]
    pin = copier.stream is not None
    out: list[Any] = [None] * len(outer)
    quant = _QuantLanding({oi: leaf.orig_dtype for oi, leaf in enumerate(outer)
                           if isinstance(leaf, QuantLeaf)}, copier.device)

    def land(k: int, buf: torch.Tensor) -> Any:
        dev, ev = copier.land(buf)
        if capture is not None:
            capture.append((chunks[k], buf))
        for i, view in zip(chunks[k], _chunk_views(dev, chunks[k], shapes)):
            oi, role = owner[i]
            out[oi] = view if role == "plain" else quant.land(oi, role, view, ev)
        return ev

    staging = _run_pipeline(
        sizes, [arrs[chunk[0]].dtype for chunk in chunks],
        lambda k, buf: _fill_chunk(buf, arrs, chunks[k]), land, copier.drain, buffer_depth,
        pin, own=(lambda k: _packed_chunk(arrs, chunks[k], pin)) if capture is not None else None,
        workers=workers)
    stats = {"chunks": len(chunks), "bytes": sum(sizes), "staging_bytes": staging,
             "dequant_s": quant.seconds}
    return unflatten_params(treedef, out), copier.finish(), stats


def _dequantize_on_host(params: Any) -> Any:
    """Every ``QuantLeaf`` expanded on the host (reference :498): the
    tensor-parallel group's loads, whose partition rules name float leaves,
    so a quantized pair expands before the cut. ``dequant_host`` computes
    ``q as f32 * scale`` and casts once, as ``_dequantize_on_device`` does
    on the card, so the two give the same weights."""
    return _tree_map(lambda x: x.dequant_host() if isinstance(x, QuantLeaf) else x, params)


def _shard_chunk_plan(arrs: list[torch.Tensor], cuts: list[tuple[int, int] | None],
                      group: tuple[torch.device, ...]) -> list[tuple[int, list[tuple]]]:
    """The sharded transfer's chunks (reference :180) -> ``[(member,
    [(flat idx, dim, start, size), ...]), ...]``: for each member of the
    group in order, the slice of each flat leaf that lands on it, grouped
    per dtype in order of first appearance and cut into chunks that close
    once they reach ``_PACK_CHUNK_BYTES``, as ``_pack_plan`` cuts a whole
    tree. A cut leaf (``cuts[i] = (dim, parts)``) gives member m its m-th
    block along ``dim``; a replicated leaf (``None``) lands whole on the
    first member of each distinct device and nowhere else (members of a
    group that repeat a device share it). The copies a load issues are a
    pure function of the artifact, the rules and the group."""
    plan: list[tuple[int, list[tuple]]] = []
    seen: set[torch.device] = set()
    for m, dev in enumerate(group):
        first = dev not in seen
        seen.add(dev)
        by_dtype: dict[torch.dtype, list[tuple]] = {}
        for i, (a, cut) in enumerate(zip(arrs, cuts)):
            if cut is None:
                if first:
                    by_dtype.setdefault(a.dtype, []).append((i, None, 0, 0))
                continue
            dim, parts = cut
            size = a.shape[dim] // parts
            by_dtype.setdefault(a.dtype, []).append((i, dim, m * size, size))
        for segs in by_dtype.values():
            chunk: list[tuple] = []
            chunk_bytes = 0
            for seg in segs:
                chunk.append(seg)
                chunk_bytes += _seg_nbytes(arrs, seg)
                if chunk_bytes >= _PACK_CHUNK_BYTES:
                    plan.append((m, chunk))
                    chunk, chunk_bytes = [], 0
            if chunk:
                plan.append((m, chunk))
    return plan


def _seg_view(arrs: list[torch.Tensor], seg: tuple) -> torch.Tensor:
    """The host slice a segment ships: the whole leaf, or its block."""
    i, dim, start, size = seg
    return arrs[i] if dim is None else arrs[i].narrow(dim, start, size)


def _seg_nbytes(arrs: list[torch.Tensor], seg: tuple) -> int:
    return _leaf_nbytes(_seg_view(arrs, seg))


def packed_device_put_sharded(
    host_params: Any,
    rules: Mapping[str, tuple],
    group: tuple[torch.device, ...],
    copiers: Mapping[torch.device, _ChunkCopier],
    buffer_depth: int = 2,
    workers: set | None = None,
) -> tuple[Any, list, dict]:
    """Pipelined packed transfer onto a device group (reference :218) ->
    (the tree of ``ShardedLeaf``s, the events to sync on, stats). Each
    member of the group gets only its own shard bytes: the
    ``_shard_chunk_plan`` chunks go through ``_run_pipeline`` with the
    pipelined load's bounded queue, ``buffer_depth`` and page-locked
    staging, each chunk assembled from the host slices (a column block is
    gathered into the staging buffer) while the previous chunk copies on
    its device's copy stream (``copiers``, one a distinct device). A shard
    is a contiguous view into its device chunk, with the spec, dimension
    and shape ``shard_params`` gives; a replicated leaf lands once a
    distinct device. Every leaf must be plain: an int8 artifact is expanded
    on the host first (``_dequantize_on_host``), as the rules name float
    leaves."""
    pairs = flatten_params(host_params)
    if any(isinstance(leaf, QuantLeaf) for _path, leaf in pairs):
        raise ValueError("the sharded packed transfer takes host-dequantized leaves")
    paths = [path for path, _leaf in pairs]
    arrs = [torch.as_tensor(leaf) for _path, leaf in pairs]
    axes = group_axes(group)
    specs = [spec_for(path, rules, axes) for path in paths]
    cuts = [sharded_dim(spec, axes) for spec in specs]
    for a, cut in zip(arrs, cuts):
        if cut is not None and a.shape[cut[0]] % cut[1]:
            raise ValueError(f"dimension {cut[0]} of a {tuple(a.shape)} leaf does not divide "
                             f"into {cut[1]} shards")
    plan = _shard_chunk_plan(arrs, cuts, group)
    sizes = [sum(_seg_nbytes(arrs, seg) for seg in segs) for _m, segs in plan]
    landed: list[dict[int, torch.Tensor]] = [{} for _ in arrs]  # flat idx -> {member: shard}
    pin = any(c.stream is not None for c in copiers.values())

    def fill(k: int, buf: torch.Tensor) -> None:
        off = 0
        for seg in plan[k][1]:
            part = _seg_view(arrs, seg)
            n = part.numel()
            buf[off:off + n].view(part.shape).copy_(part)
            off += n

    def land(k: int, buf: torch.Tensor) -> Any:
        m, segs = plan[k]
        dev, ev = copiers[group[m]].land(buf)
        off = 0
        for seg in segs:
            shape = tuple(_seg_view(arrs, seg).shape)
            n = math.prod(shape)
            landed[seg[0]][m] = dev[off:off + n].view(shape)
            off += n
        return ev

    def drain() -> None:
        for c in copiers.values():
            c.drain()

    staging = _run_pipeline(sizes, [arrs[plan[k][1][0][0]].dtype for k in range(len(plan))],
                            fill, land, drain, buffer_depth, pin, workers=workers,
                            name="tpusc-shard-assembler")
    out = []
    for i, (a, spec, cut) in enumerate(zip(arrs, specs, cuts)):
        if cut is None:
            # landed on the first member of each distinct device
            by_dev = {group[m]: shard for m, shard in landed[i].items()}
            shards = tuple(by_dev[dev] for dev in group)
        else:
            shards = tuple(landed[i][m] for m in range(len(group)))
        out.append(ShardedLeaf(spec, None if cut is None else cut[0], tuple(a.shape), shards))
    events = [ev for ev in (c.finish() for c in copiers.values()) if ev is not None]
    stats = {"chunks": len(plan), "bytes": sum(sizes), "staging_bytes": staging}
    return unflatten_params(paths, out), events, stats


def packed_device_put_group(host_params: Any, rules: Mapping[str, tuple],
                            group: tuple[torch.device, ...]) -> Any:
    """The serialized transfer onto a device group (``cold_load_pipeline:
    false``, a lockstep group): each leaf copied whole to the leader out of
    the artifact's page-locked buffer, then cut there by ``rules`` into
    contiguous shards (``parallel.sharding.shard_leaf``), the whole leaf
    dropped once it is cut, so the device holds the shards plus one leaf
    at most; one sync on each device at the end. The shards have the
    sharded packed transfer's layout, so the two loads give the same
    module. Every leaf must be plain (``_dequantize_on_host`` first). On a
    group that spans processes the leader is this process's first member,
    and another process's members get meta tensors."""
    lead = local_lead(group)
    axes = group_axes(group)
    pairs = flatten_params(host_params)
    placed = [shard_leaf(leaf.to(lead, non_blocking=True), spec_for(path, rules, axes), group)
              for path, leaf in pairs]
    for dev in dict.fromkeys(group):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    return unflatten_params([path for path, _leaf in pairs], placed)


def build_packed_entry(model_def: ModelDef, host_params: Any, hbm_bytes: int,
                       captured: list | None = None, pin: bool = False) -> PackedModelEntry:
    """A host-tier entry from a model's params (reference :511).

    ``captured``, the chunk buffers a pipelined load just copied, is used as
    it is (the load paid the assembly); otherwise the chunks are assembled
    here from the same ``_pack_plan`` into owned buffers (page-locked with
    ``pin``): the demotion path, where the leaves are on the device, and the
    loads that captured nothing (a serialized load, a tree of two leaves or
    fewer). A retained buffer is never a view into the artifact's bytes.
    A ``QuantLeaf`` of ``host_params`` (a ``raw_quant`` load's) is retained
    as its int8 and scale tensors, its original dtype in ``quant_dtypes``."""
    outer, treedef, arrs, owner = _flatten_for_pack(host_params)
    if captured:
        chunks = [(list(chunk), buf) for chunk, buf in captured]
    else:
        chunks = [(chunk, _packed_chunk(arrs, chunk, pin)) for chunk in _pack_plan(arrs)]
    return PackedModelEntry(
        model_def=model_def,
        chunks=chunks,
        owner=owner,
        shapes=[tuple(a.shape) for a in arrs],
        quant_dtypes={oi: leaf.orig_dtype for oi, leaf in enumerate(outer)
                      if isinstance(leaf, QuantLeaf)},
        treedef=treedef,
        make_module=model_def.make_module,
        hbm_bytes=int(hbm_bytes),
        nbytes=sum(_leaf_nbytes(buf) for _chunk, buf in chunks),
        paths=list(treedef),
    )


def promote_packed_entry(entry: PackedModelEntry,
                         copier: _ChunkCopier) -> tuple[Any, Any, float]:
    """Replay an entry's chunks onto the device (reference :568) -> (params,
    the event to sync on or None, the seconds spent dispatching dequants):
    the copies of the pipelined load, fed straight from the retained
    chunks, with no disk read, no decode and no assembly. A quantized leaf
    is rebuilt and dequantized on the device as both of its halves land."""
    out: list[Any] = [None] * len(entry.treedef)
    quant = _QuantLanding(entry.quant_dtypes, copier.device)
    for chunk, buf in entry.chunks:
        dev, ev = copier.land(buf)
        for i, view in zip(chunk, _chunk_views(dev, chunk, entry.shapes)):
            oi, role = entry.owner[i]
            out[oi] = view if role == "plain" else quant.land(oi, role, view, ev)
        del dev
    return unflatten_params(entry.treedef, out), copier.finish(), quant.seconds


def unpack_entry_host(entry: PackedModelEntry) -> Any:
    """The host tree of an entry's chunks (reference :608): each leaf a
    view into its retained chunk, a quantized leaf expanded on the host
    (``dequant_host``). The sharded promotion re-cuts this tree, since the
    chunks hold whole leaves and the partition rules name float leaves."""
    flat: list[Any] = [None] * len(entry.shapes)
    for chunk, buf in entry.chunks:
        for i, view in zip(chunk, _chunk_views(buf, chunk, entry.shapes)):
            flat[i] = view
    outer: list[Any] = [None] * len(entry.treedef)
    pending: dict[int, dict[str, torch.Tensor]] = {}
    for i, (oi, role) in enumerate(entry.owner):
        if role == "plain":
            outer[oi] = flat[i]
        else:
            pending.setdefault(oi, {})[role] = flat[i]
    for oi, got in pending.items():
        outer[oi] = QuantLeaf(got["q"], got["scale"], entry.quant_dtypes[oi]).dequant_host()
    return unflatten_params(entry.treedef, outer)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the current CUDA device; without a card that raises
    instead of quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError_(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError_(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError_(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@dataclass
class LoadedModel:
    model_def: ModelDef
    module: torch.nn.Module
    nbytes: int
    params: Any = None               # the module's params tree (a demotion reads it)
    # the module is tensor parallel over the runtime's group (its params
    # tree holds parallel.sharding.ShardedLeaf leaves)
    tensor_parallel: bool = False


@dataclass
class SlotDecodeState:
    """Device + host state of one model's continuous-decode lanes
    (reference model_runtime.py:650-846). Dense mode (``page_tokens == 0``):
    ``k``/``v`` are the slot array ``(layers, S, n_kv, max_seq, hd)``, one
    lane per slot. Paged mode: ``k``/``v`` are the shared arena
    ``(layers, arena_pages + 1, n_kv, page_tokens, hd)`` — page 0 is the
    trash page — and each lane reads and writes through its
    ``block_tables`` row; the free list hands pages out at admission and
    takes them back at retirement. The host mirrors (tok/pos/active/temps/
    topks, block tables, free list) belong to the engine's scheduler
    thread; the runtime copies them to the device once per chunk. On a
    tensor-parallel model's group ``k``/``v`` (and ``scales``) are
    ``KVShards`` cut over the KV-head axis, one shard a device; their
    ``shape`` and ``dtype`` are the one-device buffer's."""

    model_id: ModelId
    slots: int
    max_seq: int
    k: torch.Tensor | KVShards       # slot array or paged arena, updated in place
    v: torch.Tensor | KVShards
    tok: np.ndarray                  # (S,) i32 last sampled token per lane
    pos: np.ndarray                  # (S,) i32 next write position
    active: np.ndarray               # (S,) bool
    temps: np.ndarray                # (S,) f32 per-lane temperature
    topks: np.ndarray                # (S,) i32 per-lane top_k
    chunk_counter: int = 0           # seeds each chunk's generator
    page_tokens: int = 0
    arena_pages: int = 0             # usable pages (excludes trash page 0)
    pages_per_slot: int = 0          # ceil(max_seq / page_tokens)
    # int8 arena: per-row f32 scale buffers {"k", "v"} (None otherwise)
    scales: dict | None = None
    arena_dtype: str = ""            # "" = model dtype; "int8" = quantized
    kernel: bool = True              # serving.kv_paged_kernel
    block_tables: np.ndarray | None = None   # (S, pages_per_slot) i32
    free_pages: list = field(default_factory=list)
    lane_pages: dict = field(default_factory=dict)  # lane -> [page ids]
    # shared-prefix KV (reference :690-698): page_refs[pg] counts every owner
    # of a page, the lanes that map it and the prefix index's own holds. A
    # lane may write a page only while it owns it alone; a first write into
    # a page with refs > 1 goes through copy-on-write (cow_page +
    # generation.page_copy). Invariant (check_page_conservation): every
    # usable page is free or has refs > 0, and refs match the census.
    page_refs: np.ndarray | None = None      # (arena_pages + 1,) i32
    prefix_index: PagePrefixIndex | None = None
    # in-engine speculative decoding (reference :703-712): the draft model's
    # own SlotDecodeState rides on the target's — same slot count and
    # page_tokens, its own arena/tables/free list/census, no prefix index —
    # so every scheduler reserve/release mirrors 1:1 onto the draft arena.
    # Its tok/pos/active host mirrors alias the target's (both caches
    # advance through the same accepted positions). None = spec off.
    spec_draft_id: ModelId | None = None
    spec_draft: SlotDecodeState | None = None
    spec_tokens: int = 0             # draft proposals per verify round

    @property
    def paged(self) -> bool:
        return self.page_tokens > 0

    def pages_needed(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_tokens)

    def lane_capacity(self, lane: int) -> int:
        """Token capacity reserved for ``lane`` (page-granular)."""
        return len(self.lane_pages.get(lane, ())) * self.page_tokens

    def reserve_pages(self, lane: int, tokens: int, shared_pages: list | tuple = (),
                      cow_headroom: int = 0) -> bool:
        """Reserve pages for ``tokens`` (the row's prompt + max_new budget,
        so a decoding row never starves) and point the lane's block table at
        them (reference :725). ``shared_pages`` are resident prefix pages
        mapped READ-ONLY at the front of the row (a refcount bump, no
        allocation); only the private remainder comes off the free list,
        plus ``cow_headroom`` pages that must be free but stay there for an
        immediately following ``cow_page``. False when the free list cannot
        cover it: the caller blocks admission and retries after
        retirements."""
        need = self.pages_needed(tokens)
        priv = max(0, need - len(shared_pages))
        if priv + cow_headroom > len(self.free_pages):
            return False
        pages = [int(pg) for pg in shared_pages]
        pages += [self.free_pages.pop() for _ in range(priv)]
        for pg in pages:
            self.page_refs[pg] += 1
        self.lane_pages[lane] = pages
        self.block_tables[lane, :] = 0
        self.block_tables[lane, :len(pages)] = pages
        return True

    def release_pages(self, lane: int) -> None:
        """Drop a retired or failed lane's page references — a page goes
        back on the free list only when its LAST owner lets go (shared
        prefix pages stay for their other lanes and the index) — and park
        the lane on the trash page (zeroed table row), so its frozen
        in-chunk rewrites never touch a recycled page's next owner."""
        for pg in self.lane_pages.pop(lane, None) or ():
            n = int(self.page_refs[pg]) - 1
            self.page_refs[pg] = max(n, 0)
            if n <= 0:
                self.free_pages.append(pg)
        if self.block_tables is not None:
            self.block_tables[lane, :] = 0

    def cow_page(self, lane: int, slot: int) -> tuple[int, int] | None:
        """Host half of copy-on-write (reference :772): swap ``lane``'s
        block-table entry at ``slot`` to a fresh free page and move the
        lane's reference onto it. -> (src, dst) for the device page copy,
        or None when the free list is empty (admission reserves
        cow_headroom so that the protocol never gets there)."""
        if not self.free_pages:
            return None
        src = int(self.block_tables[lane, slot])
        dst = self.free_pages.pop()
        self.page_refs[dst] = 1
        self.block_tables[lane, slot] = dst
        self.lane_pages[lane][slot] = dst
        n = int(self.page_refs[src]) - 1
        self.page_refs[src] = max(n, 0)
        if n <= 0:
            # the "shared" page had one owner after all: recycle it
            self.free_pages.append(src)
        return src, dst

    def page_stats(self) -> dict:
        """Distinct-page split of the arena (trash page 0 excluded, reference
        :793): ``free`` on the free list, ``cached`` held only by the prefix
        index (reclaimable under admission pressure), ``shared`` mapped by a
        lane and at least one other owner, ``private`` owned by one lane
        alone. A shared page counts once however many lanes read it."""
        lane_refs: dict[int, int] = {}
        for pages in self.lane_pages.values():
            for pg in pages:
                lane_refs[pg] = lane_refs.get(pg, 0) + 1
        held = self.prefix_index.held_pages() if self.prefix_index is not None else {}
        shared = sum(1 for pg, n in lane_refs.items() if n > 1 or pg in held)
        return {
            "free": len(self.free_pages),
            "cached": sum(1 for pg in held if pg not in lane_refs),
            "shared": shared,
            "private": len(lane_refs) - shared,
        }

    def check_page_conservation(self) -> None:
        """Assert the refcount invariant over the whole arena (reference
        :816): every usable page is exactly one of free or referenced,
        ``page_refs`` agrees with the census of lane references plus the
        prefix index's holds, page 0 is never handed out. Host-only."""
        if not self.paged:
            return
        census = np.zeros(self.arena_pages + 1, np.int64)
        for pages in self.lane_pages.values():
            for pg in pages:
                census[pg] += 1
        if self.prefix_index is not None:
            for pg, n in self.prefix_index.held_pages().items():
                census[pg] += n
        free = set(self.free_pages)
        assert len(free) == len(self.free_pages), "duplicate free-list pages"
        assert 0 not in free, "trash page on the free list"
        assert census[0] == 0, "trash page is referenced"
        for pg in range(1, self.arena_pages + 1):
            refs = int(census[pg])
            if pg in free:
                assert refs == 0, f"page {pg} free but referenced {refs}x"
            else:
                assert refs > 0, f"page {pg} leaked (not free, unreferenced)"
            got = int(self.page_refs[pg])
            assert got == refs, f"page {pg}: page_refs says {got}, census says {refs}"


# TPUSC_PAGECHECK=1: assert before every paged decode chunk that no live
# lane's block table maps the trash page below its visible position — the
# plain path and the kernel read whatever the table points at, so such an
# entry would attend over junk K/V with no error anywhere.
_PAGECHECK = os.environ.get("TPUSC_PAGECHECK", "") == "1"


def _check_trash_unreachable(state: SlotDecodeState) -> None:
    """Raise if an active lane's block-table row maps page 0 in a slot its
    attention window reaches (pages covering tokens 0..pos inclusive)
    (reference :858). Host-only, O(slots x pages_per_slot)."""
    for lane in range(state.slots):
        if not bool(state.active[lane]):
            continue
        live = state.pages_needed(int(state.pos[lane]) + 1)
        row = state.block_tables[lane, :live]
        if (row == 0).any():
            bad = int(np.argmax(row == 0))
            raise AssertionError(
                f"TPUSC_PAGECHECK: lane {lane} maps trash page 0 at block-table slot "
                f"{bad} below pos={int(state.pos[lane])} (live pages={live}) — attention "
                "would read junk KV"
            )


def _arena(state: SlotDecodeState) -> dict:
    """The paged arena of ``state`` as generation's ``{"k", "v"[, "k_scale",
    "v_scale"]}`` dict (the same tensors, updated in place)."""
    arena = {"k": state.k, "v": state.v}
    if state.scales is not None:
        arena["k_scale"], arena["v_scale"] = state.scales["k"], state.scales["v"]
    return arena


def _shards_weights(rules: Mapping[str, tuple]) -> bool:
    """Do partition rules place any weight axis on a mesh axis (tensor
    parallelism), rather than replicate everything?"""
    return any(any(ax is not None for ax in axes) for axes in rules.values())


class TorchModelRuntime(BaseRuntime):
    def __init__(
        self,
        cfg: ServingConfig | None = None,
        device: str | torch.device | None = None,
        devices: list[str | torch.device] | None = None,
        metrics: Any = None,
        host_tier_bytes: int = 0,
    ) -> None:
        super().__init__()
        self.cfg = cfg or ServingConfig()
        self.metrics = metrics
        # the device group (None = one device); its first device leads. A
        # member another process owns is a meta placeholder, and this
        # process's first member leads its half
        self.group: tuple[torch.device, ...] | None = None
        if devices is not None:
            group = tuple(torch.device(d) if is_remote(torch.device(d)) else resolve_device(d)
                          for d in devices)
            if not group:
                raise RuntimeError_("a device group needs at least one device")
            try:
                lead = local_lead(group)
            except ValueError as e:
                raise RuntimeError_(str(e)) from None
            if device is not None and resolve_device(device) != lead:
                raise RuntimeError_(
                    f"device {device!r} is not the group's leader {lead} (devices[0])"
                )
            self.group = group
            device = lead
        self.device = resolve_device(device)
        self._resident = make_lru_cache(
            self.cfg.hbm_capacity_bytes,
            on_evict=self._on_evict,
            max_items=self.cfg.max_concurrent_models,
        )
        self._load_locks: dict[ModelId, threading.Lock] = {}  # guarded-by: _load_locks_guard
        self._load_locks_guard = threading.Lock()
        self._slot_states: dict[ModelId, SlotDecodeState] = {}  # guarded-by: _slot_lock
        self._slot_init_guards: dict[ModelId, threading.Lock] = {}  # guarded-by: _slot_lock
        self._slot_lock = threading.Lock()
        # speculative decoding: acceptance health per (target, draft) pair,
        # and cumulative verify rounds / emitted tokens per engine label
        # ("solo", "continuous") in place of the reference's gauges
        self._spec_health: dict[tuple[ModelId, ModelId], dict] = {}  # guarded-by: _spec_lock
        self.spec_rounds: collections.Counter = collections.Counter()  # guarded-by: _spec_lock
        self.spec_emitted: collections.Counter = collections.Counter()  # guarded-by: _spec_lock
        self._spec_lock = threading.Lock()
        # the solo path's prefix KV cache (serving.prefix_cache_bytes, 0 = off)
        self._prefix_cache: PrefixCache | None = None
        if self.cfg.prefix_cache_bytes > 0:
            self._prefix_cache = PrefixCache(self.cfg.prefix_cache_bytes)
        # the packed transfer's copy stream (a card only) and the chunk
        # assemblers of loads in flight (close joins them)
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # one copy stream a distinct device of the group: the sharded
        # transfer lands each shard's chunks on its own device's stream
        self._copy_streams = {
            dev: self._copy_stream if dev == self.device else torch.cuda.Stream(dev)
            for dev in dict.fromkeys(self.group or (self.device,)) if dev.type == "cuda"}
        self._assemblers: set[threading.Thread] = set()
        self._closing = threading.Event()
        # Host-RAM warm tier (cache/host_tier.py, cache.host_tier_bytes, 0 =
        # off): the packed chunks of evicted models, so that a re-admission
        # replays them onto the device with no disk read and no decode. A
        # group keeps one too, unless it is lockstep (reference :971-983);
        # a tensor-parallel model's entry holds whole leaves, re-cut by the
        # sharded promotion. Demotions that must copy a model back off the
        # device run on the demote worker, never on the evicting thread (see
        # _on_evict).
        self._host_tier: HostRamTier | None = None
        self._demote_queue: queue.Queue | None = None
        self._demote_thread: threading.Thread | None = None
        if host_tier_bytes > 0 and not self.mesh_lockstep:
            self._host_tier = HostRamTier(host_tier_bytes, metrics)
            self._demote_queue = queue.Queue()
            self._demote_thread = threading.Thread(
                target=self._demote_loop, name="tpusc-demote", daemon=True)
            self._demote_thread.start()
        # packed entries a peer fetch rebuilt off the wire
        # (protocol/peer_transfer.py), each consumed by the next load of its
        # model
        self._adopted: dict[ModelId, PackedModelEntry] = {}  # guarded-by: _adopted_lock
        self._adopted_lock = threading.Lock()

    # -- load ---------------------------------------------------------------
    def ensure_loaded(self, model: Model) -> str:
        """-> the tier that served this call: ``"hbm"`` (already resident),
        ``"host"`` (promoted from the host tier) or ``"disk"`` (loaded from
        the artifact). The cache manager counts it in
        ``tpusc_reload_source``."""
        mid = model.identifier
        if self.is_loaded(mid):
            return "hbm"
        with self._load_locks_guard:
            lock = self._load_locks.setdefault(mid, threading.Lock())
        try:
            with lock:
                if self.is_loaded(mid):  # singleflight: someone else finished it
                    return "hbm"
                return self._load(model)
        finally:
            if not self.is_loaded(mid):
                with self._load_locks_guard:
                    held = self._load_locks.get(mid)
                    if held is lock and not held.locked():
                        del self._load_locks[mid]

    def adopt_packed_entry(self, model_id: ModelId, entry: PackedModelEntry) -> None:
        """Hand over a ``PackedModelEntry`` that did not come from this
        runtime's own demotion: a peer fetch rebuilt it off the wire
        (reference :1063). The next ``_load`` of ``model_id`` promotes it
        (the copies of a host-tier promotion, no read of the artifact) and
        drops it. Where the reference fills the entry's jit handle
        (``_fill_family_jit``), the entry carries its family's module
        factory (``make_module``), with which ``_promote`` builds the
        module; a tensor-parallel group promotes it through the sharded
        replay. Advisory: a lockstep group (``serving.mesh_fast_path:
        false``) drops it, and a failed promotion falls through to the full
        load from the artifact."""
        if self.mesh_lockstep:
            return
        with self._adopted_lock:
            self._adopted[model_id] = entry

    def _load(self, model: Model) -> str:
        mid = model.identifier
        with self._adopted_lock:
            adopted = self._adopted.pop(mid, None)
        if adopted is not None:
            try:
                self._promote(model, adopted)
                return "host"
            except Exception as e:  # noqa: BLE001 - the full path still works
                log.warning("promotion of the adopted entry of %s failed (%s); "
                            "falling back to the full load path", mid, e)
        if self._host_tier is not None:
            entry = self._host_tier.get(mid)
            if entry is not None:
                try:
                    self._promote(model, entry)
                    return "host"
                except Exception as e:  # noqa: BLE001 - the full path still works
                    log.warning("host-tier promotion of %s failed (%s); "
                                "falling back to the full load path", mid, e)
                    self._host_tier.remove(mid)
        self._set_state(mid, ModelState.START)
        t0 = time.monotonic()
        with TRACER.span("load", model=str(mid), tier="disk") as load_span:
            self._load_traced(model, mid, t0, load_span)
        # sum(stage) / wall (reference :1129): ~1.0 = the stages ran back to
        # back; > 1 = stages overlapped the span's wall
        if load_span.children and load_span.duration_s > 0:
            ratio = sum(c.duration_s for c in load_span.children) / load_span.duration_s
            load_span.attrs["cold_overlap_ratio"] = round(ratio, 3)
            if self.metrics is not None:
                self.metrics.cold_overlap_ratio.observe(ratio)
        if self.metrics is not None:
            for child in load_span.children:
                self.metrics.cold_stage_seconds.labels(child.name).observe(child.duration_s)
        self._update_gauges()
        return "disk"

    def _copier(self) -> _ChunkCopier:
        return _ChunkCopier(self.device, self._copy_stream)

    def _copiers(self) -> dict[torch.device, _ChunkCopier]:
        """One copier a distinct device of the group, each on its device's
        copy stream (on ``[cuda:0] * P`` the runtime's one stream)."""
        return {dev: _ChunkCopier(dev, self._copy_streams.get(dev))
                for dev in dict.fromkeys(self.group or (self.device,)) if not is_remote(dev)}

    def _module(self, model_def: ModelDef, params: Any, tp: TensorParallelPlan | None,
                make_module: Any = None) -> torch.nn.Module:
        """The family's module over ``params``: the tensor-parallel module on
        a group that cuts the tree, a ring model bound to its group, else
        ``make_module`` (the family's, by default)."""
        if tp is not None:
            return tp.make_module(params)
        if self.group is not None and model_def.bind_group is not None:
            return model_def.bind_group(self.group)(params)
        return (make_module or model_def.make_module)(params)

    def _promote(self, model: Model, entry: PackedModelEntry) -> None:
        """Host-tier promotion (reference :1153): the entry's chunks
        replayed onto the device through the copy path of a cold load, the
        module built over them. No disk read, no decode, no warm-up forward.
        On a tensor-parallel group the sharded branch (reference :1170-1188)
        rebuilds the host leaves from the chunks (``unpack_entry_host``, an
        int8 entry expanded there) and re-cuts them through
        ``packed_device_put_sharded``, as the disk load did."""
        mid = model.identifier
        self._set_state(mid, ModelState.START)
        t0 = time.monotonic()
        try:
            with TRACER.span("load", model=str(mid), tier="host") as load_span:
                self._set_state(mid, ModelState.LOADING)
                tp = self._tensor_parallel(entry.model_def)
                if tp is not None:
                    with TRACER.span("device_transfer", promoted=True, sharded=True):
                        host_params = unpack_entry_host(entry)
                        params, events, stats = packed_device_put_sharded(
                            host_params, tp.rules, self.group, self._copiers(),
                            buffer_depth=self.cfg.cold_pipeline_buffer_depth,
                            workers=self._assemblers)
                        del host_params
                        TRACER.annotate(**stats)
                    dequant_s = 0.0
                else:
                    with TRACER.span("device_transfer", promoted=True):
                        params, done, dequant_s = promote_packed_entry(entry, self._copier())
                        TRACER.annotate(chunks=len(entry.chunks), bytes=entry.nbytes)
                    events = [done] if done is not None else []
                if entry.quant_dtypes and tp is None:
                    # the dequants ran inside the transfer span (reference :1195)
                    TRACER.attach(load_span, "device_dequant", dequant_s, overlapped=True)
                with TRACER.span("transfer_sync", pinned_by="promotion"):
                    for ev in events:
                        ev.synchronize()
                module = self._module(entry.model_def, params, tp, entry.make_module)
                hbm = entry.hbm_bytes or tree_nbytes(params)
                loaded = LoadedModel(entry.model_def, module.eval(), hbm, params,
                                     tensor_parallel=tp is not None)
                TRACER.annotate(hbm_bytes=hbm, promoted_from="host")
                self._resident.put(mid, hbm, loaded)
                self._set_state(mid, ModelState.AVAILABLE)
        except Exception as e:
            self._set_state(mid, ModelState.END)
            raise RuntimeError_(f"failed to promote {mid}: {e}") from e
        self._update_gauges()
        log.info("promoted %s from the host tier in %.3fs (%d device bytes)",
                 mid, time.monotonic() - t0, hbm)

    def _load_traced(self, model: Model, mid: ModelId, t0: float, load_span: Any) -> None:
        try:
            self._set_state(mid, ModelState.LOADING)
            on_cuda = self.device.type == "cuda"
            pipelined = self.cold_pipeline_enabled
            with TRACER.span("artifact_read"):
                # the serialized path copies out of one page-locked buffer;
                # the pipelined one maps the file and pins only its staging
                # buffers (and the chunks the tier keeps): the assembler
                # reads the pages while earlier chunks copy. An int8
                # artifact is read raw (q + scales): its int8 bytes cross
                # the link and dequantize on the device (reference :1268)
                model_def, host_params = load_artifact(
                    model.path, pin_memory=on_cuda and not pipelined, map_params=pipelined,
                    raw_quant=True)
            has_quant = _has_quant(host_params)
            tp = self._tensor_parallel(model_def)
            captured: list | None = None  # the tier's chunks, off the pipelined copy
            if tp is not None:
                # the group's branch (reference :1283-1327): the partition
                # rules name float leaves, so an int8 artifact expands on
                # the host before the cut, in its own stage (reference
                # :1300); the tier retains the expanded tree
                if has_quant:
                    with TRACER.span("host_dequant"):
                        host_params = _dequantize_on_host(host_params)
                if pipelined:
                    # each device gets only its own shard bytes, chunk
                    # assembly overlapping the previous chunk's copy
                    with TRACER.span("device_transfer", pipelined=True, sharded=True):
                        params, events, stats = packed_device_put_sharded(
                            host_params, tp.rules, self.group, self._copiers(),
                            buffer_depth=self.cfg.cold_pipeline_buffer_depth,
                            workers=self._assemblers)
                        TRACER.annotate(**stats)
                    with TRACER.span("transfer_sync"):
                        for ev in events:
                            ev.synchronize()
                else:
                    with TRACER.span("device_transfer"):
                        params = packed_device_put_group(host_params, tp.rules, self.group)
                # tree_nbytes of the sharded tree is the tree's logical
                # bytes (the reference's tree_nbytes of the global arrays),
                # a replicated leaf counted once
                TRACER.annotate(**{f"tp_{half}": cut for half, cut in tp.halves.items()})
            elif pipelined:
                if self._host_tier is not None:
                    captured = []
                with TRACER.span("device_transfer", pipelined=True):
                    params, done, stats = packed_device_put_pipelined(
                        host_params, self._copier(),
                        buffer_depth=self.cfg.cold_pipeline_buffer_depth,
                        capture=captured, workers=self._assemblers)
                    dequant_s = stats.pop("dequant_s")
                    TRACER.annotate(**stats)
                if has_quant:
                    # the dequants ran inside the transfer span: their
                    # dispatch seconds are the device_dequant stage, for
                    # quantized artifacts only (reference :1346)
                    TRACER.attach(load_span, "device_dequant", dequant_s, overlapped=True)
                with TRACER.span("transfer_sync"):
                    if done is not None:
                        done.synchronize()
            else:
                # one device, a ring model's leader or a group whose rules
                # cut nothing: the raw int8 bytes cross the link
                with TRACER.span("device_transfer"):
                    params = packed_device_put(host_params, self.device)
                if has_quant:
                    # its own stage, quantized artifacts only (reference
                    # :1361); the sync puts the device's dequant time in it
                    with TRACER.span("device_dequant"):
                        params = _dequantize_on_device(params)
                        if on_cuda:
                            torch.cuda.current_stream(self.device).synchronize()
            module = self._module(model_def, params, tp)
            loaded = LoadedModel(model_def, module.eval(), tree_nbytes(params), params,
                                 tensor_parallel=tp is not None)
            TRACER.annotate(hbm_bytes=loaded.nbytes)
            with TRACER.span("compile_warmup", family=model_def.family):
                self._warmup(loaded)
            self._resident.put(mid, loaded.nbytes, loaded)
            # eager retain: the chunks are in hand now (captured off the
            # pipelined copy, or packed here from the host params), so an
            # eviction is usually an LRU touch, never a copy off the device
            self._retain_packed(mid, model_def, host_params, loaded.nbytes, captured)
            del host_params
            self._set_state(mid, ModelState.AVAILABLE)
        except Exception as e:
            self._set_state(mid, ModelState.END)
            raise RuntimeError_(f"failed to load {mid}: {e}") from e
        log.info(
            "loaded %s in %.2fs (%d device bytes on %s)",
            mid, time.monotonic() - t0, loaded.nbytes, self.device,
        )

    def _tensor_parallel(self, model_def: ModelDef) -> TensorParallelPlan | None:
        """The family's tensor-parallel plan on this runtime's group: None on
        one device, for a family that binds the group itself (a ring model)
        and for rules that cut no weight; a family whose rules cut weights
        but that has no tensor-parallel module is refused, and so are a ring
        model, bert and t5 on a group that spans processes."""
        if self.spans_processes and (
                model_def.bind_group is not None
                or (_shards_weights(model_def.partition_rules)
                    and model_def.family not in ("transformer_lm", "moe_lm"))):
            # refused the same way in every process, before any collective
            raise RuntimeError_(
                f"{model_def.family} on a group that spans processes: cross-process groups: "
                f"later slice (tensor-parallel transformer_lm and moe_lm serve on one)"
            )
        if self.group is None or len(self.group) < 2 or model_def.bind_group is not None:
            return None
        if not _shards_weights(model_def.partition_rules):
            return None
        if model_def.tensor_parallel is None:
            raise RuntimeError_(
                f"{model_def.family} declares partition rules that shard its weights "
                f"and has no tensor-parallel module; this runtime's group has "
                f"{len(self.group)} devices"
            )
        return model_def.tensor_parallel(self.group)

    @property
    def spans_processes(self) -> bool:
        """Is this runtime's group one whose members other processes own
        too (``parallel/mesh.py``)?"""
        return spans_processes(self.group)

    @property
    def mesh_lockstep(self) -> bool:
        """A group whose device-op stream must stay a function of the
        request sequence alone (reference :1501-1514): a group that spans
        processes, whose every process must run the same ops in the same
        order whatever ``serving.mesh_fast_path`` says (reference :974,
        :1513), and a group with ``serving.mesh_fast_path`` off, the A/B
        lever. Such a group loads serialized, keeps no host tier, drops
        adopted entries and runs ``:generate`` on the solo path."""
        return self.group is not None and (self.spans_processes or not self.cfg.mesh_fast_path)

    @property
    def cold_pipeline_enabled(self) -> bool:
        """``serving.cold_load_pipeline`` on one device and on a group that
        is not lockstep (reference :1516-1525): a tensor-parallel model
        streams each device its own shard chunks
        (``packed_device_put_sharded``)."""
        return bool(self.cfg.cold_load_pipeline) and not self.mesh_lockstep

    def precompile_from_meta(self, meta: Mapping[str, Any]) -> None:
        """No-op (reference :1527 starts the family's XLA compile from the
        artifact's metadata while the params still download): a torch
        module has no ahead-of-time compile to start."""

    def _warmup(self, loaded: LoadedModel) -> None:
        """One tiny forward at bucket 1 before AVAILABLE (library handles
        and allocator pools are set up before the first real request)."""
        inputs = {
            name: torch.zeros(self._concrete_shape(spec, 1), device=self.device,
                              dtype=getattr(torch, spec.dtype))
            for name, spec in loaded.model_def.input_spec.items()
        }
        with torch.inference_mode():
            loaded.module(inputs)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _concrete_shape(spec: TensorSpec, batch: int) -> tuple[int, ...]:
        return tuple(batch if isinstance(d, str) else d for d in spec.norm_shape())

    # -- predict ------------------------------------------------------------
    def predict(
        self,
        model_id: ModelId,
        inputs: Mapping[str, np.ndarray],
        output_filter: list[str] | None = None,
    ) -> dict[str, np.ndarray]:
        loaded = self._resident.get(model_id)
        if loaded is None:
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        model_def = loaded.model_def
        spec = model_def.input_spec
        missing = set(spec) - set(inputs)
        if missing:
            raise RuntimeError_(f"missing inputs {sorted(missing)} for {model_id}")
        unknown = set(inputs) - set(spec)
        if unknown:
            raise RuntimeError_(f"unknown inputs {sorted(unknown)} for {model_id}")

        dyn_sizes, padded = self._pad_to_bucket(spec, inputs, model_def.axis_caps)
        out_spec = model_def.output_spec
        derived = model_def.derived_outputs
        if output_filter:
            names = list(output_filter)
        elif model_def.default_outputs:
            names = list(model_def.default_outputs)
        else:
            names = list(out_spec)
        unknown_out = [n for n in names if n not in out_spec and n not in derived]
        if unknown_out:
            raise RuntimeError_(
                f"output_filter names unknown outputs {unknown_out} for {model_id} "
                f"(available: {sorted(out_spec) + sorted(derived)})"
            )
        with TRACER.span("infer", model=str(model_id)), torch.inference_mode():
            dev_in = {
                name: torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
                for name, arr in padded.items()
            }
            dev_out = loaded.module(dev_in)
            # select + un-pad ON DEVICE so only the requested bytes cross
            # to the host (an LM ships (B, V), not the padded (B', S', V))
            selected: dict[str, torch.Tensor] = {}
            for name in names:
                if name in derived:
                    fn, _dspec = derived[name]
                    selected[name] = fn(dev_out, dyn_sizes)
                    continue
                arr = dev_out[name]
                for axis, axis_name in out_spec[name].dynamic_axes():
                    true = dyn_sizes.get(axis_name)
                    if true is not None and arr.dim() > axis and arr.shape[axis] > true:
                        arr = arr.narrow(axis, 0, true)
                selected[name] = arr
            return {name: t.contiguous().cpu().numpy() for name, t in selected.items()}

    def _pad_to_bucket(
        self, spec: Mapping[str, TensorSpec], inputs: Mapping[str, np.ndarray],
        axis_caps: Mapping[str, int],
    ) -> tuple[dict[str, int], dict[str, np.ndarray]]:
        """-> (true size per named dynamic axis, padded inputs). Every named
        axis pads to its own power-of-two bucket; the same name must agree
        across inputs. A capped axis (``ModelDef.axis_caps``: bert's
        position table) clamps its bucket to the cap and refuses a true
        size beyond it (reference :1759)."""
        dyn_sizes: dict[str, int] = {}
        for name, s in spec.items():
            arr = np.asarray(inputs[name])
            for axis, axis_name in s.dynamic_axes():
                if arr.ndim <= axis:
                    raise RuntimeError_(
                        f"input {name!r} needs at least {axis + 1} dims, got shape {arr.shape}"
                    )
                size = arr.shape[axis]
                if axis_name in dyn_sizes and dyn_sizes[axis_name] != size:
                    raise RuntimeError_(
                        f"inconsistent {axis_name!r} dim: {dyn_sizes[axis_name]} vs "
                        f"{size} ({name!r})"
                    )
                dyn_sizes[axis_name] = size
        if not dyn_sizes:
            return {}, {k: np.asarray(v) for k, v in inputs.items()}
        for axis_name, size in dyn_sizes.items():
            cap = axis_caps.get(axis_name)
            if cap is not None and size > cap:
                raise RuntimeError_(
                    f"{axis_name!r} dim {size} exceeds this model's maximum {cap}"
                )
        buckets = {n: min(next_bucket(v), axis_caps[n]) if n in axis_caps else next_bucket(v)
                   for n, v in dyn_sizes.items()}
        padded: dict[str, np.ndarray] = {}
        for name, s in spec.items():
            arr = np.asarray(inputs[name], dtype=s.np_dtype())
            pad = [(0, 0)] * arr.ndim
            changed = False
            for axis, axis_name in s.dynamic_axes():
                if buckets[axis_name] != arr.shape[axis]:
                    pad[axis] = (0, buckets[axis_name] - arr.shape[axis])
                    changed = True
            padded[name] = np.pad(arr, pad) if changed else arr
        return dyn_sizes, padded

    # -- generate -----------------------------------------------------------
    def _lm(self, model_id: ModelId, continuous: bool = False) -> LoadedModel:
        """The resident decoder LM: solo generate takes transformer_lm and
        moe_lm (reference :1858), the continuous slot surface transformer_lm
        only (:2048; moe_lm's expert capacity spans the whole batch, so its
        rows never share a decode step)."""
        loaded = self._resident.get(model_id)
        if loaded is None:
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        family = loaded.model_def.family
        if continuous and family != "transformer_lm":
            raise RuntimeError_(f"continuous decode supports transformer_lm only, not {family!r}")
        if family not in ("transformer_lm", "moe_lm"):
            raise RuntimeError_(
                f"generate is supported for transformer_lm/moe_lm models, not {family!r}"
            )
        return loaded

    def generate(
        self,
        model_id: ModelId,
        input_ids: np.ndarray,
        prompt_lengths: list[int] | None = None,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        draft_model_id: ModelId | None = None,
        spec_tokens: int = 4,
        prefix_rows: int | None = None,
        spec_admitted: bool | None = None,
    ) -> np.ndarray:
        """KV-cached decoding (``models/generation.generate``) on the solo
        path (reference :1813-1993): the same validation; prompt seq,
        max_new_tokens and the batch axis padded to power-of-two buckets,
        with the exact sizes where the buckets would overshoot max_seq.
        -> (B, max_new_tokens) int32.

        ``prefix_rows`` forces the prefix-cache decision (None = decide
        here): the leader of a group that spans processes decides once and
        ships it in the work envelope, so that every process runs the same
        ops (< 0 = the plain path without the cache, 0 = a miss through the
        cache, N = reuse exactly N cached rows); a process that cannot honour
        it raises before any device op. ``spec_admitted=True`` says the
        draft-acceptance gate was decided upstream (the leader admits once
        in its envelope; admitting again would count the re-audition
        cadence twice).

        ``draft_model_id`` switches to greedy speculative decoding
        (``models/speculative.py``): the draft proposes ``spec_tokens``
        tokens per round (clamped to a power of two <= 8), this model
        verifies them in one chunked forward; the output is its own greedy
        decode. Requires temperature 0 and a resident draft sharing the
        vocabulary. A pair the acceptance health gate disabled decodes plain
        (identical tokens) until it re-auditions."""
        from tfservingcache_tpu_torch.models import generation

        loaded = self._lm(model_id)
        draft = None
        if draft_model_id is not None:
            if temperature > 0.0:
                raise RuntimeError_(
                    "speculative decoding (draft_model) requires temperature 0 "
                    "— sampled acceptance is not implemented"
                )
            if spec_tokens < 1:
                raise RuntimeError_(f"spec_tokens must be >= 1, got {spec_tokens}")
            spec_tokens = next_bucket(min(spec_tokens, SPEC_TOKENS_MAX))
            draft = self._resident.get(draft_model_id)
            if draft is None:
                raise ModelNotLoadedError(f"draft model {draft_model_id} is not loaded")
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim != 2 or not ids.size:
            raise RuntimeError_(f"input_ids must be (batch, seq), got {ids.shape}")
        b, s = ids.shape
        if prompt_lengths is None:
            lengths = np.full((b,), s, np.int32)
        else:
            lengths = np.asarray(prompt_lengths, np.int32)
            if lengths.shape != (b,) or (lengths < 1).any() or (lengths > s).any():
                raise RuntimeError_(f"bad prompt_lengths {lengths!r} for shape {ids.shape}")
        if max_new_tokens < 1:
            raise RuntimeError_("max_new_tokens must be >= 1")
        if not math.isfinite(temperature) or temperature < 0.0:
            raise RuntimeError_(f"temperature must be a finite value >= 0, got {temperature}")
        if top_k < 0:
            raise RuntimeError_(f"top_k must be >= 0, got {top_k}")
        cfg = loaded.model_def.config
        max_seq = cfg["max_seq"]
        s_bucket = next_bucket(s)
        new_bucket = next_bucket(max_new_tokens)
        if s_bucket + new_bucket > max_seq:
            # bucket overshoot may exceed max_seq when the true request fits
            s_bucket, new_bucket = s, max_new_tokens
            if s + max_new_tokens > max_seq:
                raise RuntimeError_(
                    f"prompt {s} + max_new_tokens {max_new_tokens} exceeds max_seq {max_seq}"
                )
        if s_bucket != s:
            ids = np.pad(ids, ((0, 0), (0, s_bucket - s)))
        b_bucket = next_bucket(b)
        if b_bucket != b:  # padding rows decode junk that is sliced off
            ids = np.pad(ids, ((0, b_bucket - b), (0, 0)))
            lengths = np.pad(lengths, (0, b_bucket - b), constant_values=1)
        if (draft is not None and spec_admitted is None
                and not self._spec_admit(model_id, draft_model_id)):
            # sustained low acceptance: the draft is pure overhead; plain
            # greedy decode gives the same tokens until the pair re-auditions
            draft = None
        # B = 1 requests go through the prefix cache when it is on
        # (reference :1937-1990), unless a forced decision says otherwise
        prefix_capable = self._prefix_cache is not None and ids.shape[0] == 1
        if prefix_rows is not None:
            if prefix_rows < 0:
                # the leader runs the plain path (no cache kept, nothing
                # stored): so does this process, cache or not
                prefix_capable = False
            elif not prefix_capable:
                raise RuntimeError_(
                    f"prefix-cache divergence for {model_id}: the leader decided "
                    f"{prefix_rows} cached rows but this process cannot run the prefix "
                    "path (prefix_cache_bytes differs across the group?)"
                )
        forced_rows = prefix_rows if prefix_capable else None
        with TRACER.span("generate", model=str(model_id), tokens=new_bucket, batch=b,
                         draft=str(draft_model_id) if draft_model_id else ""):
            if draft is not None:
                toks, rounds = self._speculative(loaded, draft, model_id, ids, lengths,
                                                 new_bucket, max_new_tokens, spec_tokens,
                                                 prefix_capable, forced_rows)
                self._spec_observe(model_id, draft_model_id, new_bucket, rounds)
            elif prefix_capable:
                toks = self._prefix_generate(loaded, model_id, ids, int(lengths[0]), new_bucket,
                                             max_new_tokens, temperature, top_k, seed,
                                             forced_rows)
            else:
                toks = generation.generate(
                    loaded.module, cfg, torch.from_numpy(ids).to(self.device),
                    torch.from_numpy(lengths), new_bucket, temperature=temperature,
                    top_k=top_k, seed=seed,
                ).cpu().numpy()
        return toks[:b, :max_new_tokens]

    # -- the solo path's prefix cache (reference :3173-3334) ----------------
    def _prefix_generate(self, loaded: LoadedModel, model_id: ModelId, ids: np.ndarray,
                         prompt_len: int, new_bucket: int, max_new: int, temperature: float,
                         top_k: int, seed: int, forced_rows: int | None = None) -> np.ndarray:
        """B = 1 generate through the prefix cache: reuse the longest cached
        token prefix's K/V rows, prefill only the suffix, and store the
        prompt + completion rows for the next turn. The same math at the
        same positions and the same generator stream as the plain path; the
        suffix-only prefill is another matmul shape, so on the card a
        near-tied argmax can break the other way between hit and miss.
        ``forced_rows``: the group leader's decision (``_prefix_resolve``)."""
        from tfservingcache_tpu_torch.models import generation

        cfg = loaded.model_def.config
        prompt = ids[0, :prompt_len]
        hit = self._prefix_resolve(model_id, prompt, forced_rows)
        if hit is None:
            toks, k_full, v_full = generation.generate(
                loaded.module, cfg, torch.from_numpy(ids).to(self.device),
                torch.tensor([prompt_len]), new_bucket, temperature=temperature, top_k=top_k,
                seed=seed, return_cache=True,
            )
        else:
            suffix, suffix_len = self._prefix_suffix(ids, prompt_len, hit)
            toks, k_full, v_full = generation.generate_from_cache(
                loaded.module, cfg, torch.from_numpy(suffix).to(self.device), suffix_len,
                hit.k, hit.v, hit.valid_len, new_bucket, temperature=temperature, top_k=top_k,
                seed=seed, return_cache=True,
            )
        out = self._prefix_store(model_id, prompt, prompt_len, max_new, toks, k_full, v_full)
        TRACER.annotate(prefix_hit=hit is not None,
                        prefix_rows=0 if hit is None else hit.valid_len)
        if self.metrics is not None:
            (self.metrics.prefix_cache_hits if hit is not None
             else self.metrics.prefix_cache_misses).inc()
            self.metrics.prefix_cache_bytes.set(self._prefix_cache.total_bytes)
        return out

    def _prefix_resolve(self, model_id: ModelId, prompt: np.ndarray,
                        forced_rows: int | None) -> PrefixEntry | None:
        """The hit of the prefix paths, plain and speculative (reference
        :3220): the local lookup, or the group leader's forced decision,
        which this process honours exactly or refuses before any device op
        (0 = a miss, counted; N = the first N rows of a local entry that
        has at least N)."""
        pc = self._prefix_cache
        if forced_rows == 0:
            pc.note_forced_miss()
            return None
        hit = pc.lookup(model_id, prompt)
        if forced_rows is not None and forced_rows > 0:
            if hit is None or hit.valid_len < forced_rows:
                raise RuntimeError_(
                    f"prefix-cache divergence for {model_id}: the leader decided "
                    f"{forced_rows} cached rows, this process has "
                    f"{0 if hit is None else hit.valid_len}: the group's states are out of "
                    "lockstep (re-form required)"
                )
            if hit.valid_len > forced_rows:
                hit = PrefixEntry(hit.tokens[:forced_rows], hit.k, hit.v, forced_rows,
                                  hit.nbytes)
        return hit

    @staticmethod
    def _prefix_suffix(ids: np.ndarray, prompt_len: int,
                       hit: PrefixEntry) -> tuple[np.ndarray, int]:
        """(suffix ids padded to a power of two, true suffix length) after
        ``hit``'s rows."""
        suffix_len = prompt_len - hit.valid_len
        suffix = np.zeros((1, next_bucket(suffix_len)), np.int32)
        suffix[0, :suffix_len] = ids[0, hit.valid_len:prompt_len]
        return suffix, suffix_len

    def _prefix_store(self, model_id: ModelId, prompt: np.ndarray, prompt_len: int,
                      max_new: int, toks: torch.Tensor, k_full: torch.Tensor,
                      v_full: torch.Tensor) -> np.ndarray:
        """Read the tokens back and insert the prompt + completion rows for
        the next turn. The entry stops at the TRUE max_new (the
        bucket-padding generations never reach the client, so the next
        turn's prompt diverges there) and at the power-of-two FLOOR of the
        valid rows (reference :3281), copied out of the request's cache so
        the rest of it is freed."""
        host = toks.cpu().numpy()
        valid = prompt_len + max_new
        l_store = 1 << (valid.bit_length() - 1)
        if l_store >= 16:
            entry_tokens = np.concatenate([prompt, host[0, :max_new]])

            def rows(buf: torch.Tensor | KVShards) -> torch.Tensor | KVShards:
                return like_kv(buf, [t[:, :, :, :l_store].clone() for t in kv_shards(buf)])

            self._prefix_cache.insert(model_id, entry_tokens[:l_store], rows(k_full),
                                      rows(v_full), l_store)
        return host

    def _speculative(self, loaded: LoadedModel, draft: LoadedModel, model_id: ModelId,
                     ids: np.ndarray, lengths: np.ndarray, new_bucket: int, max_new: int,
                     spec_tokens: int, prefix_capable: bool,
                     forced_rows: int | None = None) -> tuple[np.ndarray, int]:
        """Speculative decoding, prefix-cache aware (reference :3296): with
        the cache on and B = 1 the TARGET's prefill starts from the cached
        prefix rows and the completion is stored back, so a draft-assisted
        conversation pays the target's prefill only for its new tokens from
        turn 2. ``forced_rows``: the group leader's prefix decision. ->
        (host tokens, verify rounds)."""
        from tfservingcache_tpu_torch.models.speculative import speculative_generate

        dev_ids = torch.from_numpy(ids).to(self.device)
        common = dict(max_new_tokens=new_bucket, spec_tokens=spec_tokens, return_rounds=True)
        if not prefix_capable:
            toks, rounds = speculative_generate(
                loaded.model_def, loaded.module, draft.model_def, draft.module, dev_ids,
                prompt_lengths=torch.from_numpy(lengths), **common)
            return toks.cpu().numpy(), int(rounds)
        prompt_len = int(lengths[0])
        prompt = ids[0, :prompt_len]
        hit = self._prefix_resolve(model_id, prompt, forced_rows)
        cached_kv = None
        if hit is not None:
            suffix, suffix_len = self._prefix_suffix(ids, prompt_len, hit)
            cached_kv = (torch.from_numpy(suffix), suffix_len, hit.k, hit.v, hit.valid_len)
        toks, rounds, k_full, v_full = speculative_generate(
            loaded.model_def, loaded.module, draft.model_def, draft.module, dev_ids,
            prompt_lengths=torch.tensor([prompt_len]), return_cache=True, cached_kv=cached_kv,
            **common)
        return self._prefix_store(model_id, prompt, prompt_len, max_new, toks, k_full,
                                  v_full), int(rounds)

    # -- continuous-decode slot surface (runtime/batcher.py) ----------------
    def eos_id_of(self, model_id: ModelId) -> int | None:
        """The model's ``eos_id`` config key, None when unset or not resident."""
        loaded = self._resident.get(model_id, touch=False)
        if loaded is None:
            return None
        eos = loaded.model_def.config.get("eos_id")
        return None if eos is None else int(eos)

    def max_seq_of(self, model_id: ModelId) -> int | None:
        loaded = self._resident.get(model_id, touch=False)
        if loaded is None:
            return None
        ms = loaded.model_def.config.get("max_seq")
        return None if ms is None else int(ms)

    def family_of(self, model_id: ModelId) -> str | None:
        loaded = self._resident.get(model_id, touch=False)
        return None if loaded is None else loaded.model_def.family

    def slot_decode_state(
        self,
        model_id: ModelId,
        slots: int,
        page_tokens: int | None = None,
        arena_pages: int | None = None,
        arena_dtype: str | None = None,
        paged_kernel: bool | None = None,
        share_prefix_bytes: int | None = None,
    ) -> SlotDecodeState:
        """Create-or-get the model's slot state (reference :2018). The knobs
        default to the ServingConfig's; ``page_tokens == 0`` keeps the dense
        slot array, ``> 0`` allocates the paged arena (``arena_pages == 0``
        auto-sizes to slots x ceil(max_seq / page_tokens); an int8 arena
        grows to the same byte budget) and, with ``share_prefix_bytes > 0``,
        its radix prefix index. An existing state wins. Allocation runs
        under a per-model once-guard, not under the map lock. A lockstep
        group builds none: the engine sends its requests to the solo path
        (reference :2107-2110 keeps such a state uncut, and no dispatch
        reaches it; the port's tensor-parallel cached forward runs shard by
        shard over a cut cache, so it refuses instead)."""
        if self.mesh_lockstep:
            raise RuntimeError_(
                "a lockstep group (serving.mesh_fast_path: false) builds no slot state; "
                "its :generate runs on the solo path")
        self._lm(model_id, continuous=True)
        with self._slot_lock:
            st = self._slot_states.get(model_id)
            if st is not None:
                return st
            guard = self._slot_init_guards.setdefault(model_id, threading.Lock())
        with guard:
            with self._slot_lock:
                st = self._slot_states.get(model_id)
            if st is not None:
                return st
            st = self._build_slot_state(
                self._lm(model_id, continuous=True), model_id, slots, page_tokens, arena_pages,
                arena_dtype, paged_kernel, share_prefix_bytes,
            )
            with self._slot_lock:
                st = self._slot_states.setdefault(model_id, st)
                self._slot_init_guards.pop(model_id, None)
            self._note_arena_bytes(st)
            return st

    @staticmethod
    def _arena_label(state: SlotDecodeState) -> str:
        return state.arena_dtype or str(state.k.dtype).removeprefix("torch.")

    def _note_arena_bytes(self, state: SlotDecodeState) -> None:
        """``tpusc_gen_kv_arena_bytes{dtype}`` of a freshly built paged
        arena: pages plus an int8 arena's scales, on a group the sum of the
        shards' bytes (``KVShards.nbytes``), what the devices really hold
        (reference :2188-2205)."""
        if self.metrics is None or not state.page_tokens:
            return
        nbytes = state.k.nbytes + state.v.nbytes
        if state.scales is not None:
            nbytes += sum(t.nbytes for t in state.scales.values())
        self.metrics.gen_kv_arena_bytes.labels(dtype=self._arena_label(state)).set(nbytes)

    def _build_slot_state(
        self,
        loaded: LoadedModel,
        model_id: ModelId,
        slots: int,
        page_tokens: int | None,
        arena_pages: int | None,
        arena_dtype: str | None,
        paged_kernel: bool | None,
        share_prefix_bytes: int | None = 0,
    ) -> SlotDecodeState:
        from tfservingcache_tpu_torch.models import generation

        if page_tokens is None:
            page_tokens = int(self.cfg.kv_page_tokens)
        if arena_pages is None:
            arena_pages = int(self.cfg.kv_arena_pages)
        if arena_dtype is None:
            arena_dtype = str(self.cfg.kv_arena_dtype or "")
        if paged_kernel is None:
            paged_kernel = bool(self.cfg.kv_paged_kernel)
        if share_prefix_bytes is None:
            share_prefix_bytes = int(self.cfg.kv_share_prefix_bytes)
        cfg = loaded.model_def.config
        max_seq = int(cfg["max_seq"])
        # a tensor-parallel model's cache is cut over its group's KV heads
        # (whole on the leader where the group does not divide them)
        group = generation.kv_group(loaded.module)
        common = dict(
            model_id=model_id,
            slots=slots,
            max_seq=max_seq,
            tok=np.zeros((slots,), np.int32),
            pos=np.zeros((slots,), np.int32),
            active=np.zeros((slots,), bool),
            temps=np.zeros((slots,), np.float32),
            topks=np.zeros((slots,), np.int32),
            kernel=bool(paged_kernel),
        )
        if page_tokens and page_tokens > 0:
            page_tokens = int(page_tokens)
            pps = -(-max_seq // page_tokens)
            usable = int(arena_pages) if arena_pages else slots * pps
            if not arena_pages and arena_dtype == "int8":
                # byte-matched auto-size: an int8 row is hd bytes + a 4-byte
                # f32 scale against hd * itemsize, so the same budget holds
                # more pages (reference :2129-2143)
                hd = int(cfg["d_model"]) // int(cfg["n_heads"])
                dense_item = torch.empty((), dtype=getattr(torch, cfg["dtype"])).element_size()
                usable = max(usable, (usable * hd * dense_item) // (hd + 4))
            # +1: page 0 is the trash page, permanently reserved
            arena = generation.init_paged_cache(
                cfg, usable + 1, page_tokens, arena_dtype, self.device, group
            )
            scales = None
            if "k_scale" in arena:
                scales = {"k": arena["k_scale"], "v": arena["v_scale"]}
            prefix_index = None
            if share_prefix_bytes and share_prefix_bytes > 0:
                # one page's bytes over K, V and an int8 arena's scales
                page_nbytes = sum(t.nbytes for t in arena.values()) // (usable + 1)
                prefix_index = PagePrefixIndex(page_tokens, page_nbytes, int(share_prefix_bytes))
            return SlotDecodeState(
                k=arena["k"], v=arena["v"], scales=scales, arena_dtype=arena_dtype,
                page_tokens=page_tokens, arena_pages=usable, pages_per_slot=pps,
                block_tables=np.zeros((slots, pps), np.int32),
                free_pages=list(range(1, usable + 1)),
                page_refs=np.zeros((usable + 1,), np.int32),
                prefix_index=prefix_index,
                **common,
            )
        cache = generation.init_cache(cfg, slots, max_seq, self.device, group)
        return SlotDecodeState(k=cache["k"], v=cache["v"], **common)

    def mesh_topology(self) -> dict | None:
        """The group stamp of ``/monitoring/engine`` (reference :2212-2222):
        a runtime bound to a group of P devices is one process driving a
        ``{"model": P}`` group, on the fast path unless lockstep; None on
        one device."""
        if self.group is None:
            return None
        return {
            "mesh_devices": len(self.group),
            "mesh_axes": group_axes(self.group),
            "mesh_fast_path": not self.mesh_lockstep,
        }

    def drop_slot_state(self, model_id: ModelId) -> None:
        with self._slot_lock:
            st = self._slot_states.pop(model_id, None)
        if st is not None and st.page_tokens and self.metrics is not None:
            self.metrics.gen_kv_arena_bytes.labels(dtype=self._arena_label(st)).set(0)

    def slot_prefill(
        self, model_id: ModelId, prompt: np.ndarray, temperature: float, top_k: int,
        seed: int,
    ) -> tuple[int, torch.Tensor, torch.Tensor]:
        """Admission prefill of one request (reference :2232): the prompt
        through a ``(1, P_bucket)`` prefill (reusing a prefix-cache hit's
        rows when one exists; the engine never inserts) and its first token
        sampled from a generator seeded with ``seed``. -> (first token, k,
        v), k/v ready for slot_admit."""
        tok, pk, pv, _hit, _last = self._slot_prefill_impl(model_id, prompt, temperature,
                                                           top_k, seed)
        return tok, pk, pv

    def _slot_prefill_impl(
        self, model_id: ModelId, prompt: np.ndarray, temperature: float, top_k: int,
        seed: int,
    ) -> tuple[int, torch.Tensor, torch.Tensor, bool, torch.Tensor]:
        """slot_prefill's body (reference :2251-2313), also returning whether
        the prefix cache hit and the last-position logits (1, V) f32 on the
        device, which the shared-prefix publisher caches for exact
        re-admissions."""
        from tfservingcache_tpu_torch.models import generation

        loaded = self._lm(model_id, continuous=True)
        cfg = loaded.model_def.config
        max_seq = int(cfg["max_seq"])
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = prompt.shape[0]
        hit = None
        if self._prefix_cache is not None:
            hit = self._prefix_cache.lookup(model_id, prompt)
            if hit is not None and hit.k.shape[3] + next_bucket(p - hit.valid_len) > max_seq:
                hit = None  # the padded hit would overflow the lane
            if self.metrics is not None:
                (self.metrics.prefix_cache_hits if hit is not None
                 else self.metrics.prefix_cache_misses).inc()
        if hit is not None:
            suffix, suffix_len = self._prefix_suffix(prompt[None, :], p, hit)
            tok, pk, pv, last = generation.slot_prefill_from_cache(
                loaded.module, cfg, torch.from_numpy(suffix).to(self.device), suffix_len,
                hit.k, hit.v, hit.valid_len, temperature, top_k, seed,
            )
        else:
            s_pad = next_bucket(p)
            if s_pad > max_seq:
                s_pad = p  # bucket overshoot: exact size (same rule as generate)
            ids = np.zeros((1, s_pad), np.int32)
            ids[0, :p] = prompt
            tok, pk, pv, last = generation.slot_prefill(
                loaded.module, cfg, torch.from_numpy(ids).to(self.device), p,
                temperature, top_k, seed,
            )
        return int(tok[0]), pk, pv, hit is not None, last

    # -- chunked prefill over the paged arena (reference :2317-2385) --------
    def slot_prefill_chunk(self, model_id: ModelId, state: SlotDecodeState, lane: int,
                           tokens: np.ndarray, start: int, chunk_size: int) -> torch.Tensor:
        """Write one prefill chunk into ``lane``'s reserved pages and return
        the chunk's last REAL token's logits (1, V) f32, left on the device
        (only the last chunk's are read, by ``sample_first_token``). The
        chunk is zero-padded to ``chunk_size``: pad rows land past the
        prompt end inside the reservation (or on the trash page past it) and
        decode writes each of them before any query reads it."""
        from tfservingcache_tpu_torch.models import generation

        loaded = self._lm(model_id, continuous=True)
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        t = tokens.shape[0]
        if not 0 < t <= chunk_size:
            raise ValueError(f"prefill chunk of {t} tokens outside (0, {chunk_size}]")
        toks = np.zeros((1, chunk_size), np.int32)
        toks[0, :t] = tokens
        dev = self.device
        return generation.paged_prefill_chunk(
            loaded.module, loaded.model_def.config, _arena(state),
            torch.from_numpy(state.block_tables[lane:lane + 1].copy()).to(dev),
            torch.from_numpy(toks).to(dev), torch.tensor([start], dtype=torch.int32).to(dev),
            t, state.page_tokens, state.kernel,
        )

    def sample_first_token(self, last: torch.Tensor, temperature: float, top_k: int,
                           seed: int) -> int:
        """A request's first token from prefill-final logits (1, V) under its
        own seed: the draw ``slot_prefill`` makes, so a chunked prefill and
        an exact shared-prefix hit give a monolithic prefill's first token
        under the same seed (reference :2365)."""
        from tfservingcache_tpu_torch.models import generation

        return int(generation.sample_logits(last, temperature, top_k, seed)[0])

    # -- shared-prefix KV over the paged arena (reference :2387-2577) -------
    def shared_prefix_plan(self, state: SlotDecodeState,
                           prompt: np.ndarray) -> SharedPrefixPlan | None:
        """Longest viable page-aligned shared prefix of ``prompt`` from the
        state's radix index (None when sharing is off or nothing matches).
        The suffix prefill pads to a power of two, and covered + that
        bucket must fit the lane: mapped pages are shed (each moves
        ``page_tokens`` tokens back into the suffix) until it does."""
        if state.prefix_index is None:
            return None
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = prompt.shape[0]
        plan = state.prefix_index.lookup(prompt)
        if plan is None or plan.kind == "exact":
            return plan
        while plan.n_full > 0 and plan.covered + next_bucket(p - plan.covered) > state.max_seq:
            plan.pages.pop()
            plan.n_full -= 1
        return plan if plan.n_full > 0 else None

    def slot_prefill_shared(
        self, model_id: ModelId, state: SlotDecodeState, prompt: np.ndarray,
        temperature: float, top_k: int, seed: int, plan: SharedPrefixPlan | None,
    ) -> tuple[int, torch.Tensor | None, torch.Tensor | None, str, torch.Tensor]:
        """Admission prefill with shared-prefix reuse -> (first token, pk,
        pv, kind, last logits). ``plan.kind == "exact"``: no prefill — the
        first token is sampled from the publisher's cached logits under THIS
        request's seed; pk/pv are None and the caller skips slot_admit.
        ``"shared"``: gather the mapped full pages to dense rows and prefill
        only the suffix. ``plan is None``: the full (or dense prefix-cache)
        prefill; kind ``"dense"`` on a prefix-cache hit, ``"miss"``
        otherwise."""
        from tfservingcache_tpu_torch.models import generation

        if plan is None:
            tok, pk, pv, hit, last = self._slot_prefill_impl(model_id, prompt, temperature,
                                                             top_k, seed)
            return tok, pk, pv, ("dense" if hit else "miss"), last
        loaded = self._lm(model_id, continuous=True)
        if plan.kind == "exact":
            return self.sample_first_token(plan.logits, temperature, top_k, seed), None, None, \
                "exact", plan.logits
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        covered = plan.covered
        ck, cv = generation.paged_gather_prefix(_arena(state), plan.pages)
        suffix_len = prompt.shape[0] - covered
        suffix = np.zeros((1, next_bucket(suffix_len)), np.int32)
        suffix[0, :suffix_len] = prompt[covered:]
        tok, pk, pv, last = generation.slot_prefill_from_cache(
            loaded.module, loaded.model_def.config, torch.from_numpy(suffix).to(self.device),
            suffix_len, ck, cv, covered, temperature, top_k, seed,
        )
        return int(tok[0]), pk, pv, "shared", last

    def slot_cow(self, state: SlotDecodeState, lane: int, slot: int) -> None:
        """Copy-on-write: give ``lane`` a private copy of the page behind its
        block-table ``slot`` before its first write lands there. Raises when
        no page is free (admission reserves cow_headroom so that it never
        does)."""
        from tfservingcache_tpu_torch.models import generation

        swap = state.cow_page(lane, slot)
        if swap is None:
            raise RuntimeError_(
                f"CoW for lane {lane} slot {slot}: free list empty "
                "(cow_headroom was not reserved?)"
            )
        generation.page_copy(_arena(state), *swap)

    def shared_prefix_publish(self, state: SlotDecodeState, lane: int, prompt: np.ndarray,
                              last_logits: torch.Tensor | None) -> None:
        """After admitting ``lane``, publish its prompt's pages into the radix
        index. Full page chunks are indexed IN PLACE (the index increfs the
        lane's own pages; the lane only writes past the prompt). A part-filled
        boundary page is copied at once into a free page for the index (the
        lane keeps decoding into its original), so the indexed copy stays
        pristine and neither side ever needs CoW against the other. Nothing
        is published when no page is shareable, and the tail is dropped when
        no page is free for its copy."""
        from tfservingcache_tpu_torch.models import generation

        idx = state.prefix_index
        if idx is None:
            return
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = prompt.shape[0]
        pt = state.page_tokens
        n_full = p // pt
        tail_len = p - n_full * pt
        lane_pg = state.lane_pages.get(lane)
        if lane_pg is None or len(lane_pg) < state.pages_needed(p):
            return
        boundary = None
        if tail_len and last_logits is not None and state.free_pages:
            boundary = state.free_pages.pop()
            generation.page_copy(_arena(state), lane_pg[n_full], boundary)
        added, released = idx.insert(prompt, lane_pg[:n_full], boundary, last_logits,
                                     state.page_refs)
        for pg in added:
            state.page_refs[pg] += 1
        for pg in released:
            n = int(state.page_refs[pg]) - 1
            state.page_refs[pg] = max(n, 0)
            if n <= 0:
                state.free_pages.append(pg)
        if boundary is not None and boundary not in added:
            state.free_pages.append(boundary)  # the index declined the tail

    def reclaim_prefix_pages(self, state: SlotDecodeState, want_pages: int,
                             protect: list | tuple = ()) -> int:
        """Admission pressure: evict cold index-only prefix pages (no lane
        maps them; never ``protect``, the blocked request's own plan pages)
        back onto the free list, so a live admission never loses a page to
        cold cache. -> how many pages were freed."""
        if state.prefix_index is None:
            return 0
        released = state.prefix_index.reclaim(state.page_refs, want_pages,
                                              frozenset(int(p) for p in protect))
        freed = 0
        for pg in released:
            n = int(state.page_refs[pg]) - 1
            state.page_refs[pg] = max(n, 0)
            if n <= 0:
                state.free_pages.append(pg)
                freed += 1
        return freed

    # -- conversation KV park / resume (reference :2583-2736) -----------------
    def park_lane(self, state: SlotDecodeState, lane: int,
                  history: np.ndarray) -> ParkedConversation | None:
        """Export a lane's live pages for parking (cache/conversation_kv.py):
        host copies of the pages covering ``history`` (the token prefix whose
        K/V rows the lane holds), raw arena dtype plus an int8 arena's
        scales, never dequantized. Read-only on the arena: the caller still
        releases the lane's pages, so the census never counts a parked page.
        None when there is nothing to park: a dense state, an empty history,
        or a reservation that no longer covers it."""
        from tfservingcache_tpu_torch.models import generation

        if not state.paged:
            return None
        history = np.asarray(history, np.int32).reshape(-1)
        if history.shape[0] <= 0:
            return None
        n = state.pages_needed(history.shape[0])
        pages = state.lane_pages.get(lane)
        if pages is None or len(pages) < n or n == 0:
            return None
        rows = generation.pages_export(_arena(state), pages[:n])
        k, dtype = host_pages(rows["k"])
        v, _ = host_pages(rows["v"])
        return ParkedConversation(
            model_id=str(state.model_id),
            history=history.copy(),
            pages_k=k,
            pages_v=v,
            k_scale=rows["k_scale"].cpu().numpy() if "k_scale" in rows else None,
            v_scale=rows["v_scale"].cpu().numpy() if "v_scale" in rows else None,
            page_tokens=state.page_tokens,
            page_dtype=dtype,
        )

    def plan_conversation_resume(self, state: SlotDecodeState, prompt: np.ndarray,
                                 parked: ParkedConversation | None) -> tuple[int, int] | None:
        """Can ``prompt`` resume from ``parked``? -> (covered, n_pages): the
        longest common token prefix of the parked history and the prompt
        (at least one suffix token is left to prefill) and the parked pages
        that cover it. ``covered`` need not be page-aligned: the suffix
        insert overwrites the boundary page's stale tail. Whole pages are
        shed while covered + the suffix's power-of-two bucket would overflow
        the lane. None when nothing resumes: another page size, arena layout
        or dtype, scales on one side only, a first token that differs, or a
        trim that shed everything."""
        if parked is None or not state.paged:
            return None
        if int(parked.page_tokens) != state.page_tokens:
            return None
        shape = tuple(parked.pages_k.shape)
        arena = tuple(state.k.shape)
        if len(shape) != 5 or shape[0] != arena[0] or shape[2:] != arena[2:]:
            return None
        if parked.page_dtype != str(state.k.dtype).removeprefix("torch."):
            return None
        if (state.scales is None) != (parked.k_scale is None):
            return None
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = prompt.shape[0]
        hist = np.asarray(parked.history, np.int32).reshape(-1)
        m = min(p - 1, hist.shape[0])
        if m <= 0:
            return None
        eq = hist[:m] == prompt[:m]
        covered = m if eq.all() else int(np.argmax(~eq))
        # never resume past the pages actually parked
        covered = min(covered, int(shape[1]) * state.page_tokens)
        while covered > 0 and covered + next_bucket(p - covered) > state.max_seq:
            covered = (state.pages_needed(covered) - 1) * state.page_tokens
        if covered <= 0:
            return None
        return covered, state.pages_needed(covered)

    def slot_resume_prefill(
        self, model_id: ModelId, state: SlotDecodeState, lane: int, prompt: np.ndarray,
        parked: ParkedConversation, covered: int, n_pages: int, temperature: float,
        top_k: int, seed: int,
    ) -> tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Resume admission prefill: write the parked pages into the first
        ``n_pages`` of ``lane``'s freshly reserved private pages (one batched
        index copy a buffer), gather the covered prefix to dense rows and
        prefill only the suffix -> (first token, pk, pv, last logits), pk/pv
        ready for ``slot_admit(..., base_tokens=covered)``. The first token
        is drawn as a full prefill draws it under the same seed, over the
        same K/V rows."""
        from tfservingcache_tpu_torch.models import generation

        loaded = self._lm(model_id, continuous=True)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = prompt.shape[0]
        pages = state.lane_pages[lane][:n_pages]
        arena = _arena(state)
        dev = state.k.device
        payload = {
            "k": device_pages(parked.pages_k[:, :n_pages], parked.page_dtype, dev),
            "v": device_pages(parked.pages_v[:, :n_pages], parked.page_dtype, dev),
        }
        if state.scales is not None:
            payload["k_scale"] = device_pages(parked.k_scale[:, :n_pages], "float32", dev)
            payload["v_scale"] = device_pages(parked.v_scale[:, :n_pages], "float32", dev)
        generation.pages_import(arena, pages, payload)
        ck, cv = generation.paged_gather_prefix(arena, pages)
        suffix_len = p - covered
        suffix = np.zeros((1, next_bucket(suffix_len)), np.int32)
        suffix[0, :suffix_len] = prompt[covered:]
        tok, pk, pv, last = generation.slot_prefill_from_cache(
            loaded.module, loaded.model_def.config, torch.from_numpy(suffix).to(dev),
            suffix_len, ck, cv, covered, temperature, top_k, seed,
        )
        return int(tok[0]), pk, pv, last

    def slot_admit(self, state: SlotDecodeState, idx: int, pk: torch.Tensor,
                   pv: torch.Tensor, base_tokens: int = 0) -> None:
        """Copy an admitted request's prefill K/V into lane ``idx`` in place
        (reference :2737). A paged state must have the lane's pages reserved
        first: the insert scatters through the lane's block-table row.
        ``base_tokens`` is the shared-prefix boundary: rows below it belong
        to read-only shared pages and go to the trash page."""
        from tfservingcache_tpu_torch.models import generation

        if state.paged:
            row = torch.from_numpy(state.block_tables[idx].copy()).to(self.device)
            generation.paged_insert(_arena(state), pk, pv, row, state.page_tokens,
                                    base=int(base_tokens))
            return
        generation.slot_insert(state.k, state.v, pk, pv, idx)

    def slot_decode_chunk(self, state: SlotDecodeState, chunk: int) -> np.ndarray:
        """Advance every active lane by ``chunk`` decode steps (reference
        :2765). The host mirrors are copied to the device once, the steps
        run without a host sync, and ``toks``/``tok``/``pos`` come back once
        at the end. Updates the state's K/V in place and its tok/pos
        mirrors; returns the (S, chunk) emitted tokens. Raises
        ModelNotLoadedError when the model was evicted mid-decode."""
        from tfservingcache_tpu_torch.models import generation

        loaded = self._resident.get(state.model_id)
        if loaded is None:
            raise ModelNotLoadedError(f"model {state.model_id} is not loaded")
        cfg = loaded.model_def.config
        state.chunk_counter += 1
        dev = self.device
        gen = None
        if (state.temps > 0).any():  # host mirror: every-lane-greedy draws nothing
            gen = torch.Generator(device=dev).manual_seed(state.chunk_counter)
        tok = torch.from_numpy(state.tok.astype(np.int64)).to(dev)
        active = torch.from_numpy(state.active.copy()).to(dev)
        temps = torch.from_numpy(state.temps.copy()).to(dev)
        topks = torch.from_numpy(state.topks.copy()).to(dev)
        if state.paged:
            if _PAGECHECK:
                _check_trash_unreachable(state)
            tables = torch.from_numpy(state.block_tables.copy()).to(dev)
            pos = torch.from_numpy(state.pos.copy()).to(dev)
            tok, pos, toks = generation.paged_decode_chunk(
                loaded.module, cfg, _arena(state), tables, tok, pos, active, gen, temps, topks,
                chunk, state.page_tokens, state.kernel,
            )
        else:
            pos = torch.from_numpy(state.pos.astype(np.int64)).to(dev)
            tok, pos, toks = generation.decode_chunk(
                loaded.module, cfg, state.k, state.v, tok, pos, active, gen, temps,
                topks, chunk,
            )
        # np.array (a writable copy): the scheduler writes these mirrors
        state.tok = np.array(tok.cpu().numpy(), dtype=np.int32)
        state.pos = np.array(pos.cpu().numpy(), dtype=np.int32)
        return toks.cpu().numpy().astype(np.int32)

    def slot_attach_draft(self, state: SlotDecodeState, draft_id: ModelId,
                          spec_tokens: int = 4) -> SlotDecodeState:
        """Attach ``draft_id``'s decode state to ``state`` for in-engine
        speculative rounds (reference :2811-2868): the draft's own paged
        arena with the target's slot count, page size, arena dtype and
        kernel flag (auto-sized like the target's), pinned on
        ``state.spec_draft`` so it lives and dies with the target state (it
        is NOT registered in ``_slot_states``). Idempotent for the same
        draft. The draft must be resident, a transformer_lm and share the
        target's vocabulary; the target state must be paged.
        ``spec_tokens`` is clamped to {1, 2, 4, 8}."""
        if state.spec_draft is not None and state.spec_draft_id == draft_id:
            return state.spec_draft
        if not state.paged:
            raise RuntimeError_(
                "in-engine speculation requires a paged slot state "
                "(serving.kv_page_tokens > 0)"
            )
        loaded = self._resident.get(state.model_id)
        draft = self._resident.get(draft_id)
        if loaded is None or draft is None:
            missing = state.model_id if loaded is None else draft_id
            raise ModelNotLoadedError(f"model {missing} is not loaded")
        if draft.model_def.family != "transformer_lm":
            raise RuntimeError_(
                "continuous speculation supports transformer_lm drafts "
                f"only, not {draft.model_def.family!r}"
            )
        if draft.model_def.config["vocab_size"] != loaded.model_def.config["vocab_size"]:
            raise RuntimeError_(
                "draft and target must share a vocabulary: "
                f"{draft.model_def.config['vocab_size']} vs "
                f"{loaded.model_def.config['vocab_size']}"
            )
        if spec_tokens < 1:
            raise RuntimeError_(f"spec_tokens must be >= 1, got {spec_tokens}")
        d_st = self._build_slot_state(
            draft, draft_id, state.slots, state.page_tokens, 0, state.arena_dtype, state.kernel,
        )
        # host mirrors alias the target's: both caches always sit at the
        # same accepted positions, so one array serves both censuses
        d_st.tok, d_st.pos, d_st.active = state.tok, state.pos, state.active
        state.spec_draft_id = draft_id
        state.spec_draft = d_st
        state.spec_tokens = next_bucket(min(int(spec_tokens), SPEC_TOKENS_MAX))
        return d_st

    def slot_decode_spec_round(self, state: SlotDecodeState) -> tuple[np.ndarray, np.ndarray]:
        """One speculative draft/verify round for every active lane — the
        spec counterpart of ``slot_decode_chunk`` (reference :2871-2928):
        host mirrors to the device once, one sync at the end. Requires an
        attached draft. -> (toks (S, spec+1), accept (S,)): lane ``s``
        emitted ``toks[s, :accept[s]]`` (0 for frozen lanes). Raises
        ModelNotLoadedError naming whichever half of the pair was evicted;
        then nothing was updated."""
        from tfservingcache_tpu_torch.models.speculative import paged_spec_round

        d_st = state.spec_draft
        if d_st is None:
            raise RuntimeError_("no draft attached (slot_attach_draft)")
        loaded = self._resident.get(state.model_id)
        if loaded is None:
            raise ModelNotLoadedError(f"model {state.model_id} is not loaded")
        d_loaded = self._resident.get(d_st.model_id)
        if d_loaded is None:
            raise ModelNotLoadedError(f"draft model {d_st.model_id} is not loaded")
        # admission may have rebound the target's mirrors: re-alias first
        d_st.tok, d_st.pos, d_st.active = state.tok, state.pos, state.active
        state.chunk_counter += 1
        if _PAGECHECK:
            _check_trash_unreachable(state)
            _check_trash_unreachable(d_st)
        dev = self.device
        gen = None
        if (state.temps > 0).any():  # host mirror: every-lane-greedy draws nothing
            gen = torch.Generator(device=dev).manual_seed(state.chunk_counter)
        tok, pos, toks, accept = paged_spec_round(
            loaded.module, loaded.model_def.config, d_loaded.module, d_loaded.model_def.config,
            _arena(state), _arena(d_st),
            torch.from_numpy(state.block_tables.copy()).to(dev),
            torch.from_numpy(d_st.block_tables.copy()).to(dev),
            torch.from_numpy(state.tok.astype(np.int64)).to(dev),
            torch.from_numpy(state.pos.copy()).to(dev),
            torch.from_numpy(state.active.copy()).to(dev), gen,
            torch.from_numpy(state.temps.copy()).to(dev),
            torch.from_numpy(state.topks.copy()).to(dev),
            state.spec_tokens, state.page_tokens, state.kernel,
        )
        # np.array (a writable copy): the scheduler writes these mirrors
        state.tok = np.array(tok.cpu().numpy(), dtype=np.int32)
        state.pos = np.array(pos.cpu().numpy(), dtype=np.int32)
        d_st.tok, d_st.pos = state.tok, state.pos
        return (toks.cpu().numpy().astype(np.int32),
                np.array(accept.cpu().numpy(), dtype=np.int32))

    # -- speculative health gate (reference :3105-3170) ---------------------
    def _spec_admit(self, target: ModelId, draft: ModelId) -> bool:
        """Should this request (or engine round) run its draft? False once
        sustained low acceptance disabled the pair; every
        SPEC_REPROBE_EVERY-th gated call re-auditions the draft."""
        with self._spec_lock:
            st = self._spec_health.get((target, draft))
            if st is None or not st["disabled"]:
                return True
            st["skipped"] += 1
            return st["skipped"] % SPEC_REPROBE_EVERY == 0

    def _spec_observe(self, target: ModelId, draft: ModelId, emitted: int, rounds: int,
                      engine: str = "solo") -> None:
        """Record one speculative generate's (or engine boundary's)
        acceptance and flip the pair's disabled flag on a sustained low
        streak. ``engine`` labels the cumulative counters."""
        tpr = emitted / max(1, rounds)
        with self._spec_lock:
            self.spec_rounds[engine] += int(rounds)
            self.spec_emitted[engine] += int(emitted)
        if self.metrics is not None:
            label = self.metrics.model_label(target.name, target.version)
            self.metrics.spec_tokens_per_round.labels(model=label).set(round(tpr, 3))
            self.metrics.spec_accepted_tokens.labels(engine=engine).inc(int(emitted))
            self.metrics.spec_rounds.labels(engine=engine).inc(int(rounds))
        if not (self.is_loaded(target) and self.is_loaded(draft)):
            # either half unloaded mid-generate: recording would resurrect
            # the pair entry unload() just pruned
            return
        with self._spec_lock:
            st = self._spec_health.setdefault(
                (target, draft), {"low_streak": 0, "disabled": False, "skipped": 0})
            if tpr >= SPEC_MIN_TOKENS_PER_ROUND:
                if st["disabled"]:
                    log.info("draft %s re-enabled for %s (%.2f tokens/round)", draft, target, tpr)
                st.update(low_streak=0, disabled=False, skipped=0)
                return
            st["low_streak"] += 1
            if not st["disabled"] and st["low_streak"] >= SPEC_DISABLE_AFTER:
                st["disabled"] = True
                st["skipped"] = 0
                log.warning(
                    "draft %s auto-disabled for %s: %d consecutive generates below %.1f "
                    "tokens/round (last %.2f); falling back to plain decode (re-audition "
                    "every %d requests)", draft, target, SPEC_DISABLE_AFTER,
                    SPEC_MIN_TOKENS_PER_ROUND, tpr, SPEC_REPROBE_EVERY,
                )
                if self.metrics is not None:
                    self.metrics.spec_draft_autodisabled.inc()

    def _spec_forget(self, model_id: ModelId) -> None:
        """Drop the acceptance history of every pair ``model_id`` is in,
        in either role."""
        with self._spec_lock:
            for pair in [p for p in self._spec_health if model_id in p]:
                del self._spec_health[pair]

    # -- residency ----------------------------------------------------------
    def _on_evict(self, model_id: ModelId, entry: LRUEntry[LoadedModel]) -> None:
        self._set_state(model_id, ModelState.UNLOADING)
        if self._prefix_cache is not None:
            # an unloaded model's prefix K/V must not outlive it on the card
            self._prefix_cache.drop_model(model_id)
        # the slot state (and a draft state attached to it) goes with the model
        self.drop_slot_state(model_id)
        # acceptance history dies with either half of a pair
        self._spec_forget(model_id)
        # demotion (device -> host tier): the eager retain at load makes it
        # an LRU touch; a model whose entry was skipped or evicted from the
        # tier meanwhile is copied back off the device by the demote worker,
        # never here (the evicting thread may hold a load lock). The queued
        # LoadedModel keeps the device tensors alive until the copy is done.
        if (self._host_tier is not None and not self._closing.is_set()
                and not self._host_tier.touch(model_id)):
            self._demote_queue.put(("demote", model_id, entry.payload))
        # only the LRU's reference goes: an in-flight predict holding the
        # LoadedModel keeps its tensors alive until it finishes
        self._set_state(model_id, ModelState.END)
        with self._load_locks_guard:
            lock = self._load_locks.get(model_id)
            if lock is not None and not lock.locked():
                del self._load_locks[model_id]
        if self.metrics is not None:
            self.metrics.evictions.labels("hbm").inc()
        self._update_gauges()
        log.info("unloaded %s (freed %d device bytes)", model_id, entry.size_bytes)

    def unload(self, model_id: ModelId) -> None:
        self._resident.remove(model_id, run_callback=True)
        # _on_evict prunes the spec pairs only of a RESIDENT model; an
        # unload of a non-resident id must drop them too (reference :2986)
        self._spec_forget(model_id)

    def is_loaded(self, model_id: ModelId) -> bool:
        return self._resident.get(model_id, touch=False) is not None

    # -- host-RAM warm tier (reference :3000-:3090) -------------------------
    @property
    def host_tier_enabled(self) -> bool:
        return self._host_tier is not None

    def host_tier_contains(self, model_id: ModelId) -> bool:
        """Advisory residency probe (the router's warmth, the fleet status)."""
        return self._host_tier is not None and model_id in self._host_tier

    def unload_and_discard(self, model_id: ModelId) -> None:
        """The disk tier's evict hook: drop the device residency AND the
        host entry (tiers are inclusive downward: a host entry implies the
        artifact is on disk). The trailing queue item runs after any
        demotion the unload itself queued (one FIFO worker), so the discard
        wins whatever the interleaving."""
        self.unload(model_id)
        if self._host_tier is not None:
            self._host_tier.remove(model_id)
            self._demote_queue.put(("discard", model_id, None))

    def drain_demotions(self) -> None:
        """Block until every queued demotion and discard has run."""
        if self._demote_queue is not None:
            self._demote_queue.join()

    def _retain_packed(self, mid: ModelId, model_def: ModelDef, params: Any, hbm_bytes: int,
                       captured: list | None = None) -> None:
        """Put ``mid``'s packed entry in the host tier. Advisory: a failure
        only means the model reloads the full way next time."""
        if self._host_tier is None:
            return
        try:
            entry = build_packed_entry(model_def, params, hbm_bytes, captured=captured,
                                       pin=self.device.type == "cuda")
            self._host_tier.put(mid, entry)
        except Exception as e:  # noqa: BLE001 - advisory by design
            log.warning("host-tier retain of %s skipped: %s", mid, e)

    def _demote_loop(self) -> None:
        """The demote worker: the only thread that copies models back off
        the device, and the point that orders discards after demotions."""
        while True:
            item = self._demote_queue.get()
            try:
                if item is None:
                    return
                kind, mid, payload = item
                if kind == "demote":
                    self._demote_impl(mid, payload)
                elif not self.is_loaded(mid):  # "discard"
                    self._host_tier.remove(mid)
            except Exception:  # noqa: BLE001 - the worker survives any job
                log.exception("host-tier demotion failed")
            finally:
                self._demote_queue.task_done()

    def _demote_impl(self, mid: ModelId, loaded: LoadedModel) -> None:
        if self._host_tier is None or mid in self._host_tier:
            return
        if self.is_loaded(mid):
            # re-admitted while queued: its load retained a fresh entry
            return
        # each device chunk's leaves copied back into page-locked chunks; a
        # tensor-parallel model's leaves gathered whole first (the entry
        # holds whole leaves, as the disk load's retain does)
        params = loaded.params
        if loaded.tensor_parallel:
            params = _tree_map(
                lambda x: gather_leaf(x) if isinstance(x, ShardedLeaf) else x, params)
        self._retain_packed(mid, loaded.model_def, params, loaded.nbytes)

    def resident_models(self) -> list[ModelId]:
        return self._resident.keys_mru_first()

    def reset_group_state(self) -> None:
        """Drop every resident model, the host tier, the prefix K/V, the slot
        states and the draft-acceptance history (reference :3385-3405): the
        empty state a re-forming cross-process group resets every process
        to (``parallel/multihost.py``), since the survivors' states cannot
        be proven equal after a follower failure; models load again on
        demand."""
        for mid in self.resident_models():
            self._resident.remove(mid, run_callback=True)
        if self._host_tier is not None:
            # the removals may have queued demotions that would refill the
            # tier after the clear
            self.drain_demotions()
            self._host_tier.clear()
        if self._prefix_cache is not None:
            self._prefix_cache.clear()
        with self._slot_lock:
            self._slot_states.clear()
            self._slot_init_guards.clear()
        with self._spec_lock:
            self._spec_health.clear()

    def resident_headroom(self) -> tuple[int | None, int]:
        """(free resident-model slots, None when uncapped; free bytes of
        ``hbm_capacity_bytes``): what the assignment warmer may fill without
        evicting a model that serves."""
        max_items = self._resident.max_items
        free_slots = None if max_items is None else max(0, max_items - len(self._resident))
        return free_slots, max(0, self.cfg.hbm_capacity_bytes - self._resident.total_bytes)

    def signature(self, model_id: ModelId):
        loaded = self._resident.get(model_id, touch=False)
        if loaded is None:
            raise ModelNotLoadedError(f"model {model_id} is not loaded")
        d = loaded.model_def
        # derived outputs advertised beside the concrete ones
        out_spec = dict(d.output_spec)
        out_spec.update({name: spec for name, (_fn, spec) in d.derived_outputs.items()})
        return d.input_spec, out_spec, d.method_name

    def check(self) -> None:
        """Health probe: every device of the runtime that this process owns
        must answer a trivial computation."""
        for dev in dict.fromkeys(self.group or (self.device,)):
            if is_remote(dev):
                continue
            x = torch.ones(8, device=dev)
            if float(x.sum()) != 8.0:
                raise RuntimeError_(f"device smoke computation on {dev} returned wrong result")

    @property
    def hbm_bytes_in_use(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.memory_allocated(self.device)
        return self._resident.total_bytes

    def _update_gauges(self) -> None:
        """Re-stamp the residency gauges after a load or an eviction
        (reference :3404-3427): every resident tenant's device level in the
        ledger (the just-evicted zeroed by the owner-scoped sweep), the
        device bytes in use with their scrape-interval peak, and the
        resident count."""
        LEDGER.gauge_sync(
            "hbm_bytes",
            {str(mid): float(e.size_bytes) for mid, e in self._resident.items_lru_first()},
            owner=f"hbm:{id(self)}",
        )
        in_use = self.hbm_bytes_in_use
        # a port node serves one device group: group label "0"
        peak = RECORDER.observe_watermark("hbm_bytes:g0", float(in_use))
        if self.metrics is None:
            return
        group = "0"
        self.metrics.hbm_bytes_in_use.labels(group).set(in_use)
        self.metrics.hbm_bytes_peak.labels(group).set(peak)
        self.metrics.models_resident.labels(group).set(len(self._resident))

    def close(self) -> None:
        """Stop the demote worker and join it and any chunk assembler, each
        with a deadline, then drop every resident model and state."""
        self._closing.set()
        if self._host_tier is not None:
            self._host_tier.close()  # put() no-ops from here on
            self._demote_queue.put(None)  # the worker exits after queued jobs
            self._demote_thread.join(timeout=5.0)
        for worker in list(self._assemblers):
            worker.join(timeout=5.0)
        with self._adopted_lock:
            self._adopted.clear()
        self._resident.clear()
        if self._prefix_cache is not None:
            self._prefix_cache.clear()
        with self._slot_lock:
            self._slot_states.clear()
