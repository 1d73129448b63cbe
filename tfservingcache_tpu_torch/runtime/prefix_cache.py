"""Prefix KV reuse for ``:generate``: the solo path's prefix cache and the
continuous engine's radix page index.

Counterpart of ``tfservingcache_tpu/runtime/prefix_cache.py`` (same names,
same matching rules, same byte totals), host code only:

  - ``PrefixCache`` (solo path, B = 1): a byte-budgeted LRU of dense K/V row
    blocks ``(layers, 1, n_kv, L, hd)`` on the device plus the exact token
    ids those rows encode. Turn N of a conversation extends turn N-1's
    prompt + completion, so a lookup matches the longest cached entry whose
    tokens are a strict prefix of the new prompt, token for token, and the
    prefill runs only over the suffix. Entries are bucketed per model;
    ``drop_model`` runs when a model is unloaded.
  - ``PagePrefixIndex`` (continuous engine over a paged arena): a radix
    index from token prefix to the ARENA PAGES that already hold that
    prefix's K/V, so concurrent rows with one system prompt map the same
    pages read-only instead of each prefilling a private copy. It stores no
    K/V itself; its page holds are mirrored into the slot state's
    ``page_refs`` by the caller. The cached last-position logits of an
    indexed prompt stay where the engine made them (a device tensor), so an
    exact hit samples its first token without a host round trip.

The reference decorates ``PrefixCache`` with its lock checker; the port
keeps the lock and the guarded-by notes without it. ``peek`` and
``note_forced_miss`` serve the leader of a group that spans processes
(``parallel/multihost.py``), which decides every hit for the group.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tfservingcache_tpu_torch.types import ModelId


@dataclass
class PrefixEntry:
    tokens: np.ndarray          # (L,) int32: what the valid rows encode
    k: Any                      # (layers, 1, n_kv, Lpad, hd) device tensor
    v: Any
    valid_len: int              # L <= Lpad
    nbytes: int


# lookup() scans one model's entries under the lock; this cap keeps the
# B = 1 :generate path O(small) whatever the byte budget (reference :49)
_MAX_ENTRIES_PER_MODEL = 32


class PrefixCache:
    def __init__(self, capacity_bytes: int) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        # per-model LRU of entries (token bytes -> entry), with a global
        # recency order across models for byte-budget eviction
        self._by_model: dict[ModelId, OrderedDict[bytes, PrefixEntry]] = {}  # guarded-by: _lock
        self._recency: OrderedDict[tuple[ModelId, bytes], None] = OrderedDict()  # guarded-by: _lock
        self._total = 0  # guarded-by: _lock
        self.hits = 0
        self.misses = 0

    def _best_match(self, model_id: ModelId,  # lock-held: _lock
                    prompt: np.ndarray) -> tuple[bytes | None, int]:
        """(backing key, usable rows) of the longest entry whose tokens are
        a STRICT prefix of ``prompt`` (at least one suffix token must remain
        to prefill)."""
        best_tok, best = None, 0
        for tok_bytes, ent in self._by_model.get(model_id, {}).items():
            usable = min(ent.valid_len, prompt.shape[0] - 1)
            if usable < 1 or usable <= best:
                continue
            if np.array_equal(ent.tokens[:usable], prompt[:usable]):
                best_tok, best = tok_bytes, usable
        return best_tok, best

    def lookup(self, model_id: ModelId, prompt: np.ndarray) -> PrefixEntry | None:
        """Longest strict-prefix entry (see ``_best_match``), counted and
        touched; an entry usable only in part is presented at the usable
        length (the suffix prefill overwrites the rows past it)."""
        prompt = np.asarray(prompt, np.int32)
        with self._lock:
            best_tok, usable = self._best_match(model_id, prompt)
            best: PrefixEntry | None = None
            if best_tok is not None:
                ent = self._by_model[model_id][best_tok]
                if usable < ent.valid_len:
                    ent = PrefixEntry(ent.tokens[:usable], ent.k, ent.v, usable, ent.nbytes)
                best = ent
            if best is not None:
                self._recency.move_to_end((model_id, best_tok))
                # the per-model order is an LRU too: the entry cap evicts its front
                self._by_model[model_id].move_to_end(best_tok)
                self.hits += 1
            else:
                self.misses += 1
        return best

    def insert(self, model_id: ModelId, tokens: np.ndarray, k, v, valid_len: int) -> None:
        tokens = np.asarray(tokens, np.int32)[:valid_len]
        nbytes = int(k.nbytes) + int(v.nbytes)
        if nbytes > self.capacity_bytes:
            return  # one entry over budget: don't thrash the whole cache
        tok_bytes = tokens.tobytes()
        with self._lock:
            model_entries = self._by_model.setdefault(model_id, OrderedDict())
            old = model_entries.pop(tok_bytes, None)
            if old is not None:
                self._total -= old.nbytes
                self._recency.pop((model_id, tok_bytes), None)
            while self._total + nbytes > self.capacity_bytes and self._recency:
                (ev_mid, ev_tok), _ = self._recency.popitem(last=False)
                ev = self._by_model.get(ev_mid, {}).pop(ev_tok, None)
                if ev is not None:
                    self._total -= ev.nbytes
            model_entries[tok_bytes] = PrefixEntry(tokens, k, v, valid_len, nbytes)
            self._recency[(model_id, tok_bytes)] = None
            self._total += nbytes
            while len(model_entries) > _MAX_ENTRIES_PER_MODEL:
                ev_tok, ev = model_entries.popitem(last=False)
                self._total -= ev.nbytes
                self._recency.pop((model_id, ev_tok), None)

    def peek(self, model_id: ModelId, prompt: np.ndarray) -> int:
        """The usable row count of the best entry for ``prompt`` (0 = a
        miss), touching neither recency nor the hit and miss counts
        (reference :141): the leader of a group that spans processes peeks
        under its op lock to form the envelope's decision; the lookup itself
        runs inside ``generate`` in every process."""
        prompt = np.asarray(prompt, np.int32)
        with self._lock:
            return self._best_match(model_id, prompt)[1]

    def note_forced_miss(self) -> None:
        """Count a miss decided upstream (an envelope's ``prefix_rows`` 0):
        the local lookup was skipped, the miss happened all the same."""
        with self._lock:
            self.misses += 1

    def drop_model(self, model_id: ModelId) -> None:
        """Model unloaded or evicted: its prefix K/V goes with it."""
        with self._lock:
            entries = self._by_model.pop(model_id, None)
            if not entries:
                return
            for tok_bytes, ent in entries.items():
                self._total -= ent.nbytes
                self._recency.pop((model_id, tok_bytes), None)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def __len__(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._by_model.values())

    def clear(self) -> None:
        with self._lock:
            self._by_model.clear()
            self._recency.clear()
            self._total = 0


# ---------------------------------------------------------------------------
# Shared-prefix KV over the paged arena: a radix index from token prefix to
# the arena pages that hold it (reference :182-463)
# ---------------------------------------------------------------------------

@dataclass
class SharedPrefixPlan:
    """One admission's shared-prefix decision, from ``PagePrefixIndex.lookup``
    (trimmed for viability by ``TorchModelRuntime.shared_prefix_plan``).

    ``kind == "shared"``: map ``pages`` (full page-aligned chunks of the
    prompt) read-only and prefill only the suffix. ``kind == "exact"``: the
    whole prompt is indexed: map ``pages`` plus ``boundary_page`` (the
    index-held copy of the part-filled last page, when ``tail_len > 0``) and
    skip the prefill; the first token is sampled from ``logits`` (the
    publisher's last-position prefill logits) under the new request's own
    seed, so it equals a cold prefill's under that seed."""

    kind: str                        # "exact" | "shared"
    pages: list[int]                 # full-chunk pages, prompt order
    n_full: int                      # == len(pages)
    page_tokens: int = 0
    boundary_page: int | None = None  # exact only, tail_len > 0
    tail_len: int = 0                # prompt tokens inside the boundary page
    logits: Any = None               # (1, V) f32, exact only

    @property
    def covered(self) -> int:
        """Prompt tokens whose K/V the mapped full pages already hold."""
        return self.n_full * self.page_tokens

    def mapped_pages(self) -> list[int]:
        out = list(self.pages)
        if self.kind == "exact" and self.boundary_page is not None:
            out.append(self.boundary_page)
        return out


class _RadixNode:
    """One full ``page_tokens``-token chunk of an indexed prompt: the node's
    page holds that chunk's K/V; children extend the prefix by one chunk;
    ``tails`` end prompts mid-page."""

    __slots__ = ("page", "children", "tails", "last_used")

    def __init__(self, page: int = 0) -> None:
        self.page = page
        self.children: dict[bytes, _RadixNode] = {}
        self.tails: dict[bytes, _Tail] = {}
        self.last_used = 0


@dataclass
class _Tail:
    """Terminal entry of a prompt that ends mid-page (or page-aligned): the
    index's pristine copy of the boundary page (None for a page-aligned
    prompt) and the publisher's last-position prefill logits, which let an
    exact re-admission skip the prefill."""

    page: int | None
    logits: Any                      # (1, V) f32: a device tensor from the engine
    tail_len: int
    last_used: int = 0
    nbytes: int = 0


class PagePrefixIndex:
    """Radix index token prefix -> (arena pages, cached first-token logits)
    for ONE model's paged slot state (``SlotDecodeState.prefix_index``).
    Single-threaded: the model's scheduler thread owns the slot state's host
    mirrors and is the only caller.

    Refcounts: the index holds one reference per node or tail page it
    stores; the CALLER mirrors them into ``page_refs`` (insert and evict
    return the pages to incref or decref) and owns the free list, so the
    conservation census has one place to check. The byte budget counts
    pinned pages (+ cached logits); eviction drops the coldest LEAF first,
    preferring pages no lane references (``page_refs == index refs``), and
    ``reclaim`` lets admission pressure override the budget rather than
    block a request behind cold cache pages."""

    def __init__(self, page_tokens: int, page_nbytes: int, capacity_bytes: int) -> None:
        self.page_tokens = int(page_tokens)
        self.page_nbytes = int(page_nbytes)
        self.capacity_bytes = int(capacity_bytes)
        self._root = _RadixNode()
        self._held: dict[int, int] = {}   # page -> index refs (normally 1)
        self._clock = itertools.count(1)
        self._bytes = 0
        self.hits = 0
        self.exact_hits = 0
        self.misses = 0

    # -- read side -------------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return self._bytes

    def held_pages(self) -> dict[int, int]:
        """page -> index reference count."""
        return dict(self._held)

    def lookup(self, prompt: np.ndarray) -> SharedPrefixPlan | None:
        """Longest page-aligned indexed prefix of ``prompt``; an exact
        terminal match (no prefill) beats any partial one. Touches recency
        along the matched path and counts hit / miss."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p, pt = prompt.shape[0], self.page_tokens
        stamp = next(self._clock)
        node, pages, i = self._root, [], 0
        while (i + 1) * pt <= p:
            child = node.children.get(prompt[i * pt:(i + 1) * pt].tobytes())
            if child is None:
                break
            child.last_used = stamp
            pages.append(child.page)
            node, i = child, i + 1
        tail = node.tails.get(prompt[i * pt:].tobytes())
        if tail is not None:
            tail.last_used = stamp
            self.hits += 1
            self.exact_hits += 1
            return SharedPrefixPlan(
                "exact", pages, i, page_tokens=pt, boundary_page=tail.page,
                tail_len=tail.tail_len, logits=tail.logits,
            )
        if i > 0 and i * pt >= p:
            # page-aligned prompt without cached logits: one suffix token
            # must remain to prefill
            i -= 1
            pages.pop()
        if i == 0:
            self.misses += 1
            return None
        self.hits += 1
        return SharedPrefixPlan("shared", pages, i, page_tokens=pt)

    # -- write side ------------------------------------------------------------
    def insert(
        self,
        prompt: np.ndarray,
        full_pages: list[int],
        boundary_page: int | None,
        logits: np.ndarray | None,
        page_refs: np.ndarray,
    ) -> tuple[list[int], list[int]]:
        """Publish an admitted lane's prompt: ``full_pages`` are the lane's
        block-table entries over the prompt's full page chunks (chunks
        already indexed keep their node's page: no double ref);
        ``boundary_page`` is a PRISTINE COPY of the part-filled last page,
        made by the caller before the lane's decode writes dirty the
        original. -> ``(added, released)``: pages the index newly holds
        (caller increfs) and pages the budget eviction let go (caller
        decrefs). A declined ``boundary_page`` is in neither list."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pt = self.page_tokens
        stamp = next(self._clock)
        added: list[int] = []
        node = self._root
        for i, pg in enumerate(full_pages):
            key = prompt[i * pt:(i + 1) * pt].tobytes()
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(page=int(pg))
                node.children[key] = child
                self._held[child.page] = self._held.get(child.page, 0) + 1
                self._bytes += self.page_nbytes
                added.append(child.page)
            child.last_used = stamp
            node = child
        rem_key = prompt[len(full_pages) * pt:].tobytes()
        if logits is not None and rem_key not in node.tails:
            if not isinstance(logits, torch.Tensor):
                logits = np.asarray(logits, np.float32)
            tail_len = prompt.shape[0] - len(full_pages) * pt
            if boundary_page is not None or tail_len == 0:
                nbytes = int(logits.nbytes)
                if boundary_page is not None:
                    nbytes += self.page_nbytes
                    self._held[int(boundary_page)] = self._held.get(int(boundary_page), 0) + 1
                    added.append(int(boundary_page))
                node.tails[rem_key] = _Tail(
                    None if boundary_page is None else int(boundary_page),
                    logits, tail_len, stamp, nbytes,
                )
                self._bytes += nbytes
        released = self._evict(page_refs, self.capacity_bytes)
        return added, released

    def reclaim(self, page_refs: np.ndarray, want_pages: int,
                protect: frozenset = frozenset()) -> list[int]:
        """Admission pressure: release up to ``want_pages`` pages no lane
        references, whatever the byte budget (coldest leaves first), never
        one of ``protect`` (the pages the blocked request's plan maps). When
        no such leaf is left, a page-less tail that pins one goes first (see
        ``_pinning_tail``; the reference stops short there)."""
        return self._evict(page_refs, target_bytes=None, want_pages=want_pages,
                           protect=protect, zero_ref_only=True)

    def _leaf_candidates(self):
        """Every removable leaf: (kind, holder, key, last_used, pages)."""
        stack = [(self._root, None, None)]
        while stack:
            node, parent, key = stack.pop()
            for k, t in node.tails.items():
                yield ("tail", node, k, t.last_used, [] if t.page is None else [t.page])
            if parent is not None and not node.children and not node.tails:
                yield ("node", parent, key, node.last_used, [node.page])
            for k, child in node.children.items():
                stack.append((child, node, k))

    def _pinning_tail(self, page_refs, protect: frozenset):
        """The coldest page-less tail (the cached logits of a page-aligned
        prompt) whose node's page no lane maps and is not protected: while
        it stands, its node is no leaf, so reclaim could never release that
        page, nor its chain. The reference stops there, which can leave an
        idle engine unable to admit a row; the port drops the tail and goes
        on (it releases no page itself). -> a ``_leaf_candidates`` entry
        ranked for ``_evict``, or None."""
        best = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.page in protect or \
                    int(page_refs[node.page]) > self._held.get(node.page, 0):
                continue
            for k, t in node.tails.items():
                if t.page is None and (best is None or t.last_used < best[0][1]):
                    best = ((0, t.last_used), ("tail", node, k, t.last_used, []))
        return best

    def _evict(self, page_refs, target_bytes, want_pages: int = 0,
               protect: frozenset = frozenset(), zero_ref_only: bool = False) -> list[int]:
        released: list[int] = []
        freed_pages = 0
        while True:
            if target_bytes is not None and self._bytes <= target_bytes and not want_pages:
                break
            if want_pages and freed_pages >= want_pages:
                break
            best = None
            for cand in self._leaf_candidates():
                _kind, _holder, _key, last_used, pages = cand
                if any(pg in protect for pg in pages):
                    continue
                # every reference on the page is the index's own: dropping
                # it frees arena memory
                zero_ref = all(int(page_refs[pg]) <= self._held.get(pg, 0) for pg in pages)
                if zero_ref_only and not (zero_ref and pages):
                    continue
                rank = (0 if zero_ref else 1, last_used)
                if best is None or rank < best[0]:
                    best = (rank, cand)
            if best is None and zero_ref_only:
                best = self._pinning_tail(page_refs, protect)
            if best is None:
                break
            kind, holder, key, _, pages = best[1]
            if kind == "tail":
                tail = holder.tails.pop(key)
                self._bytes -= tail.nbytes
            else:
                holder.children.pop(key)
                self._bytes -= self.page_nbytes
            for pg in pages:
                n = self._held.get(pg, 0) - 1
                if n <= 0:
                    self._held.pop(pg, None)
                else:
                    self._held[pg] = n
                released.append(pg)
                freed_pages += 1
        return released
