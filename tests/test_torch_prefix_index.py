"""The port's prefix-reuse bookkeeping (tfservingcache_tpu_torch/runtime/
prefix_cache.py) against the JAX package's (tfservingcache_tpu/runtime/
prefix_cache.py), on the host.

``PagePrefixIndex`` and ``PrefixCache`` hold no device state of their own, so
the two implementations must agree EXACTLY: the same plans (kind, pages,
boundary page, tail length, cached logits), the same pages added and
released, the same holds, byte totals and hit / miss counts, step for step,
over seeded sequences of inserts, lookups and reclaims drawn with
``numpy.random.default_rng(seed)``. One difference is the port's repair: a
reclaim that runs out of zero-ref leaves drops a page-less tail that pins
one (the reference stops short, which can leave an idle engine unable to
admit); the JAX side of the sequences applies the same step
(``_reference_reclaim``), and a test shows the reference stopping short.
The fixed scenarios of tests/test_shared_prefix_kv.py and
tests/test_prefix_cache.py run on the port's module.
"""

import numpy as np
import pytest

from tfservingcache_tpu.runtime import prefix_cache as jpc
from tfservingcache_tpu.types import ModelId as JModelId
from tfservingcache_tpu_torch.runtime import prefix_cache as tpc
from tfservingcache_tpu_torch.types import ModelId as TModelId

MODULES = {"jax": (jpc, JModelId), "torch": (tpc, TModelId)}


def _plan(plan):
    if plan is None:
        return None
    logits = None if plan.logits is None else np.asarray(plan.logits).tolist()
    return (plan.kind, list(plan.pages), plan.n_full, plan.covered, plan.boundary_page,
            plan.tail_len, logits, plan.mapped_pages())


def _prompt_pool(rng, pt):
    """Prompts over a few shared system prefixes (some page-aligned, some
    mid-page) with short distinct suffixes, plus exact repeats."""
    systems = [rng.integers(1, 9, int(n)).astype(np.int32) for n in (2 * pt, 3 * pt + 1, pt)]
    pool = []
    for sys_p in systems:
        for _ in range(4):
            suffix = rng.integers(1, 9, int(rng.integers(0, 2 * pt))).astype(np.int32)
            pool.append(np.concatenate([sys_p, suffix]))
    pool += [rng.integers(1, 9, int(rng.integers(1, 3 * pt))).astype(np.int32) for _ in range(4)]
    return [p for p in pool if p.size]


def _reference_reclaim(idx, refs, want: int, protect: frozenset) -> list[int]:
    """The JAX index's ``reclaim`` with the port's one repair: when no
    zero-ref leaf with a page is left, the coldest page-less tail (cached
    logits of a page-aligned prompt) whose node's page no lane maps and is
    not protected is dropped, and the reclaim goes on. Without it such a
    tail pins its node and chain for good (see
    ``test_reclaim_drops_a_tail_that_pins_its_chain``)."""
    released = idx.reclaim(refs, want, protect)
    while len(released) < want:
        best = None
        stack = [idx._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is idx._root or node.page in protect or \
                    int(refs[node.page]) > idx._held.get(node.page, 0):
                continue
            for key, tail in node.tails.items():
                if tail.page is None and (best is None or tail.last_used < best[0]):
                    best = (tail.last_used, node, key)
        if best is None:
            break
        idx._bytes -= best[1].tails.pop(best[2]).nbytes
        released += idx.reclaim(refs, want - len(released), protect)
    return released


def _drive_index(mod, seed: int, steps: int = 160, pt: int = 4, arena: int = 48):
    """One seeded sequence against ``mod.PagePrefixIndex`` with a simulated
    arena: lanes map their pages (refs + 1), publishes go through insert,
    retirements drop lane refs, pressure goes through reclaim. -> the log of
    every observable result."""
    rng = np.random.default_rng(seed)
    idx = mod.PagePrefixIndex(page_tokens=pt, page_nbytes=64, capacity_bytes=64 * 14)
    refs = np.zeros(arena + 1, np.int32)
    free = list(range(1, arena + 1))
    lanes: list[list[int]] = []
    pool = _prompt_pool(rng, pt)
    log = []

    def drop(pages):
        for pg in pages:
            refs[pg] -= 1
            assert refs[pg] >= 0
            if refs[pg] == 0:
                free.append(pg)

    for _ in range(steps):
        op = rng.choice(["insert", "lookup", "retire", "reclaim"], p=[0.35, 0.35, 0.2, 0.1])
        prompt = pool[int(rng.integers(len(pool)))]
        n_full, tail = divmod(prompt.shape[0], pt)
        if op == "lookup":
            log.append(("lookup", _plan(idx.lookup(prompt))))
        elif op == "insert" and len(free) >= n_full + 2:
            pages = [free.pop() for _ in range(n_full + (1 if tail else 0))]
            for pg in pages:
                refs[pg] += 1
            lanes.append(pages)
            boundary = free.pop() if tail and rng.random() < 0.8 else None
            logits = rng.standard_normal((1, 5)).astype(np.float32) if rng.random() < 0.9 else None
            added, released = idx.insert(prompt, pages[:n_full], boundary, logits, refs)
            for pg in added:
                refs[pg] += 1
            drop(released)
            if boundary is not None and boundary not in added:
                free.append(boundary)
            log.append(("insert", sorted(added), sorted(released)))
        elif op == "retire" and lanes:
            drop(lanes.pop(int(rng.integers(len(lanes)))))
            log.append(("retire",))
        elif op == "reclaim":
            held = sorted(idx.held_pages())
            protect = frozenset(pg for pg in held if rng.random() < 0.3)
            want = int(rng.integers(1, 4))
            if mod is jpc:
                released = _reference_reclaim(idx, refs, want, protect)
            else:
                released = idx.reclaim(refs, want, protect)
            assert not set(released) & protect
            drop(released)
            log.append(("reclaim", sorted(released)))
        log.append((sorted(idx.held_pages().items()), idx.total_bytes, idx.hits,
                    idx.exact_hits, idx.misses, sorted(free)))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_index_sequences_match_the_reference(seed):
    want = _drive_index(jpc, seed)
    got = _drive_index(tpc, seed)
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {step}: {g} != {w}"
    # the sequences exercise every outcome
    kinds = {e[1][0] for e in want if e[0] == "lookup" and e[1] is not None}
    assert kinds == {"exact", "shared"}
    assert any(e[0] == "insert" and e[2] for e in want)      # budget evictions
    assert any(e[0] == "reclaim" and e[1] for e in want)     # pressure releases


def test_radix_insert_lookup_and_dedup():
    mod = tpc
    idx = mod.PagePrefixIndex(page_tokens=4, page_nbytes=64, capacity_bytes=1 << 20)
    refs = np.zeros(32, np.int32)
    prompt = np.arange(1, 11, dtype=np.int32)  # 2 full pages + a 2-token tail
    logits = np.zeros((1, 5), np.float32)
    added, released = idx.insert(prompt, [3, 4], 7, logits, refs)
    assert sorted(added) == [3, 4, 7] and released == []
    for pg in added:
        refs[pg] += 1
    plan = idx.lookup(prompt)
    assert plan.kind == "exact" and plan.pages == [3, 4] and plan.boundary_page == 7
    assert plan.tail_len == 2 and plan.mapped_pages() == [3, 4, 7] and idx.exact_hits == 1
    longer = np.concatenate([prompt[:8], np.arange(50, 55, dtype=np.int32)])
    plan = idx.lookup(longer)
    assert plan.kind == "shared" and plan.pages == [3, 4] and plan.covered == 8
    # a second publisher of the same prompt dedups onto the existing nodes
    assert idx.insert(prompt, [9, 10], 11, logits, refs) == ([], [])
    assert idx.held_pages() == {3: 1, 4: 1, 7: 1}
    assert idx.lookup(np.arange(60, 70, dtype=np.int32)) is None and idx.misses == 1
    # a page-aligned prompt without cached logits comes back one page short
    idx2 = mod.PagePrefixIndex(page_tokens=4, page_nbytes=64, capacity_bytes=1 << 20)
    aligned = np.arange(1, 9, dtype=np.int32)
    for pg in idx2.insert(aligned, [1, 2], None, None, refs)[0]:
        refs[pg] += 1
    plan = idx2.lookup(aligned)
    assert plan.kind == "shared" and plan.pages == [1] and plan.covered == 4


def test_radix_budget_and_reclaim():
    """Over budget the coldest zero-ref leaf goes; pressure reclaim skips
    pages a lane maps and the blocked request's own plan."""
    mod = tpc
    idx = mod.PagePrefixIndex(page_tokens=4, page_nbytes=64, capacity_bytes=64)
    refs = np.zeros(8, np.int32)
    assert idx.insert(np.arange(4, dtype=np.int32), [1], None, None, refs) == ([1], [])
    refs[1] += 1
    added, released = idx.insert(np.arange(4, 8, dtype=np.int32), [2], None, None, refs)
    assert added == [2] and released == [1] and idx.held_pages() == {2: 1}

    idx = mod.PagePrefixIndex(page_tokens=4, page_nbytes=64, capacity_bytes=1 << 20)
    refs = np.zeros(8, np.int32)
    for i, pg in enumerate((1, 2, 3)):
        for a in idx.insert(np.arange(4 * i, 4 * i + 4, dtype=np.int32), [pg], None, None,
                            refs)[0]:
            refs[a] += 1
    refs[2] += 1  # a lane maps page 2
    released = idx.reclaim(refs, 3, frozenset({3}))
    assert released == [1] and idx.held_pages() == {2: 1, 3: 1}


def _drive_cache(mod, mid_cls, seed: int, steps: int = 120):
    class Arr:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    rng = np.random.default_rng(seed)
    pc = mod.PrefixCache(capacity_bytes=400)
    mids = [mid_cls("a", 1), mid_cls("b", 2)]
    base = [rng.integers(0, 6, 40).astype(np.int32) for _ in range(3)]
    log = []
    for _ in range(steps):
        mid = mids[int(rng.integers(2))]
        src = base[int(rng.integers(3))]
        n = int(rng.integers(2, 40))
        op = rng.choice(["insert", "lookup", "drop"], p=[0.45, 0.5, 0.05])
        if op == "insert":
            pc.insert(mid, src[:n], Arr(int(rng.integers(10, 90))), Arr(10), n)
        elif op == "lookup":
            hit = pc.lookup(mid, src[:n])
            log.append(None if hit is None else (hit.valid_len, hit.tokens.tolist(), hit.nbytes))
        else:
            pc.drop_model(mid)
        log.append((pc.total_bytes, len(pc), pc.hits, pc.misses))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_sequences_match_the_reference(seed):
    want = _drive_cache(jpc, JModelId, seed)
    got = _drive_cache(tpc, TModelId, seed)
    assert got == want
    assert any(isinstance(e, tuple) and len(e) == 3 for e in want)  # some lookups hit
    assert None in want                                               # and some miss


def test_prefix_cache_lru_budget_and_entry_cap():
    mod, mid_cls = tpc, TModelId

    class Arr:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    pc = mod.PrefixCache(capacity_bytes=100)
    mid = mid_cls("m", 1)
    toks = np.arange(10, dtype=np.int32)
    pc.insert(mid, toks, Arr(30), Arr(10), 10)
    assert len(pc) == 1 and pc.total_bytes == 40
    assert pc.lookup(mid, np.arange(12, dtype=np.int32)).valid_len == 10
    assert pc.lookup(mid, toks).valid_len == 9  # strict prefix: one suffix token left
    assert pc.lookup(mid, np.array([5, 6], np.int32)) is None
    assert pc.lookup(mid_cls("other", 1), toks) is None
    pc.insert(mid, np.arange(20, 40, dtype=np.int32), Arr(30), Arr(10), 20)
    pc.insert(mid, np.arange(40, 60, dtype=np.int32), Arr(30), Arr(10), 20)
    assert pc.total_bytes <= 100 and len(pc) == 2
    pc.insert(mid, np.arange(5, dtype=np.int32), Arr(900), Arr(10), 5)  # over budget: refused
    assert pc.total_bytes <= 100
    pc.drop_model(mid)
    assert len(pc) == 0 and pc.total_bytes == 0
    big = mod.PrefixCache(capacity_bytes=1 << 30)
    for i in range(mod._MAX_ENTRIES_PER_MODEL + 5):
        big.insert(mid, np.arange(i, i + 8, dtype=np.int32), Arr(1), Arr(1), 8)
    assert len(big) == mod._MAX_ENTRIES_PER_MODEL


def test_reclaim_drops_a_tail_that_pins_its_chain():
    """A page-aligned prompt published with its logits holds a page-less
    tail on its last node, so that node is never a leaf: the reference's
    reclaim releases none of its pages, even with no lane mapping any of
    them; the port's drops the tail and releases the whole chain (the
    budget eviction already treats such a tail as a leaf)."""
    out = {}
    for name, (mod, _) in MODULES.items():
        idx = mod.PagePrefixIndex(page_tokens=4, page_nbytes=64, capacity_bytes=1 << 20)
        refs = np.zeros(8, np.int32)
        aligned = np.arange(1, 9, dtype=np.int32)  # exactly 2 pages
        added, _ = idx.insert(aligned, [1, 2], None, np.zeros((1, 5), np.float32), refs)
        for pg in added:
            refs[pg] += 1
        assert idx.lookup(aligned).kind == "exact"
        out[name] = sorted(idx.reclaim(refs, 2))
        assert (idx.held_pages() == {}) == (name == "torch")
    assert out == {"jax": [], "torch": [1, 2]}
