"""A plain PyTorch model of the paged kernels' arithmetic
(``tfservingcache_tpu_torch/ops/csrc/paged_attention.cu``), for tests only.

The kernels split a lane's keys into page-axis splits and, inside a split,
into chunks that one or more walkers (warps) take in turn, each with its
own online softmax. Where that matters is the bf16 arena: p is rounded to
bf16 against the walker's running max after the chunk, so the result
depends on where the chunks fall. ``paged_split_reference`` rounds p at
exactly that point, so a kernel can be held to it at a bar far below one
bf16 rounding of p; every other step is f32 (an online softmax rescales
what this model weighs once, which differs only in f32 rounding).

``kernel_walk`` gives the kernels' own chunking for a launch plan
(``ops.attention.paged_launch_plan``); ``chunk=page_tokens, walkers=1`` is
the Pallas body's page steps (tfservingcache_tpu/ops/attention.py
``_paged_decode_kernel`` / ``_paged_verify_kernel``) inside each split.
"""

from __future__ import annotations

import math

import torch

from tfservingcache_tpu_torch.ops import attention as A

NUM_WARPS = 4  # warps of a kernel block


def kernel_walk(plan: dict, rows: int) -> list[tuple[int, int]]:
    """(chunk keys, walkers) of each folded row ``r = t * g + gi`` under a
    launch plan: a block holds ``plan["row_tile"]`` rows, ``plan["unit"]``
    a warp; the warps of a row group split its keys 4, 2 or 1 ways (1, 2 or
    more groups in the tile). The mma path takes 16-key chunks; the SIMT
    path a step of 32 keys shared by the walkers."""
    walk = []
    for r in range(rows):
        tile0 = r - r % plan["row_tile"]
        in_tile = min(plan["row_tile"], rows - tile0)
        groups = -(-in_tile // plan["unit"])
        walkers = NUM_WARPS if groups == 1 else 2 if groups == 2 else 1
        walk.append((16 if plan["mma"] else 32 // walkers, walkers))
    return walk


def _rounding_max(sc: torch.Tensor, split_keys: int, chunk: int, walkers: int) -> torch.Tensor:
    """For scores ``sc (..., L)`` (masked keys at NEG_INF): the max each
    key's p is rounded against, i.e. its walker's running max after the
    key's chunk. Split ``sp`` holds keys ``[sp * split_keys, ...)``; its
    chunk ``i`` goes to walker ``i % walkers``."""
    n_keys = sc.shape[-1]
    out = torch.empty_like(sc)
    for kb in range(0, n_keys, split_keys):
        part = sc[..., kb:kb + split_keys]
        n = part.shape[-1]
        span = chunk * walkers
        padded = -(-n // span) * span
        full = torch.full((*part.shape[:-1], padded), A.NEG_INF, dtype=sc.dtype, device=sc.device)
        full[..., :n] = part
        rounds = full.reshape(*part.shape[:-1], padded // span, walkers, chunk)
        run = rounds.amax(dim=-1).cummax(dim=-2).values  # (..., rounds, walkers)
        out[..., kb:kb + n] = run[..., None].expand_as(rounds).reshape(full.shape)[..., :n]
    return out


def paged_split_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    page_tokens: int,
    n_splits: int,
    pages_per_split: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    walk: list[tuple[int, int]] | None = None,
    with_bound: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The paged kernels' split-and-combine in plain PyTorch: split ``sp``
    takes the keys of table slots ``[sp * pages_per_split, (sp + 1) *
    pages_per_split)``; ``walk[r] = (chunk, walkers)`` says how folded row
    ``r`` walks a split (default: page steps, one walker). Row ``r`` sits
    at ``pos + r // g`` and sees keys up to it, capped at ``pps *
    page_tokens``; scores are ``q.k * (1 / sqrt(D))`` in f32. bf16 pages:
    p is rounded to bf16 against its walker's running max; l is summed
    from the f32 p. int8 pages are dequantized to f32 and keep p in f32;
    f32 pages are all f32. ``n_splits`` must cover the table. q ``(S, Hq,
    T, D)`` -> f32 ``(S, Hq, T, D)``, computed on q's device; with
    ``with_bound``, also ``flip_bound``'s bound on the same grid."""
    s_lanes, hq, t, d = q.shape
    hkv, pps = k_pages.shape[1], tables.shape[1]
    if n_splits * pages_per_split < pps:
        raise ValueError(f"{n_splits} splits of {pages_per_split} pages do not cover {pps}")
    g = hq // hkv
    rows = t * g
    walk = walk if walk is not None else [(page_tokens, 1)] * rows
    rounded = k_pages.dtype == torch.bfloat16
    if k_scale is not None:
        k_pages = A.dequantize_pages(k_pages, k_scale)
        v_pages = A.dequantize_pages(v_pages, v_scale)
    kc = A.paged_gather_kv(k_pages, tables, page_tokens).float()   # (S, Hkv, L, D)
    vc = A.paged_gather_kv(v_pages, tables, page_tokens).float()
    # folded rows r = t * g + gi of each (lane, KV head)
    qf = q.float().reshape(s_lanes, hkv, g, t, d).transpose(2, 3).reshape(s_lanes, hkv, rows, d)
    scale = torch.tensor(1.0, dtype=torch.float32) / math.sqrt(d)
    sc = torch.einsum("bkrd,bkld->bkrl", qf, kc) * scale.to(q.device)
    k_pos = torch.arange(kc.shape[2], device=q.device)
    q_pos = pos.long()[:, None] + torch.arange(rows, device=q.device)[None, :] // g  # (S, R)
    vis = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]                      # (S, 1, R, L)
    sc = torch.where(vis, sc, torch.full_like(sc, A.NEG_INF))
    m_round = torch.empty_like(sc)
    for cw in set(walk):
        idx = [r for r in range(rows) if walk[r] == cw]
        m_round[:, :, idx] = _rounding_max(sc[:, :, idx], pages_per_split * page_tokens, *cw)
    m_all = sc.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(sc - m_round), torch.zeros_like(sc))
    pv = p.bfloat16().float() if rounded else p
    w = torch.where(vis, torch.exp(m_round - m_all), torch.zeros_like(sc))
    acc = torch.einsum("bkrl,bkld->bkrd", pv * w, vc)
    l_sum = (p * w).sum(dim=-1, keepdim=True)
    out = acc / l_sum.clamp_min(1e-30)                               # (S, Hkv, R, D)

    def unfold(x):
        return x.reshape(s_lanes, hkv, t, g, d).transpose(2, 3).reshape(s_lanes, hq, t, d)

    if not with_bound:
        return unfold(out)
    flips = flip_bound(p) if rounded else torch.zeros_like(p)
    bound = torch.einsum("bkrl,bkld->bkrd", flips * w, vc.abs()) / l_sum.clamp_min(1e-30)
    return unfold(out), unfold(bound)


FLIP_EPS = 2.0**-15  # relative: far above f32 noise in p, far below a bf16 step


def flip_bound(p: torch.Tensor) -> torch.Tensor:
    """How far the bf16 rounding of each f32 ``p`` may land from this
    model's when the kernel's p differs from it by f32 noise (a score summed
    in another order, another exp): one bf16 step of p where p lies within
    ``FLIP_EPS * p`` of a rounding midpoint, else 0. Weighed by the key's
    ``exp(m_round - max m) * |v| / l``, it bounds what such a flip moves the
    output by."""
    mant, expo = torch.frexp(p)  # p = mant * 2**expo, mant in [0.5, 1)
    step = torch.ldexp(torch.ones_like(p), expo - 8)  # a bf16 step at p
    frac = p / step - torch.floor(p / step)
    near = (frac - 0.5).abs() * step < FLIP_EPS * p
    return torch.where((p > 0) & near, step, torch.zeros_like(p))
