"""The paged kernels' page-axis split: the host-side plan
``ops.attention.paged_split_plan`` and the plain split-and-combine
``paged_reference.paged_split_reference`` (a test-side model of the
kernels' arithmetic) against the JAX package.

Inputs come from ``numpy.random.default_rng(seed)``: scattered arenas with
ragged positions, each lane's T query positions at ``pos .. pos + T - 1``,
table slots past each lane's deepest frontier on the trash page, lane 0
running past the end of its table and lane 1 ending inside the first split
(so later splits of that lane see no key). The reference walks each split
in page steps here, as the Pallas body does (p rounded to bf16 against a
split's own running max). Tolerances:
  - f32 and int8 arenas: 2e-5 absolute against the JAX plain version (int8:
    on the dequantized pages) and, for f32, the JAX Pallas kernel in
    interpret mode (same f32 math, other summation order);
  - bf16 arena: 2**-8 against the JAX Pallas kernel in interpret mode
    (chip_smoke.py's PAGED_TOL), and 3e-2 against the JAX plain version,
    which rounds the normalized p instead: the bar the JAX package holds
    its own bf16 kernel to (tests/test_paged_kernel.py
    ``test_paged_decode_kernel_on_tpu``). At these few keys a lane's output
    is a mix of a handful of N(0, 1) rows, so one bf16 rounding of p moves
    it by up to ~2**-8 * max|v|, and the JAX kernel itself is up to 0.007
    from the JAX plain version here.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfservingcache_tpu.models.generation as jgen
from tfservingcache_tpu.ops import attention as jatt
from tfservingcache_tpu_torch.models import generation as tgen
from paged_reference import _rounding_max, flip_bound, kernel_walk, paged_split_reference
from tfservingcache_tpu_torch.ops import attention as tatt

# the kernels' row tiles (ops/csrc/paged_attention.cu Path::ROW_TILE, read on
# the card through paged_launch_plan) and the plan's blocks an SM, by path
MMA = (64, tatt.SPLIT_BLOCKS_PER_SM["mma"])
SIMT = (16, tatt.SPLIT_BLOCKS_PER_SM["simt"])

PLAN_SHAPES = [  # (lanes, Hkv, rows, pps, page_tokens, SMs, (row tile, blocks an SM))
    (8, 32, 1, 69, 16, 132, MMA),        # the decode step at llama-7b width
    (8, 32, 1, 69, 16, 132, SIMT),       # the same over an int8 arena
    (8, 32, 5, 69, 16, 132, MMA),        # a spec round
    (8, 32, 256, 69, 16, 132, MMA),      # chunked prefill
    (8, 32, 256, 69, 16, 132, SIMT),     # chunked prefill, SIMT row tiles
    (32, 32, 1, 256, 16, 132, MMA),
    (16, 8, 4, 128, 16, 132, MMA),
    (16, 8, 4, 128, 16, 132, SIMT),
    (4, 32, 5, 38, 8, 132, SIMT),
    (8, 16, 1, 32, 16, 132, MMA),
    (1, 1, 1, 1, 16, 132, MMA),
    (1, 1, 1, 1000, 16, 132, MMA),
    (1, 8, 1, 7, 1, 132, SIMT),
    (2, 2, 9, 3, 64, 132, SIMT),
    (3, 4, 36, 5, 8, 16, SIMT),
    (70000, 1, 1, 1, 16, 132, MMA),      # more lanes than a grid's y dimension takes
    (1, 1, 1, 2048, 128, 8, MMA),
    (5, 3, 7, 11, 4, 1, MMA),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_invariants(shape):
    lanes, hkv, rows, pps, pt, sms, (tile, per_sm) = shape
    n, per = tatt.paged_split_plan(lanes, hkv, rows, pps, pt, sms, tile, per_sm)
    assert type(n) is int and type(per) is int
    assert 1 <= n <= pps and per >= 1
    assert n * per >= pps and (n - 1) * per < pps  # every slot covered, no split empty by plan
    assert (n, per) == tatt.paged_split_plan(lanes, hkv, rows, pps, pt, sms, tile, per_sm)
    blocks = lanes * hkv * -(-rows // tile)
    if blocks >= per_sm * sms:
        assert (n, per) == (1, pps)  # the unsplit grid already fills the card
    if n > 1:
        assert per * pt >= tatt.SPLIT_MIN_KEYS  # no split shorter than its prologue is worth
        assert blocks * n <= per_sm * sms       # the split grid stays within its blocks an SM


@pytest.mark.parametrize("lanes, hkv, rows, pps, want", [
    (1, 32, 1, 69, 8),      # 32 blocks: 8 splits, 256 blocks (the sweep's best)
    (2, 32, 1, 69, 4),      # 64 blocks: 4
    (4, 32, 5, 69, 2),      # 128 blocks: 2
    (6, 32, 1, 69, 1),      # 192 blocks: one
    (8, 32, 5, 69, 1),      # the smoke's spec round
    (1, 8, 1, 128, 16),     # GQA g = 4 at one lane: 8 blocks, capped by 128 keys a split
    (16, 8, 20, 128, 2),
    (8, 32, 256, 69, 1),    # chunked prefill: 4 row tiles a head
])
def test_split_plan_on_the_mma_path_fills_one_wave_of_two_blocks_an_sm(lanes, hkv, rows, pps,
                                                                      want):
    """bf16 pages on 132 SMs (tools/paged_split_sweep.py's rows at 16-token
    pages): the splits that bring the grid nearest 264 blocks from below."""
    assert tatt.paged_split_plan(lanes, hkv, rows, pps, 16, 132, *MMA)[0] == want


@pytest.mark.parametrize("path", [MMA, SIMT])
@pytest.mark.parametrize("lanes", [33, 64, 1024])
def test_split_plan_keeps_one_split_when_the_grid_fills_the_card(lanes, path):
    assert tatt.paged_split_plan(lanes, 32, 1, 69, 16, 132, *path) == (1, 69)


def test_split_plan_splits_a_small_grid_and_takes_no_tensor():
    n, per = tatt.paged_split_plan(1, 32, 1, 69, 16, 132, *MMA)
    assert n > 1 and per < 69
    assert tatt.paged_split_plan(8, 32, 1, 69, 16, 132, *SIMT)[0] > 1
    assert all(p.annotation in (int, "int") for p in
               inspect.signature(tatt.paged_split_plan).parameters.values())
    with pytest.raises(TypeError):  # pos or any tensor: the plan reads shapes only
        tatt.paged_split_plan(8, 32, 1, torch.tensor(69), 16, 132, *MMA)
    with pytest.raises(ValueError):
        tatt.paged_split_plan(8, 32, 1, 0, 16, 132, *MMA)


def _arena(lanes, hq, hkv, d, pps, pt, t_q, seed):
    rng = np.random.default_rng(seed)
    n_pages = lanes * pps + 1
    tables = rng.permutation(np.arange(1, n_pages)).reshape(lanes, pps).astype(np.int32)
    k_pages = rng.standard_normal((n_pages, hkv, pt, d)).astype(np.float32)
    v_pages = rng.standard_normal((n_pages, hkv, pt, d)).astype(np.float32)
    q = rng.standard_normal((lanes, hq, t_q, d)).astype(np.float32)
    pos = rng.integers(0, pps * pt - t_q + 1, lanes).astype(np.int32)
    pos[0] = pps * pt - max(1, t_q // 2)  # lane 0 runs past its table
    pos[1] = 2                            # lane 1 ends inside the first page
    for s in range(lanes):
        tables[s, -(-(int(pos[s]) + t_q) // pt):] = 0
    return q, k_pages, v_pages, tables, pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


PPS = 5


@pytest.mark.parametrize("arena", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("t_q", [1, 5])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("splits", [1, 2, 3, PPS])
def test_split_reference_matches_jax(splits, g, t_q, arena):
    hkv, pt = 2, 8
    q, kp, vp, tables, pos = _arena(lanes=4, hq=hkv * g, hkv=hkv, d=16, pps=PPS, pt=pt,
                                    t_q=t_q, seed=splits * 31 + g * 7 + t_q)
    n, per = tatt._even_split(PPS, splits)
    assert n == splits
    jq, jtab, jpos = jnp.asarray(q), jnp.asarray(tables), jnp.asarray(pos)
    jfn = jatt.paged_decode_attention if t_q == 1 else jatt.paged_verify_attention
    tq, ttab, tpos = _t(q, tables, pos)
    if arena == "int8":
        kq, ks = tgen._quantize_kv_rows(torch.from_numpy(kp))
        vq, vs = tgen._quantize_kv_rows(torch.from_numpy(vp))
        got = paged_split_reference(tq, kq, vq, ttab, tpos, pt, n, per, ks, vs)
        jkq, jks = jgen._quantize_kv_rows(jnp.asarray(kp))
        jvq, jvs = jgen._quantize_kv_rows(jnp.asarray(vp))
        want = jfn(jq, jatt.dequantize_pages(jkq, jks), jatt.dequantize_pages(jvq, jvs),
                   jtab, jpos, pt)
        tol = 2e-5
    elif arena == "bfloat16":
        tk, tv = (torch.from_numpy(a).bfloat16() for a in (kp, vp))
        got = paged_split_reference(tq.bfloat16(), tk, tv, ttab, tpos, pt, n, per)
        jb = (jq.astype(jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
              jnp.asarray(vp, jnp.bfloat16), jtab, jpos)
        plain = np.asarray(jfn(*jb, pt))
        np.testing.assert_allclose(got.numpy(), plain, rtol=0, atol=3e-2)
        jkernel = (jatt.paged_decode_attention_kernel if t_q == 1
                   else jatt.paged_verify_attention_kernel)
        want = jkernel(*jb, page_tokens=pt, interpret=True)
        tol = 2.0**-8
    else:
        got = paged_split_reference(tq, *_t(kp, vp), ttab, tpos, pt, n, per)
        want = jfn(jq, jnp.asarray(kp), jnp.asarray(vp), jtab, jpos, pt)
        tol = 2e-5
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == (4, hkv * g, t_q, 16)
    assert np.isfinite(got).all()  # lane 1's empty splits give no NaN
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("t_q", [1, 5])
@pytest.mark.parametrize("splits", [2, PPS])
def test_split_reference_matches_the_interpret_kernel(splits, t_q):
    """f32 arena, GQA g = 2: the split-and-combine against the JAX Pallas
    kernel run in interpret mode (its own online softmax over page steps)."""
    q, kp, vp, tables, pos = _arena(lanes=3, hq=4, hkv=2, d=16, pps=PPS, pt=8, t_q=t_q,
                                    seed=100 + splits + t_q)
    n, per = tatt._even_split(PPS, splits)
    got = paged_split_reference(*_t(q, kp, vp, tables, pos), 8, n, per).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, pos)]
    if t_q == 1:
        want = jatt.paged_decode_attention_kernel(*jargs, page_tokens=8, interpret=True)
    else:
        want = jatt.paged_verify_attention_kernel(*jargs, page_tokens=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_split_is_the_plain_version(dtype):
    """With one split there is nothing to combine: the split reference is the
    plain version up to the order of the softmax's sums (f32) and, in bf16,
    up to where p is rounded (unnormalized here, normalized there: the
    module docstring's 3e-2)."""
    arrays = _t(*_arena(lanes=4, hq=8, hkv=2, d=16, pps=PPS, pt=8, t_q=5, seed=8))
    q, kp, vp = (a.to(dtype) for a in arrays[:3])
    got = paged_split_reference(q, kp, vp, *arrays[3:], 8, 1, PPS)
    want = tatt.paged_verify_attention(q, kp, vp, *arrays[3:], 8)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert (got - want).abs().max().item() <= tol


def test_empty_splits_keep_the_neutral_state():
    """A lane whose frontier ends in split 0 gets the same answer from 1 and
    from pps splits (the empty splits weigh exp(NEG_INF - m) = 0)."""
    arrays = _t(*_arena(lanes=3, hq=2, hkv=2, d=16, pps=PPS, pt=8, t_q=1, seed=9))
    one = paged_split_reference(*arrays, 8, 1, PPS)
    every = paged_split_reference(*arrays, 8, PPS, 1)
    assert torch.isfinite(every).all()
    assert (one[1] - every[1]).abs().max().item() <= 1e-6


@pytest.mark.parametrize("pt", [8, 16])
@pytest.mark.parametrize("t_q", [1, 5])
@pytest.mark.parametrize("g", [1, 4])
def test_split_reference_rounds_where_the_pallas_body_does(g, t_q, pt):
    """bf16, one split walked in page steps: the model rounds p against the
    running max of each page step, as the JAX Pallas body does, so the two
    agree to f32 rounding, far below one bf16 rounding of p."""
    hkv = 2
    q, kp, vp, tables, pos = _arena(lanes=4, hq=hkv * g, hkv=hkv, d=16, pps=PPS, pt=pt,
                                    t_q=t_q, seed=200 + g * 7 + t_q + pt)
    tq, ttab, tpos = _t(q, tables, pos)
    tk, tv = (torch.from_numpy(a).bfloat16() for a in (kp, vp))
    got = paged_split_reference(tq.bfloat16(), tk, tv, ttab, tpos, pt, 1, PPS).numpy()
    jb = (jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
          jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(pos))
    jkernel = jatt.paged_decode_attention_kernel if t_q == 1 else jatt.paged_verify_attention_kernel
    want = np.asarray(jkernel(*jb, page_tokens=pt, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("plan, rows, want", [
    ({"mma": True, "row_tile": 64, "unit": 16}, 1, [(16, 4)]),          # a decode step
    ({"mma": True, "row_tile": 64, "unit": 16}, 20, [(16, 2)] * 20),    # T = 5, g = 4
    ({"mma": True, "row_tile": 64, "unit": 16}, 40, [(16, 1)] * 40),
    ({"mma": True, "row_tile": 64, "unit": 16}, 80, [(16, 1)] * 64 + [(16, 4)] * 16),
    ({"mma": False, "row_tile": 16, "unit": 4}, 1, [(8, 4)]),
    ({"mma": False, "row_tile": 16, "unit": 4}, 5, [(16, 2)] * 5),
    ({"mma": False, "row_tile": 16, "unit": 4}, 9, [(32, 1)] * 9),
    ({"mma": False, "row_tile": 16, "unit": 4}, 18, [(32, 1)] * 16 + [(8, 4)] * 2),
])
def test_kernel_walk_follows_the_row_tiles(plan, rows, want):
    assert kernel_walk(plan, rows) == want


def _walk_online(sc, vis, v, split_keys, chunk, walkers, rounded):
    """One row the way a kernel block walks it, key chunk by key chunk: each
    walker's online softmax over its chunks of each split, then every
    walker's and split's (m, l, acc) merged in order."""
    n_keys = sc.shape[0]
    states = []
    for kb in range(0, n_keys, split_keys):
        ke = min(kb + split_keys, n_keys)
        for w in range(walkers):
            m, l, acc = tatt.NEG_INF, 0.0, torch.zeros(v.shape[1])
            c0 = kb + w * chunk
            while c0 < ke:
                keys = torch.arange(c0, min(c0 + chunk, ke))
                s = torch.where(vis[keys], sc[keys], torch.tensor(tatt.NEG_INF))
                mx = max(m, s.max().item())
                alpha = float(np.exp(np.float32(m - mx)))
                p = torch.where(vis[keys], torch.exp(s - mx), torch.zeros_like(s))
                pv = p.bfloat16().float() if rounded else p
                l = alpha * l + p.sum().item()
                acc = alpha * acc + pv @ v[keys]
                m = mx
                c0 += walkers * chunk
            states.append((m, l, acc))
    top = max(m for m, _, _ in states)
    wts = [float(np.exp(np.float32(m - top))) for m, _, _ in states]
    l_all = sum(w * l for w, (_, l, _) in zip(wts, states))
    return sum(w * a for w, (_, _, a) in zip(wts, states)) / max(l_all, 1e-30)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("chunk, walkers", [(16, 4), (16, 2), (8, 4), (32, 1), (8, 1)])
def test_split_reference_is_the_online_walk(chunk, walkers, splits):
    """The reference weighs each key once by exp(m_round - max m); a kernel
    rescales its running (l, acc) chunk by chunk. Both are one function up
    to f32 rounding, for any chunking, walkers and splits (bf16 pages)."""
    pt, pps = 8, 12
    q, kp, vp, tables, pos = _arena(lanes=3, hq=4, hkv=2, d=16, pps=pps, pt=pt, t_q=5,
                                    seed=300 + chunk + walkers + splits)
    n, per = tatt._even_split(pps, splits)
    tq, ttab, tpos = _t(q, tables, pos)
    tq = tq.bfloat16()
    tk, tv = (torch.from_numpy(a).bfloat16() for a in (kp, vp))
    got = paged_split_reference(tq, tk, tv, ttab, tpos, pt, n, per, walk=[(chunk, walkers)] * 10)
    kc = tatt.paged_gather_kv(tk, ttab, pt).float()
    vc = tatt.paged_gather_kv(tv, ttab, pt).float()
    scale = torch.tensor(1.0) / np.sqrt(16)
    for s in range(3):
        for h in range(4):
            for t in range(5):
                sc = (tq[s, h, t].float() @ kc[s, h // 2].T) * scale
                vis = torch.arange(pps * pt) <= int(tpos[s]) + t
                want = _walk_online(sc, vis, vc[s, h // 2], per * pt, chunk, walkers, True)
                assert (got[s, h, t] - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("chunk, walkers", [(16, 4), (8, 2), (3, 1)])
def test_rounding_max_is_each_walkers_running_max(chunk, walkers):
    """Keys of split 0 (20 of them) and split 1 (the other 13): a key's
    rounding max is the max over the chunks its walker has taken so far in
    its split, its own chunk included."""
    sc = torch.from_numpy(np.random.default_rng(chunk + walkers).standard_normal(33)).float()
    got = _rounding_max(sc[None], 20, chunk, walkers)[0]
    for k in range(33):
        kb = 0 if k < 20 else 20
        i = (k - kb) // chunk
        seen = [j for j in range(kb, min(kb + 20, 33))
                if (j - kb) // chunk % walkers == i % walkers and (j - kb) // chunk <= i]
        assert got[k].item() == sc[seen].max().item()


def test_flip_bound_marks_only_p_near_a_rounding_midpoint():
    """One bf16 step (2**-8 in [0.5, 1), 2**-10 in [0.125, 0.25)) where p sits
    at a midpoint between two bf16 values, give or take f32 noise; 0 where
    bf16 rounding is settled, and at p = 0."""
    mid_hi, mid_lo = 0.75 + 2.0**-9, 0.15625 + 2.0**-11
    p = torch.tensor([mid_hi, mid_hi * (1 + 2.0**-20), mid_lo, 0.75, 0.75 + 2.0**-10, 0.0, 1.0])
    want = torch.tensor([2.0**-8, 2.0**-8, 2.0**-10, 0.0, 0.0, 0.0, 0.0])
    assert torch.equal(flip_bound(p), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_reference_bound_is_zero_off_bf16_and_small_on_it(dtype):
    """The flip bound is 0 on f32 pages (p is not rounded) and, on bf16 pages,
    a small share of one bf16 rounding of the output, with the same output
    as without it."""
    arrays = _t(*_arena(lanes=4, hq=8, hkv=2, d=16, pps=PPS, pt=8, t_q=5, seed=12))
    q, kp, vp = (a.to(dtype) for a in arrays[:3])
    out, bound = paged_split_reference(q, kp, vp, *arrays[3:], 8, 2, 3, with_bound=True)
    assert torch.equal(out, paged_split_reference(q, kp, vp, *arrays[3:], 8, 2, 3))
    assert bound.shape == out.shape and (bound >= 0).all()
    if dtype == torch.float32:
        assert not bound.any()
    else:
        assert bound.max().item() <= 2.0**-8 * vp.float().abs().max().item()
