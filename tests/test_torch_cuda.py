"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

They skip without a CUDA device. On a machine with a card (which has no
JAX), run them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, on N(0, 1) inputs:
  - flash, bf16: 2**-5 absolute (one bf16 ulp at |x| in [4, 8); the kernel
    rounds p to bf16 before p.v, the plain version keeps f32);
  - flash, f32: 1e-5 absolute (same f32 math, other summation order);
  - paged decode and verify, f32 arena: 1e-5; int8 arena: 1e-5 (both sides
    dequantize to the same f32 values), against the plain version; bf16
    arena: 2**-10 against ``paged_reference.paged_split_reference`` under
    the launch's own plan and chunking (``_kernel_reference``), which rounds
    p to bf16 where the kernel does: against the running max of each key
    chunk a warp takes. The plain version rounds the normalized p instead,
    a different rounding by up to a bf16 unit roundoff (2**-8) of each p;
    the reference leaves the kernel only f32 rounding, and the rare p that
    f32 noise moves across a bf16 rounding midpoint, whose effect
    ``paged_reference.flip_bound`` bounds and the bar adds (``_bf16_off``);
  - ring carry step (B4): see test_carry_kernel_matches_plain_version.
"""

import numpy as np
import pytest
import torch
from paged_reference import kernel_walk, paged_split_reference

from tfservingcache_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

SHAPES = [  # (B, Hq, Hkv, S, D)
    (1, 4, 4, 128, 64),
    (2, 8, 2, 200, 128),
    (1, 4, 2, 300, 192),
    (1, 2, 2, 130, 256),
    (1, 2, 1, 1, 128),
    # the bf16 kernel's pipeline: S = 4096 with few heads (the two-stage K/V
    # ring wraps 16-32 times), lengths at the 64/128-row tile edges, GQA
    # g = 4 and 8, every head_dim; in the last four B*Hq*ceil(S/128) is at
    # least the card's SM count: 128-row tiles on two consumer warpgroups
    # (D = 256 keeps one)
    (1, 2, 2, 4096, 64),
    (1, 2, 1, 4096, 128),
    (1, 4, 4, 127, 128),
    (1, 4, 4, 128, 128),
    (1, 4, 4, 129, 128),
    (1, 8, 2, 256, 128),
    (1, 16, 2, 300, 64),
    (1, 4, 4, 256, 192),
    (1, 4, 1, 512, 256),
    (1, 8, 8, 4096, 64),
    (2, 16, 4, 1024, 128),
    (1, 32, 4, 1024, 192),
    (1, 16, 16, 1200, 256),
    # head_dim 32 (the LM families' default width) in the 64-column tile:
    # one and two consumer warpgroups, a ragged length
    (2, 8, 4, 1024, 32),
    (1, 4, 4, 130, 32),
    (2, 40, 8, 384, 32),
]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the module docstring)")
    return torch.device("cuda")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_kernel_matches_plain_version(card, shape, causal):
    b, hq, hkv, s, d = shape
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(b, hq, s, d, device=card, generator=gen).bfloat16()
    k = torch.randn(b, hkv, s, d, device=card, generator=gen).bfloat16()
    v = torch.randn(b, hkv, s, d, device=card, generator=gen).bfloat16()
    before = A.FLASH_LAUNCHES.value
    out = A.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert A.FLASH_LAUNCHES.value == before + 1
    ref = A.attention_reference(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= 2.0**-5


@pytest.mark.parametrize("shape", [(1, 4, 4, 1000, 128), (2, 16, 4, 1024, 128), (1, 4, 1, 300, 256)])
def test_flash_kernel_is_deterministic(card, shape):
    """Two launches on the same inputs give the same bits (no atomics, one
    fixed order of the K tiles and of every reduction)."""
    b, hq, hkv, s, d = shape
    gen = torch.Generator(device=card).manual_seed(2)
    q = torch.randn(b, hq, s, d, device=card, generator=gen).bfloat16()
    k = torch.randn(b, hkv, s, d, device=card, generator=gen).bfloat16()
    v = torch.randn(b, hkv, s, d, device=card, generator=gen).bfloat16()
    for causal in (True, False):
        first = A.flash_attention(q, k, v, causal)
        assert torch.equal(A.flash_attention(q, k, v, causal), first)


def test_dispatch_launches_the_kernel_past_the_gate(card):
    q = torch.randn(1, 4, 128, 64, device=card).bfloat16()
    before = A.FLASH_LAUNCHES.value
    A.attention(q, q, q, causal=True)
    assert A.FLASH_LAUNCHES.value == before + 1
    short = q[:, :, :64].contiguous()
    out = A.attention(short, short, short)
    torch.cuda.synchronize()
    # seq < 128 too: on the card the dispatch has no plain path
    assert A.FLASH_LAUNCHES.value == before + 2
    ref = A.attention_reference(short, short, short)
    assert (out.float() - ref.float()).abs().max().item() <= 2.0**-5


def test_dispatches_raise_on_card_shapes_the_kernels_do_not_take(card):
    """head_dim 96 is no kernel head_dim: a CUDA call raises rather than run
    the plain version on the card; kernel=False still runs the plain path."""
    q = torch.randn(1, 4, 128, 96, device=card).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        A.attention(q, q, q)
    pq, kp, vp, tables, pos = _paged_case(card, 2, 4, 2, 96, 8, 2, seed=3)
    vq = torch.randn(2, 4, 3, 96, device=card)
    before = (A.PAGED_LAUNCHES.value, A.VERIFY_LAUNCHES.value)
    with pytest.raises(ValueError, match="head_dim"):
        A.paged_attention(pq, kp, vp, tables, pos, 8)
    with pytest.raises(ValueError, match="head_dim"):
        A.paged_attention_verify(vq, kp, vp, tables, pos, 8)
    off = A.paged_attention_verify(vq, kp, vp, tables, pos, 8, kernel=False)
    assert torch.equal(off, A.paged_verify_attention(vq, kp, vp, tables, pos, 8))
    assert (A.PAGED_LAUNCHES.value, A.VERIFY_LAUNCHES.value) == before


F32_SHAPES = [  # (B, Hq, Hkv, S, D)
    (1, 4, 4, 128, 64),
    (2, 8, 2, 200, 128),
    (1, 2, 1, 130, 256),
    (1, 8, 4, 300, 32),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", F32_SHAPES)
def test_flash_kernel_f32_matches_plain_version(card, shape, causal):
    b, hq, hkv, s, d = shape
    gen = torch.Generator(device=card).manual_seed(1)
    q = torch.randn(b, hq, s, d, device=card, generator=gen)
    k = torch.randn(b, hkv, s, d, device=card, generator=gen)
    v = torch.randn(b, hkv, s, d, device=card, generator=gen)
    before = A.FLASH_LAUNCHES.value
    out = A.attention(q, k, v, causal)  # the dispatch: f32 passes the gate too
    torch.cuda.synchronize()
    assert A.FLASH_LAUNCHES.value == before + 1
    ref = A.attention_reference(q, k, v, causal)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert (out - ref).abs().max().item() <= 1e-5


BF16_PAGED_TOL = 2.0**-10


def _kernel_reference(q, kp, vp, tables, pos, pt, ks=None, vs=None, splits=None):
    """The paged kernels' arithmetic under the plan a launch with these
    arguments takes (``A.paged_launch_plan``), in plain PyTorch, with the
    bound on what f32 noise can flip in its bf16 roundings of p
    (``paged_reference.flip_bound``; zero off bf16 pages)."""
    plan = A.paged_launch_plan(q, kp, tables, splits)
    rows = q.shape[2] * (q.shape[1] // kp.shape[1])
    return paged_split_reference(q, kp, vp, tables, pos, pt, plan["n_splits"],
                                 plan["pages_per_split"], ks, vs, walk=kernel_walk(plan, rows),
                                 with_bound=True)


def _bf16_off(got, held) -> float:
    """How far ``got`` is from the kernel reference ``held = (out, flip
    bound)``, beyond what a flipped bf16 rounding of p explains."""
    want, flips = held
    return ((got - want).abs() - flips).max().item()


def _paged_case(card, lanes, hq, hkv, d, pt, pps, seed):
    """Scattered arena, ragged pos, table slots past each lane's live pages
    on the trash page (the layout tests/test_paged_kernel.py builds)."""
    gen = torch.Generator().manual_seed(seed)
    n_pages = lanes * pps + 1
    tables = (torch.randperm(n_pages - 1, generator=gen) + 1).reshape(lanes, pps).int()
    pos = torch.randint(0, pps * pt, (lanes,), generator=gen).int()
    for s in range(lanes):
        tables[s, -(-(int(pos[s]) + 1) // pt):] = 0
    kp = torch.randn(n_pages, hkv, pt, d, generator=gen)
    vp = torch.randn(n_pages, hkv, pt, d, generator=gen)
    q = torch.randn(lanes, hq, 1, d, generator=gen)
    return [t.to(card) for t in (q, kp, vp, tables, pos)]


PAGED_CASES = [  # (lanes, Hq, Hkv, D, page_tokens, pages_per_slot)
    (5, 4, 4, 64, 8, 6),
    (4, 8, 2, 128, 16, 4),
    (3, 16, 2, 128, 16, 5),
    (2, 4, 2, 192, 32, 3),
    (3, 2, 2, 256, 64, 2),
    (8, 8, 4, 32, 16, 4),
    (3, 4, 4, 32, 8, 6),
]


@pytest.mark.parametrize("arena", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain_version(card, case, arena):
    lanes, hq, hkv, d, pt, pps = case
    q, kp, vp, tables, pos = _paged_case(card, lanes, hq, hkv, d, pt, pps, seed=sum(case))
    ks = vs = None
    if arena == "int8":
        from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows

        q = q.bfloat16()
        kp, ks = _quantize_kv_rows(kp)
        vp, vs = _quantize_kv_rows(vp)
        want = A.paged_decode_attention(q, A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs),
                                        tables, pos, pt)
    else:
        dt = getattr(torch, arena)
        q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
        want = A.paged_decode_attention(q, kp, vp, tables, pos, pt)
    tol = 1e-5  # f32 and int8 arenas, against the plain version
    before = A.PAGED_LAUNCHES.value
    got = A.paged_attention(q, kp, vp, tables, pos, pt, ks, vs)  # the dispatch
    torch.cuda.synchronize()
    assert A.PAGED_LAUNCHES.value == before + 1
    assert got.dtype == torch.float32 and got.shape == (lanes, hq, 1, d)
    if arena == "bfloat16":
        assert _bf16_off(got, _kernel_reference(q, kp, vp, tables, pos, pt)) <= BF16_PAGED_TOL
    else:
        assert (got - want).abs().max().item() <= tol
    off = A.paged_attention(q, kp, vp, tables, pos, pt, ks, vs, kernel=False)
    assert A.PAGED_LAUNCHES.value == before + 1  # kernel=False: the plain path
    assert torch.equal(off, want)


def test_paged_kernel_rejects_what_it_does_not_take(card):
    q, kp, vp, tables, pos = _paged_case(card, 2, 4, 2, 64, 8, 2, seed=0)
    with pytest.raises(ValueError, match="int32"):
        A.paged_decode_attention_kernel(q, kp, vp, tables.long(), pos, page_tokens=8)
    with pytest.raises(ValueError, match="page_tokens"):
        A.paged_decode_attention_kernel(q, kp, vp, tables, pos, page_tokens=16)
    with pytest.raises(ValueError, match="CUDA"):
        A.paged_decode_attention_kernel(q.cpu(), kp, vp, tables, pos, page_tokens=8)
    with pytest.raises(ValueError, match="scale"):
        A.paged_decode_attention_kernel(q, kp.to(torch.int8), vp.to(torch.int8), tables, pos,
                                        page_tokens=8)


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.randn(1, 2, 128, 64, device=card).half()
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        A.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one dtype"):
        A.flash_attention(q.float(), q.bfloat16(), q.bfloat16())
    qb = torch.randn(1, 2, 128, 320, device=card).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention(qb, qb, qb)
    qt = torch.randn(1, 2, 64, 128, device=card).bfloat16().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention(qt, qt, qt)


def _verify_case(card, lanes, hq, hkv, d, pt, pps, t_q, seed):
    """A scattered arena with ragged pos, lane 0's T positions running past
    the end of its table (they are clipped to the table's keys), and table
    slots past each lane's deepest frontier on the trash page."""
    gen = torch.Generator().manual_seed(seed)
    n_pages = lanes * pps + 1
    tables = (torch.randperm(n_pages - 1, generator=gen) + 1).reshape(lanes, pps).int()
    pos = torch.randint(0, pps * pt - t_q + 1, (lanes,), generator=gen).int()
    pos[0] = pps * pt - max(1, t_q // 2)
    for s in range(lanes):
        tables[s, -(-(int(pos[s]) + t_q) // pt):] = 0
    kp = torch.randn(n_pages, hkv, pt, d, generator=gen)
    vp = torch.randn(n_pages, hkv, pt, d, generator=gen)
    q = torch.randn(lanes, hq, t_q, d, generator=gen)
    return [t.to(card) for t in (q, kp, vp, tables, pos)]


VERIFY_CASES = [  # (lanes, Hq, Hkv, D, page_tokens, pages_per_slot, T, arena)
    (4, 8, 2, 128, 16, 4, 5, "bfloat16"),
    (3, 4, 4, 64, 8, 6, 9, "int8"),
    (5, 4, 2, 128, 16, 4, 1, "float32"),
    (8, 8, 4, 32, 16, 4, 5, "bfloat16"),
    (8, 8, 4, 32, 16, 4, 5, "int8"),
    (3, 4, 4, 32, 8, 6, 9, "float32"),
]


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_verify_kernel_matches_plain_version(card, case):
    """The paged verify kernel (B3) against ``paged_verify_attention``;
    tolerances as for the decode kernel (module docstring)."""
    lanes, hq, hkv, d, pt, pps, t_q, arena = case
    q, kp, vp, tables, pos = _verify_case(card, lanes, hq, hkv, d, pt, pps, t_q, seed=sum(case[:7]))
    ks = vs = None
    if arena == "int8":
        from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows

        q = q.bfloat16()
        kp, ks = _quantize_kv_rows(kp)
        vp, vs = _quantize_kv_rows(vp)
        want = A.paged_verify_attention(q, A.dequantize_pages(kp, ks),
                                        A.dequantize_pages(vp, vs), tables, pos, pt)
    else:
        dt = getattr(torch, arena)
        q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
        want = A.paged_verify_attention(q, kp, vp, tables, pos, pt)
    tol = 1e-5  # f32 and int8 arenas, against the plain version
    before = A.VERIFY_LAUNCHES.value
    got = A.paged_attention_verify(q, kp, vp, tables, pos, pt, ks, vs)  # the dispatch
    torch.cuda.synchronize()
    assert A.VERIFY_LAUNCHES.value == before + 1
    assert got.dtype == torch.float32 and got.shape == (lanes, hq, t_q, d)
    if arena == "bfloat16":
        assert _bf16_off(got, _kernel_reference(q, kp, vp, tables, pos, pt)) <= BF16_PAGED_TOL
    else:
        assert (got - want).abs().max().item() <= tol
    off = A.paged_attention_verify(q, kp, vp, tables, pos, pt, ks, vs, kernel=False)
    assert A.VERIFY_LAUNCHES.value == before + 1  # kernel=False: the plain path
    assert torch.equal(off, want)
    if t_q == 1:  # one body: the decode kernel at T = 1, bit for bit
        dec = A.paged_decode_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
        assert torch.equal(dec, got)


def _carry_case(card, b, hq, hkv, sq, sk, d, dtype, seed):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) ~ N(0, 1), and a carried state:
    the plain version's hop over an earlier block every row sees."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=card, generator=gen).to(dtype)

    q, k, v, k0, v0 = rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d), \
        rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)
    acc = torch.zeros(b, hq, sq, d, device=card)
    m = torch.full((b, hq, sq, 1), A.NEG_INF, device=card)
    l = torch.zeros(b, hq, sq, 1, device=card)
    acc, m, l = A.flash_attention_carry_reference(q, k0, v0, acc, m, l, -sk)
    return q, k, v, acc, m, l


CARRY_CASES = [  # (B, Hq, Hkv, Sq, Sk, D, dtype, rel, causal)
    (1, 4, 4, 256, 256, 128, torch.bfloat16, -256, True),   # a past block
    (1, 4, 4, 256, 256, 128, torch.bfloat16, 0, True),      # the diagonal
    (1, 4, 4, 256, 256, 128, torch.bfloat16, 256, True),    # a future block
    (2, 8, 2, 200, 130, 64, torch.bfloat16, 37, True),      # GQA, ragged, frontier mid-tile
    (1, 4, 2, 64, 64, 192, torch.bfloat16, -64, True),
    (1, 2, 2, 1, 1, 256, torch.bfloat16, 0, True),
    (1, 2, 2, 1, 1, 128, torch.bfloat16, -1, True),
    (1, 4, 4, 96, 160, 128, torch.bfloat16, 50, False),     # no causal mask: rel ignored
    (1, 4, 4, 130, 200, 128, torch.float32, 0, True),
    (1, 2, 1, 64, 64, 64, torch.float32, -64, True),
    (1, 2, 2, 1, 1, 128, torch.float32, 0, True),
    # the bf16 kernel's tiles: rel one row before, on and after a 64-row
    # tile edge (few live tiles: one consumer warpgroup, 64-row tiles) ...
    (1, 4, 4, 384, 384, 128, torch.bfloat16, 63, True),
    (1, 4, 4, 384, 384, 128, torch.bfloat16, 64, True),
    (1, 4, 4, 384, 384, 128, torch.bfloat16, 65, True),
    (1, 4, 4, 384, 384, 128, torch.bfloat16, -63, True),
    # ... and a 128-row edge with B*Hq*live tiles past the SM count (two
    # consumer warpgroups, 128-row tiles; a warpgroup of blind rows beside
    # one that sees keys)
    (2, 40, 8, 384, 384, 128, torch.bfloat16, -129, True),
    (2, 40, 8, 384, 384, 128, torch.bfloat16, -127, True),
    (2, 40, 8, 384, 384, 128, torch.bfloat16, 63, True),
    (2, 40, 8, 384, 384, 128, torch.bfloat16, 127, True),
    (2, 40, 8, 384, 384, 128, torch.bfloat16, 128, True),
    (2, 40, 8, 384, 384, 128, torch.bfloat16, 129, True),
    # Sq != Sk, Sk no multiple of the 128- or 64-key tile
    (1, 8, 8, 320, 200, 128, torch.bfloat16, 37, True),
    (1, 8, 8, 100, 333, 64, torch.bfloat16, -150, True),
    (1, 48, 48, 384, 200, 128, torch.bfloat16, 100, True),
    # D = 192 and 256 (64-key tiles), one and two consumer warpgroups
    (1, 4, 4, 300, 300, 192, torch.bfloat16, 70, True),
    (1, 48, 48, 384, 384, 192, torch.bfloat16, -1, True),
    (1, 4, 2, 300, 260, 256, torch.bfloat16, -100, True),
    (1, 48, 24, 384, 384, 256, torch.bfloat16, 127, True),
    # more live tiles than twice the SM count: every block walks several
    (4, 16, 4, 1024, 1024, 128, torch.bfloat16, 0, True),
    (2, 32, 32, 1024, 1024, 64, torch.bfloat16, -1024, True),
    # head_dim 32 in the 64-column tile (carry columns past 32 neither
    # loaded nor stored): a past hop, GQA with a mid-tile frontier, two
    # consumer warpgroups, f32
    (1, 8, 8, 1024, 1024, 32, torch.bfloat16, -1024, True),
    (2, 8, 4, 200, 130, 32, torch.bfloat16, 37, True),
    (2, 40, 8, 384, 384, 32, torch.bfloat16, 63, True),
    (1, 4, 4, 130, 200, 32, torch.float32, 0, True),
]


def _bits(t):
    """f32 bit patterns: unlike torch.equal, -0.0 differs from +0.0."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", CARRY_CASES)
def test_carry_kernel_matches_plain_version(card, case):
    """B4 against ``flash_attention_carry_reference`` from a carried state.
    Tolerances: the normalized output acc / l 2**-8 in bf16 (both sides
    round p to bf16, from f32 p values a few ulps apart and at other points
    of the online softmax), 1e-5 in f32; m 1e-4 (f32 scores summed in
    another order, the bf16 body's log2 units converted at both ends). Rows
    that see no key of the hop (r < rel) keep their carry bit for bit, a
    -0.0 seeded in their acc included (a write-back of the unchanged value
    would give +0.0)."""
    b, hq, hkv, sq, sk, d, dtype, rel, causal = case
    q, k, v, acc, m, l = _carry_case(card, b, hq, hkv, sq, sk, d, dtype, seed=sum(case[:6]))
    blind = max(0, min(rel, sq)) if causal else 0  # rows 0 .. rel - 1 see nothing
    acc[:, :, :blind, ::3] = -0.0
    want = A.flash_attention_carry_reference(q, k, v, acc, m, l, rel, causal)
    before = A.CARRY_LAUNCHES.value
    got = A.attention_carry(q, k, v, acc.clone(), m.clone(), l.clone(), rel, causal)
    torch.cuda.synchronize()
    assert A.CARRY_LAUNCHES.value == before + 1
    tol = 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    norm = got[0] / got[2].clamp_min(1e-30)
    want_norm = want[0] / want[2].clamp_min(1e-30)
    assert (norm - want_norm).abs().max().item() <= tol
    assert (got[1] - want[1]).abs().max().item() <= 1e-4
    for g, old in zip(got, (acc, m, l)):
        assert torch.equal(_bits(g[:, :, :blind]), _bits(old[:, :, :blind]))


def test_carry_kernel_at_rel_0_from_an_empty_carry_is_close_to_the_flash_kernel(card):
    """B4 at rel = 0, Sq = Sk, from an empty carry, normalized as B2
    normalizes (times the reciprocal of max(l, 1e-30), rounded to bf16), is
    within the flash tolerance (2**-5) of B2's output. The bf16 B4 kernel is
    B2's design (wgmma with 128-key tiles, 64 for D > 128, p rounded against
    the same running max), written as a kernel of its own, so the gap is far
    below the bar; the bar is the flash kernel's."""
    for (b, hq, hkv, s, d) in [(1, 8, 8, 256, 128), (2, 8, 2, 200, 64)]:
        gen = torch.Generator(device=card).manual_seed(s)
        q = torch.randn(b, hq, s, d, device=card, generator=gen).bfloat16()
        k = torch.randn(b, hkv, s, d, device=card, generator=gen).bfloat16()
        v = torch.randn(b, hkv, s, d, device=card, generator=gen).bfloat16()
        acc = torch.zeros(b, hq, s, d, device=card)
        m = torch.full((b, hq, s, 1), A.NEG_INF, device=card)
        l = torch.zeros(b, hq, s, 1, device=card)
        acc, m, l = A.flash_attention_carry(q, k, v, acc, m, l, 0)
        out = (acc * (1.0 / l.clamp_min(1e-30))).bfloat16()
        b2 = A.flash_attention(q, k, v, True)
        assert (out.float() - b2.float()).abs().max().item() <= 2.0**-5


def test_ring_on_one_card_matches_attention_reference(card):
    """A 4-shard ring over [cuda:0] * 4: 16 B4 launches, the output within
    the flash kernel's bf16 tolerance of the plain attention."""
    gen = torch.Generator(device=card).manual_seed(9)
    q, k, v = (torch.randn(1, 8, 512, 128, device=card, generator=gen).bfloat16()
               for _ in range(3))
    from tfservingcache_tpu_torch.parallel.ring_attention import ring_attention

    before = A.CARRY_LAUNCHES.value
    out = ring_attention(q, k, v, [card] * 4)
    torch.cuda.synchronize()
    assert A.CARRY_LAUNCHES.value == before + 16
    ref = A.attention_reference(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= 2.0**-5


def test_carry_dispatch_raises_on_what_the_kernel_does_not_take(card):
    q = torch.randn(1, 4, 128, 96, device=card).bfloat16()
    acc = torch.zeros(1, 4, 128, 96, device=card)
    m = torch.full((1, 4, 128, 1), A.NEG_INF, device=card)
    l = torch.zeros(1, 4, 128, 1, device=card)
    before = A.CARRY_LAUNCHES.value
    with pytest.raises(ValueError, match="head_dim"):
        A.attention_carry(q, q, q, acc, m, l, 0)
    q64 = torch.randn(1, 4, 128, 64, device=card).bfloat16()
    acc64 = torch.zeros(1, 4, 128, 64, device=card)
    with pytest.raises(ValueError, match="float32"):
        A.attention_carry(q64, q64, q64, acc64.bfloat16(), m, l, 0)
    assert A.CARRY_LAUNCHES.value == before


# ---- grids past 65535 (B * Hq for B2 and B4, lanes for the paged kernels) ----

BIG_BH = (4096, 16, 16, 8, 64)  # (B, Hq, Hkv, S, D): B * Hq = 65536 with a short S


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_takes_65536_batch_heads(card, dtype):
    b, hq, hkv, s, d = BIG_BH
    gen = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn(b, n, s, d, device=card, generator=gen).to(dtype) for n in (hq, hkv, hkv))
    out = A.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    ref = A.attention_reference(q, k, v, True)
    tol = 2.0**-5 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_carry_kernel_takes_65536_batch_heads(card, dtype):
    b, hq, hkv, s, d = BIG_BH
    q, k, v, acc, m, l = _carry_case(card, b, hq, hkv, s, s, d, dtype, seed=12)
    want = A.flash_attention_carry_reference(q, k, v, acc, m, l, 0)
    got = A.flash_attention_carry(q, k, v, acc.clone(), m.clone(), l.clone(), 0)
    torch.cuda.synchronize()
    tol = 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    norm = got[0] / got[2].clamp_min(1e-30)
    assert (norm - want[0] / want[2].clamp_min(1e-30)).abs().max().item() <= tol


@pytest.mark.parametrize("verify", [False, True])
def test_paged_kernels_take_more_than_65535_lanes(card, verify):
    """70000 lanes, Hq = Hkv = 1, D = 64, one 16-token page a lane."""
    lanes, pt = 70000, 16
    gen = torch.Generator(device=card).manual_seed(13)
    t_q = 3 if verify else 1
    tables = torch.arange(1, lanes + 1, device=card, dtype=torch.int32)[:, None]
    pos = torch.randint(0, pt - t_q + 1, (lanes,), device=card, generator=gen).int()
    kp, vp = (torch.randn(lanes + 1, 1, pt, 64, device=card, generator=gen).bfloat16()
              for _ in range(2))
    q = torch.randn(lanes, 1, t_q, 64, device=card, generator=gen).bfloat16()
    fn = A.paged_verify_attention_kernel if verify else A.paged_decode_attention_kernel
    got = fn(q, kp, vp, tables, pos, page_tokens=pt)
    torch.cuda.synchronize()
    assert _bf16_off(got, _kernel_reference(q, kp, vp, tables, pos, pt)) <= BF16_PAGED_TOL


# ---- the paged kernels' page-axis split ----

SPLIT_CASES = [  # (lanes, Hq, Hkv, D, page_tokens, pages_per_slot, T)
    (3, 8, 2, 128, 16, 9, 1),
    (4, 4, 4, 64, 8, 12, 5),
    (2, 16, 2, 256, 16, 6, 5),
    (3, 4, 1, 192, 32, 5, 9),
    (2, 8, 8, 128, 16, 5, 80),  # two row tiles on the mma path
    (4, 8, 4, 32, 16, 12, 5),
]


def _arena_for(card, case, arena, seed):
    lanes, hq, hkv, d, pt, pps, t_q = case
    q, kp, vp, tables, pos = _verify_case(card, lanes, hq, hkv, d, pt, pps, t_q, seed)
    pos[1 % lanes] = 1  # a lane whose frontier ends in the first page: later splits see nothing
    ks = vs = None
    if arena == "int8":
        from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows

        q = q.bfloat16()
        kp, ks = _quantize_kv_rows(kp)
        vp, vs = _quantize_kv_rows(vp)
        plain = (A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs))
    else:
        dt = getattr(torch, arena)
        q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
        plain = (kp, vp)
    return q, kp, vp, tables, pos, ks, vs, plain


@pytest.mark.parametrize("arena", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_paged_kernels_under_every_split_match_the_plain_version(card, case, arena):
    """B1 (T = 1 rows of the case) and B3 with the page axis forced into 1, 2
    and pps splits, against the plain version (f32, int8) or the kernels'
    arithmetic under that split (bf16; module docstring's tolerances); two
    calls give the same bits, and B3 at T = 1 is B1 bit for bit under every
    split."""
    lanes, hq, hkv, d, pt, pps, t_q = case
    q, kp, vp, tables, pos, ks, vs, plain = _arena_for(card, case, arena, seed=sum(case))
    q1 = q[:, :, :1].contiguous()

    def off(got, q_in, splits):
        if arena == "bfloat16":
            return _bf16_off(got, _kernel_reference(q_in, kp, vp, tables, pos, pt, splits=splits))
        want = A.paged_verify_attention(q_in, *plain, tables, pos, pt)
        return (got - want).abs().max().item()

    tol = BF16_PAGED_TOL if arena == "bfloat16" else 1e-5
    for splits in (1, 2, pps):
        got = A._paged_kernel(True, q, kp, vp, tables, pos, ks, vs, pt, splits=splits)
        again = A._paged_kernel(True, q, kp, vp, tables, pos, ks, vs, pt, splits=splits)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert off(got, q, splits) <= tol, splits
        assert torch.equal(got, again), splits
        dec = A._paged_kernel(False, q1, kp, vp, tables, pos, ks, vs, pt, splits=splits)
        ver = A._paged_kernel(True, q1, kp, vp, tables, pos, ks, vs, pt, splits=splits)
        assert off(dec, q1, splits) <= tol, splits
        assert torch.equal(dec, ver), splits


@pytest.mark.parametrize("arena", ["bfloat16", "int8"])
def test_paged_dispatches_add_no_host_sync(card, arena):
    """Each paged dispatch, warm, under torch.cuda.set_sync_debug_mode("error"):
    the split plan reads shapes, never pos, so nothing waits on the card."""
    case = (8, 32, 32, 128, 16, 20, 5)
    q, kp, vp, tables, pos, ks, vs, _ = _arena_for(card, case, arena, seed=21)
    q1 = q[:, :, :1].contiguous()
    A.paged_attention(q1, kp, vp, tables, pos, 16, ks, vs)
    A.paged_attention_verify(q, kp, vp, tables, pos, 16, ks, vs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        A.paged_attention(q1, kp, vp, tables, pos, 16, ks, vs)
        A.paged_attention_verify(q, kp, vp, tables, pos, 16, ks, vs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("q_dtype, kv_dtype, want", [
    (torch.bfloat16, torch.bfloat16, (True, 64, 16)),
    (torch.bfloat16, torch.int8, (False, 16, 4)),
    (torch.float32, torch.float32, (False, 16, 4)),
    (torch.float32, torch.bfloat16, (False, 16, 4)),
])
def test_paged_launch_plan_reads_the_kernel_tiling(card, q_dtype, kv_dtype, want):
    """The plan takes its path and row tile from the library
    (tpusc_paged_tiling): bf16 q over bf16 pages runs mma.sync on 64-row
    tiles, every other pair SIMT on 16-row tiles."""
    q = torch.zeros(8, 32, 5, 128, device=card, dtype=q_dtype)
    kp = torch.zeros(3, 32, 16, 128, device=card).to(kv_dtype)
    tables = torch.zeros(8, 69, device=card, dtype=torch.int32)
    plan = A.paged_launch_plan(q, kp, tables)
    assert (plan["mma"], plan["row_tile"], plan["unit"]) == want
    n, per = A.paged_split_plan(8, 32, 5, 69, 16, torch.cuda.get_device_properties(0).multi_processor_count,
                                want[1], A.SPLIT_BLOCKS_PER_SM["mma" if want[0] else "simt"])
    assert (plan["n_splits"], plan["pages_per_split"]) == (n, per)


def _verify_against_plain(q, kp, vp, tables, pos, pt, ks=None, vs=None):
    """One verify dispatch against the plain version (f32 / int8 pages at
    1e-5) or, on bf16 pages, the kernel reference (module docstring)."""
    before = A.VERIFY_LAUNCHES.value
    got = A.paged_attention_verify(q, kp, vp, tables, pos, pt, ks, vs)
    torch.cuda.synchronize()
    assert A.VERIFY_LAUNCHES.value == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    if kp.dtype == torch.bfloat16:
        assert _bf16_off(got, _kernel_reference(q, kp, vp, tables, pos, pt)) <= BF16_PAGED_TOL
        return
    if ks is not None:
        kp, vp = A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs)
    assert (got - A.paged_verify_attention(q, kp, vp, tables, pos, pt)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("arena", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("start", [0, 256, 768])
def test_verify_kernel_at_the_prefill_chunk_shape(card, start, arena):
    """B3 at a chunked prefill's shape at llama-7b width: ONE lane,
    (Hq, Hkv, D, page_tokens) = (32, 32, 128, 16), T = 256 queries from
    ``start`` over shuffled pages holding start + 256 keys."""
    gen = torch.Generator().manual_seed(start + 7)
    hq, hkv, d, pt, t_q = 32, 32, 128, 16, 256
    pps = (start + t_q) // pt
    tables = (torch.randperm(pps, generator=gen) + 1).reshape(1, pps).int().to(card)
    pos = torch.tensor([start], dtype=torch.int32, device=card)
    kp = torch.randn(pps + 1, hkv, pt, d, generator=gen).to(card)
    vp = torch.randn(pps + 1, hkv, pt, d, generator=gen).to(card)
    q = torch.randn(1, hq, t_q, d, generator=gen).to(card)
    if arena == "int8":
        from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows

        (kq, ks), (vq, vs) = _quantize_kv_rows(kp), _quantize_kv_rows(vp)
        _verify_against_plain(q.bfloat16(), kq, vq, tables, pos, pt, ks, vs)
    else:
        dt = getattr(torch, arena)
        _verify_against_plain(q.to(dt), kp.to(dt), vp.to(dt), tables, pos, pt)


@pytest.mark.parametrize("arena_dtype", ["", "int8"])
def test_paged_prefill_chunk_on_the_card_matches_the_plain_path(card, arena_dtype):
    """``generation.paged_prefill_chunk`` on the card (B3 at T = 256, one
    launch a layer) against the same chunks through the plain path, on a
    2-layer bf16 model with head_dim 128: every chunk's last logits within
    0.125 (chip_smoke's LOGITS_TOL: attention rounding through the layers,
    logits ~N(0, 1)) with argmax equal where the top-2 margin exceeds twice
    the gap, layer 0's written rows bit for bit (no attention before them;
    the trash page aside), and a warm chunk adds no host sync."""
    from tfservingcache_tpu_torch.models import generation as G
    from tfservingcache_tpu_torch.models import registry

    model_def = registry.build("transformer_lm", {
        "vocab_size": 512, "d_model": 256, "n_layers": 2, "n_heads": 2, "n_kv_heads": 2,
        "d_ff": 512, "max_seq": 1024, "dtype": "bfloat16"})
    cfg = model_def.config
    params = model_def.init(torch.Generator(device=card).manual_seed(0))

    def to_bf16(tree):
        if isinstance(tree, dict):
            return {k: to_bf16(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_bf16(v) for v in tree]
        return tree.to(torch.bfloat16)

    model = model_def.make_module(to_bf16(params)).eval()
    pt, chunk, p = 16, 256, 600
    pps = cfg["max_seq"] // pt
    arenas = [G.init_paged_cache(cfg, 48, pt, arena_dtype, card) for _ in range(2)]
    gen = torch.Generator().manual_seed(1)
    table = torch.zeros(1, pps, dtype=torch.int32)
    table[0, :-(-p // pt)] = torch.randperm(47, generator=gen)[:-(-p // pt)] + 1
    table = table.to(card)
    prompt = torch.randint(0, 512, (p,), generator=gen)
    for start in range(0, p, chunk):
        n = min(chunk, p - start)
        toks = torch.zeros(1, chunk, dtype=torch.int64)
        toks[0, :n] = prompt[start:start + n]
        toks, s0 = toks.to(card), torch.tensor([start], dtype=torch.int32, device=card)
        before = A.VERIFY_LAUNCHES.value
        if start == chunk:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = G.paged_prefill_chunk(model, cfg, arenas[0], table, toks, s0, n, pt, True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert A.VERIFY_LAUNCHES.value == before + cfg["n_layers"]
        want = G.paged_prefill_chunk(model, cfg, arenas[1], table, toks, s0, n, pt, False)
        assert A.VERIFY_LAUNCHES.value == before + cfg["n_layers"]
        gap = (got - want).abs().max().item()
        assert gap <= 0.125
        top2 = want.topk(2, dim=-1).values
        if (top2[0, 0] - top2[0, 1]).item() > 2 * gap:
            assert int(got.argmax()) == int(want.argmax())
    # page 0 (the trash page) excluded: it takes every pad row past the
    # reservation, several writes to one slot in one scatter, and which of
    # them lands last is unspecified on the card
    for name in arenas[0]:
        assert torch.equal(arenas[0][name][0, 1:], arenas[1][name][0, 1:]), name


CARD_LM = {"vocab_size": 512, "d_model": 256, "n_layers": 2, "n_heads": 2, "n_kv_heads": 2,
           "d_ff": 512, "max_seq": 256, "dtype": "bfloat16"}


@pytest.mark.parametrize("arena_dtype", ["", "int8"])
def test_pages_export_import_bit_identical_on_the_card(card, arena_dtype):
    """``pages_export`` of random arena pages on the card, through the host
    (``host_pages``), a blob (``pack_parked`` / ``unpack_parked``) and back
    (``device_pages``), then ``pages_import`` into other pages: every
    buffer (values, and an int8 arena's scales) equal bit for bit."""
    from tfservingcache_tpu_torch.cache import conversation_kv as ckv
    from tfservingcache_tpu_torch.models import generation as G

    arena = G.init_paged_cache(CARD_LM, 24, 16, arena_dtype, card)
    gen = torch.Generator(device=card).manual_seed(3)
    for name, t in arena.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, device=card, generator=gen))
        else:
            t.copy_(torch.randn(t.shape, device=card, generator=gen))
    src, dst = [3, 7, 1, 12], [20, 21, 22, 23]
    rows = G.pages_export(arena, src)
    k, dt = ckv.host_pages(rows["k"])
    v, _ = ckv.host_pages(rows["v"])
    scales = {n: rows[n].cpu().numpy() for n in ("k_scale", "v_scale") if n in rows}
    parked = ckv.unpack_parked(ckv.pack_parked(ckv.ParkedConversation(
        model_id="lm@1", history=np.arange(60, dtype=np.int32), pages_k=k, pages_v=v,
        k_scale=scales.get("k_scale"), v_scale=scales.get("v_scale"), page_tokens=16,
        page_dtype=dt)))
    payload = {"k": ckv.device_pages(parked.pages_k, parked.page_dtype, card),
               "v": ckv.device_pages(parked.pages_v, parked.page_dtype, card)}
    if arena_dtype == "int8":
        payload["k_scale"] = ckv.device_pages(parked.k_scale, "float32", card)
        payload["v_scale"] = ckv.device_pages(parked.v_scale, "float32", card)
    assert all(t.is_cuda for t in payload.values())
    G.pages_import(arena, dst, payload)
    torch.cuda.synchronize()
    for name, t in arena.items():
        assert torch.equal(t[:, dst], t[:, src]), name


@pytest.mark.parametrize("arena_dtype", ["", "int8"])
def test_park_and_resume_on_the_card(card, tmp_path, arena_dtype):
    """A lane parked on the card (``park_lane``), packed and unpacked, then
    resumed into another lane (``slot_resume_prefill``): the resumed pages
    equal the parked ones bit for bit, and the suffix prefill's rows land
    after them."""
    from tfservingcache_tpu_torch.cache import conversation_kv as ckv
    from tfservingcache_tpu_torch.config import ServingConfig
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime, _arena
    from tfservingcache_tpu_torch.types import Model, ModelId

    registry.export_artifact("transformer_lm", str(tmp_path), name="lm", config=CARD_LM)
    mid = ModelId("lm", 1)
    rt = TorchModelRuntime(ServingConfig(), device="cuda")
    rt.ensure_loaded(Model(identifier=mid, path=str(tmp_path / "lm" / "1")))
    try:
        st = rt.slot_decode_state(mid, 2, page_tokens=16, arena_pages=40, arena_dtype=arena_dtype)
        prompt = np.random.default_rng(0).integers(0, 512, 100).astype(np.int32)
        assert st.reserve_pages(0, 120)
        _tok, pk, pv = rt.slot_prefill(mid, prompt, 0.0, 0, 0)
        rt.slot_admit(st, 0, pk, pv)
        parked = rt.park_lane(st, 0, prompt)
        assert parked.pages_k.shape[1] == 7
        src = list(st.lane_pages[0][:7])
        parked = ckv.unpack_parked(ckv.pack_parked(parked))
        assert st.reserve_pages(1, 120)
        longer = np.concatenate([prompt, [1, 2, 3]]).astype(np.int32)
        covered, n_pages = rt.plan_conversation_resume(st, longer, parked)
        assert (covered, n_pages) == (100, 7)
        tok, pk2, pv2, _last = rt.slot_resume_prefill(mid, st, 1, longer, parked, covered,
                                                      n_pages, 0.0, 0, 0)
        rt.slot_admit(st, 1, pk2, pv2, base_tokens=covered)
        torch.cuda.synchronize()
        dst = st.lane_pages[1][:7]
        for name, t in _arena(st).items():
            # page 6 holds rows 96..111: 96..99 parked, 100..102 the suffix's
            assert torch.equal(t[:, dst[:6]], t[:, src[:6]]), name
            assert torch.equal(t[:, dst[6], :, :4], t[:, src[6], :, :4]), name
        assert 0 <= tok < 512
        for lane in (0, 1):
            st.release_pages(lane)
        st.check_page_conservation()
    finally:
        rt.close()


def test_one_sse_request_through_the_server_on_the_card(card, tmp_path):
    """``:generate?stream=true`` through ``build_node`` on the card: a token
    frame a token, the done frame equal to the buffered answer, and the
    paged kernel launched for the streamed decode."""
    import json
    import urllib.request

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.server import build_node

    registry.export_artifact("transformer_lm", str(tmp_path / "store"), name="lm",
                             config=CARD_LM)
    node = build_node(config_from_dict({
        "serving": {"generate_engine": "continuous", "generate_slots": 4,
                    "kv_page_tokens": 16},
        "cache": {"base_dir": str(tmp_path / "cache")},
        "model_provider": {"base_dir": str(tmp_path / "store")},
        "cache_node": {"rest_port": 0, "grpc_port": 0}}))
    url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/lm/versions/1:generate"
    body = json.dumps({"input_ids": [list(range(1, 40))], "max_new_tokens": 12}).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=300) as resp:
            want = json.loads(resp.read())["tokens"]
        before = A.PAGED_LAUNCHES.value
        req = urllib.request.Request(url + "?stream=true", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            frames = [json.loads(line[6:]) for line in resp.read().split(b"\n")
                      if line.startswith(b"data: ")]
        assert frames[-1] == {"done": True, "tokens": want}
        assert [f["token"] for f in frames[:-1]] == want[0]
        assert A.PAGED_LAUNCHES.value > before
    finally:
        node.close()


def test_chained_device_time_replays_a_captured_b1_chain(card):
    """utils/benchtime on the card: a chain of B1 launches captured as CUDA
    graphs gives a positive estimate. The launch counter counts the Python
    calls (each graph's warm-up and capture) and no replay, and reads 0
    again once reset."""
    from tfservingcache_tpu_torch.utils.benchtime import chained_device_time

    case = (8, 32, 32, 128, 16, 20, 1)
    q, kp, vp, tables, pos, _ks, _vs, _ = _arena_for(card, case, "bfloat16", seed=25)
    calls = []

    def b1(q):
        calls.append(1)
        return A.paged_attention(q, kp, vp, tables, pos, 16)

    A.PAGED_LAUNCHES.reset()
    est, dominated = chained_device_time(b1, (q,), iters=16, return_valid=True)
    assert est > 0 and isinstance(dominated, bool)
    assert A.PAGED_LAUNCHES.value == len(calls) > 0
    A.PAGED_LAUNCHES.reset()
    assert A.PAGED_LAUNCHES.value == 0


def test_chained_device_time_raises_on_a_host_read(card):
    """A function that reads a device value on the host cannot be captured:
    the timer raises naming that, it times nothing another way."""
    from tfservingcache_tpu_torch.utils.benchtime import chained_device_time

    x = torch.ones(64, device=card)
    with pytest.raises(RuntimeError, match="cannot be captured in a CUDA graph"):
        chained_device_time(lambda x: x * float(x.sum()), (x,), iters=4)


# ---- the paged kernels on each shard of a group's arena ----

@pytest.mark.parametrize("arena", ["bfloat16", "int8"])
def test_paged_kernels_on_each_shard_of_a_group_arena(card, arena):
    """A 2-layer arena placed by ``shard_kv_arena`` on ``[cuda:0] * 2`` (the
    tensor-parallel ``:generate`` on one card): each shard is a contiguous
    tensor of its own, and B1 (T = 1) and B3 (T = 5) on each shard's layer
    slice, over that shard's query heads, match the plain version on the
    same shard with the tolerances above; one launch of each a layer and
    shard."""
    from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows
    from tfservingcache_tpu_torch.parallel.sharding import KVShards, shard_kv_arena

    lanes, hq, hkv, d, pt, pps, t_q = 4, 8, 4, 128, 16, 4, 5
    _q, kp, vp, tables, pos = _verify_case(card, lanes, hq, hkv, d, pt, pps, t_q, seed=41)
    gen = torch.Generator(device=card).manual_seed(41)
    whole = {"k": torch.stack([kp, kp.flip(0)]), "v": torch.stack([vp, vp.flip(0)])}
    if arena == "int8":
        whole["k"], whole["k_scale"] = _quantize_kv_rows(whole["k"])
        whole["v"], whole["v_scale"] = _quantize_kv_rows(whole["v"])
    else:
        whole = {name: t.bfloat16() for name, t in whole.items()}
    placed = shard_kv_arena(whole, (card, card))
    A.PAGED_LAUNCHES.reset()
    A.VERIFY_LAUNCHES.reset()
    for name, buf in placed.items():
        assert isinstance(buf, KVShards) and len(buf.shards) == 2, name
    for i in range(2):
        shard = {name: buf.shards[i] for name, buf in placed.items()}
        assert all(t.is_contiguous() and t.shape[2] == hkv // 2 for t in shard.values())
        for layer in range(2):
            kl, vl = shard["k"][layer], shard["v"][layer]
            ks = shard["k_scale"][layer] if arena == "int8" else None
            vs = shard["v_scale"][layer] if arena == "int8" else None
            plain = ((A.dequantize_pages(kl, ks), A.dequantize_pages(vl, vs))
                     if arena == "int8" else (kl, vl))
            for t in (1, t_q):
                q = torch.randn(lanes, hq // 2, t, d, device=card, generator=gen).bfloat16()
                dispatch = A.paged_attention if t == 1 else A.paged_attention_verify
                got = dispatch(q, kl, vl, tables, pos, pt, ks, vs)
                want = A.paged_verify_attention(q, *plain, tables, pos, pt)
                assert got.shape == (lanes, hq // 2, t, d)
                if arena == "bfloat16":
                    held = _kernel_reference(q, kl, vl, tables, pos, pt)
                    assert _bf16_off(got, held) <= BF16_PAGED_TOL, (i, layer, t)
                else:
                    assert (got - want).abs().max().item() <= 1e-5, (i, layer, t)
    torch.cuda.synchronize()
    assert A.PAGED_LAUNCHES.value == A.VERIFY_LAUNCHES.value == 2 * 2


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_sharded_pipelined_transfer_lands_the_serialized_group_loads_shards(
        card, tmp_path, monkeypatch, quantize):
    """The group's cold path on ``[cuda:0] * 2``: the sharded pipelined
    transfer (many chunks, the copy stream, page-locked staging) lands
    shards ``torch.equal`` to the serialized group load's, each contiguous
    with the same strides, for a bf16 and an int8 artifact (the int8 one
    expanded on the host; its weights equal the device expansion cut by
    the same plan), and the two loads answer byte for byte."""
    from tfservingcache_tpu_torch.config import ServingConfig
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.parallel.sharding import shard_params
    from tfservingcache_tpu_torch.runtime import model_runtime as mr
    from tfservingcache_tpu_torch.types import Model, ModelId

    monkeypatch.setattr(mr, "_PACK_CHUNK_BYTES", 1 << 20)
    cfg = dict(CARD_LM, vocab_size=4096, d_ff=1024)
    path = registry.export_artifact("transformer_lm", str(tmp_path), name="g", config=cfg,
                                    quantize=quantize)
    model, mid = Model(ModelId("g", 1), path), ModelId("g", 1)
    group = [card, card]
    pipe = mr.TorchModelRuntime(ServingConfig(), devices=group)
    ser = mr.TorchModelRuntime(ServingConfig(cold_load_pipeline=False), devices=group)
    try:
        assert pipe.cold_pipeline_enabled and not ser.cold_pipeline_enabled
        pipe.ensure_loaded(model)
        ser.ensure_loaded(model)
        got = registry.flatten_params(pipe._resident.get(mid).params)
        want = registry.flatten_params(ser._resident.get(mid).params)
        host = registry.load_artifact(path, raw_quant=True)[1]
        plan = registry.build("transformer_lm", cfg).tensor_parallel(pipe.group)
        expanded = registry.flatten_params(shard_params(
            mr._dequantize_on_device(mr._to_device(host, card)), plan.rules, pipe.group))
        for (path_, a), (_p, b), (_q, c) in zip(got, want, expanded):
            assert a.spec == b.spec and a.shape == b.shape, path_
            for x, y, z in zip(a.shards, b.shards, c.shards):
                assert x.is_cuda and x.is_contiguous() and x.stride() == y.stride(), path_
                assert torch.equal(x, y) and torch.equal(x, z), path_
        ids = np.arange(2 * 96).reshape(2, 96).astype(np.int32) % cfg["vocab_size"]
        a = pipe.predict(mid, {"input_ids": ids}, output_filter=["logits"])["logits"]
        b = ser.predict(mid, {"input_ids": ids}, output_filter=["logits"])["logits"]
        np.testing.assert_array_equal(a, b)
    finally:
        pipe.close()
        ser.close()
