"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

They skip without a CUDA device. On a machine with a card (which has no
JAX), run them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, on N(0, 1) inputs:
  - flash, bf16: 2**-5 absolute (one bf16 ulp at |x| in [4, 8); the kernel
    rounds p to bf16 before p.v, the plain version keeps f32);
  - flash, f32: 1e-5 absolute (same f32 math, other summation order);
  - paged decode, f32 arena: 1e-5; int8 arena: 1e-5 (both sides dequantize
    to the same f32 values); bf16 arena: 2**-8 (both round p to bf16, at
    other points of the online softmax: p differs by a bf16 ulp, the output
    is a convex mix of N(0, 1) values).
"""

import pytest
import torch

from tfservingcache_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

SHAPES = [  # (B, Hq, Hkv, S, D)
    (1, 4, 4, 128, 64),
    (2, 8, 2, 200, 128),
    (1, 4, 2, 300, 192),
    (1, 2, 2, 130, 256),
    (1, 2, 1, 1, 128),
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
        tol = 1e-5
    else:
        dt = getattr(torch, arena)
        q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
        want = A.paged_decode_attention(q, kp, vp, tables, pos, pt)
        tol = 1e-5 if arena == "float32" else 2.0**-8
    before = A.PAGED_LAUNCHES.value
    got = A.paged_attention(q, kp, vp, tables, pos, pt, ks, vs)  # the dispatch
    torch.cuda.synchronize()
    assert A.PAGED_LAUNCHES.value == before + 1
    assert got.dtype == torch.float32 and got.shape == (lanes, hq, 1, d)
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
        tol = 1e-5
    else:
        dt = getattr(torch, arena)
        q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
        want = A.paged_verify_attention(q, kp, vp, tables, pos, pt)
        tol = 1e-5 if arena == "float32" else 2.0**-8
    before = A.VERIFY_LAUNCHES.value
    got = A.paged_attention_verify(q, kp, vp, tables, pos, pt, ks, vs)  # the dispatch
    torch.cuda.synchronize()
    assert A.VERIFY_LAUNCHES.value == before + 1
    assert got.dtype == torch.float32 and got.shape == (lanes, hq, t_q, d)
    assert (got - want).abs().max().item() <= tol
    off = A.paged_attention_verify(q, kp, vp, tables, pos, pt, ks, vs, kernel=False)
    assert A.VERIFY_LAUNCHES.value == before + 1  # kernel=False: the plain path
    assert torch.equal(off, want)
    if t_q == 1:  # one body: the decode kernel at T = 1, bit for bit
        dec = A.paged_decode_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
        assert torch.equal(dec, got)
