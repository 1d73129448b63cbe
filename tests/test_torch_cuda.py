"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

They skip without a CUDA device. On a machine with a card (which has no
JAX), run them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: 2**-5 absolute on N(0, 1) inputs (one bf16 ulp at |x| in
[4, 8); the kernel rounds p to bf16 before p.v, the plain version keeps
f32).
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
    A.attention(q[:, :, :64].contiguous(), q[:, :, :64].contiguous(), q[:, :, :64].contiguous())
    assert A.FLASH_LAUNCHES.value == before + 1  # seq < 128: the gate's plain path


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.randn(1, 2, 128, 64, device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        A.flash_attention(q, q, q)
    qb = torch.randn(1, 2, 128, 320, device=card).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention(qb, qb, qb)
    qt = torch.randn(1, 2, 64, 128, device=card).bfloat16().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention(qt, qt, qt)
