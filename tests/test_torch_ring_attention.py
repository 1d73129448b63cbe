"""The port's ring attention (tfservingcache_tpu_torch/parallel/ring_attention.py)
and its carry step (``ops/attention.py``) against the JAX package on the
same numpy inputs.

The carry step's plain version is held to the Pallas carry kernel
``flash_attention_carry`` run in interpret mode, at Sq = Sk = 256 (the
kernel takes multiples of 128), rel in {-256, -128, 0, 128, 256} and one row
either side of a 128-row tile edge ({-129, -127, 127, 129}: where the CUDA
kernel's masks and skipped tiles change), causal and full, GQA g in {1, 2},
from an empty and from a carried state. Tolerances:
f32 2e-5 (absolute and relative: the same math, summed in another order,
and the Pallas kernel multiplies by 1/sqrt(D) where the plain version
divides by sqrt(D); measured ~2e-6). bf16: the normalized output acc / l
within 2**-8 (both sides round p to bf16 before p.v, but from f32 p values
a few f32 ulps apart, so a p can land one bf16 ulp (2**-8 relative) away;
the output is a convex mix of N(0, 1) values; measured < 1e-3); m and l
within 1e-5 relative (f32 scores of exact bf16 products).

The ring over a group of CPU copies is held to the JAX ``ring_attention``
on an 8-device virtual CPU mesh (tests/conftest.py), both of its bodies:
``impl="xla"`` (einsum) and ``impl="flash", interpret=True`` (the carry
kernel), f32 at 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.ops import attention as jattn
from tfservingcache_tpu.parallel.mesh import chip_groups as jchip_groups
from tfservingcache_tpu.parallel.mesh import make_mesh
from tfservingcache_tpu.parallel.ring_attention import ring_attention as jring
from tfservingcache_tpu_torch.ops import attention as tattn
from tfservingcache_tpu_torch.parallel import mesh as tmesh
from tfservingcache_tpu_torch.parallel import ring_attention as tring

B, KV_HEADS, SEQ, HEAD_DIM = 1, 2, 256, 64
RELS = (-256, -128, 0, 128, 256, -129, -127, 127, 129)


def _hop_inputs(group: int, carried: bool, seed: int):
    """q (B, H, S, D), k/v (B, Hkv, S, D) ~ N(0, 1); the carry empty
    (zeros, NEG_INF, zeros) or a carried state (acc ~ N(0, 1), m ~ N(0, 1),
    l in [0.5, 3])."""
    rng = np.random.default_rng(seed)
    h = KV_HEADS * group
    q = rng.standard_normal((B, h, SEQ, HEAD_DIM), dtype=np.float32)
    k = rng.standard_normal((B, KV_HEADS, SEQ, HEAD_DIM), dtype=np.float32)
    v = rng.standard_normal((B, KV_HEADS, SEQ, HEAD_DIM), dtype=np.float32)
    if carried:
        acc = rng.standard_normal((B, h, SEQ, HEAD_DIM), dtype=np.float32)
        m = rng.standard_normal((B, h, SEQ, 1), dtype=np.float32)
        l = rng.uniform(0.5, 3.0, (B, h, SEQ, 1)).astype(np.float32)
    else:
        acc = np.zeros((B, h, SEQ, HEAD_DIM), np.float32)
        m = np.full((B, h, SEQ, 1), tattn.NEG_INF, np.float32)
        l = np.zeros((B, h, SEQ, 1), np.float32)
    return q, k, v, acc, m, l


def _both_hops(dtype: str, group: int, causal: bool, rel: int, carried: bool, seed: int):
    q, k, v, acc, m, l = _hop_inputs(group, carried, seed)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.flash_attention_carry(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(acc),
        jnp.asarray(m), jnp.asarray(l), rel, causal=causal, interpret=True)
    got = tattn.flash_attention_carry_reference(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td), torch.from_numpy(v).to(td),
        torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(l), rel, causal)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


@pytest.mark.parametrize("carried", [False, True], ids=["empty", "carried"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("rel", RELS)
def test_carry_step_matches_pallas_carry_kernel_f32(rel, group, causal, carried):
    (acc, m, l), (jacc, jm, jl) = _both_hops("float32", group, causal, rel, carried, seed=rel + 300)
    assert acc.shape == jacc.shape and m.shape == l.shape == jm.shape
    for got, want in ((acc, jacc), (m, jm), (l, jl)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("carried", [False, True], ids=["empty", "carried"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("rel", RELS)
def test_carry_step_matches_pallas_carry_kernel_bf16(rel, group, causal, carried):
    (acc, m, l), (jacc, jm, jl) = _both_hops("bfloat16", group, causal, rel, carried, seed=rel + 600)
    np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l, jl, rtol=1e-5, atol=1e-6)
    seen = jl > 0  # an empty carry a hop shows nothing stays empty (l = 0)
    norm, jnorm = acc / np.maximum(l, 1e-30), jacc / np.maximum(jl, 1e-30)
    assert np.abs(norm - jnorm)[np.broadcast_to(seen, norm.shape)].max(initial=0.0) <= 2.0**-8
    np.testing.assert_array_equal(acc[~np.broadcast_to(seen, acc.shape)], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_hop_leaves_the_carry_bit_identical(dtype):
    """A future block (rel = Sq: every key after every query) is a strict
    no-op: the guards keep exp(NEG_INF - NEG_INF) out of an empty row too."""
    q, k, v, acc, m, l = _hop_inputs(2, True, seed=3)
    acc[:, :, :5], m[:, :, :5], l[:, :, :5] = 0.0, tattn.NEG_INF, 0.0  # some rows still empty
    td = getattr(torch, dtype)
    carry = [torch.from_numpy(x) for x in (acc, m, l)]
    got = tattn.flash_attention_carry_reference(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td), torch.from_numpy(v).to(td),
        *carry, SEQ, True)
    for g, want in zip(got, carry):
        assert torch.equal(g, want)


def test_carry_dispatch_on_cpu_runs_the_plain_version_and_never_the_kernel():
    q, k, v, acc, m, l = (torch.from_numpy(x) for x in _hop_inputs(1, True, seed=4))
    tattn.CARRY_LAUNCHES.reset()
    got = tattn.attention_carry(q.bfloat16(), k.bfloat16(), v.bfloat16(), acc, m, l, -64)
    want = tattn.flash_attention_carry_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                                 acc, m, l, -64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tattn.CARRY_LAUNCHES.value == 0
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_carry(q, k, v, acc, m, l, 0)
    assert tattn.CARRY_LAUNCHES.value == 0


RING_SHAPES = {"xla": (2, 2, 64, 16), "flash": (1, 2, 128, 64)}  # flash: S per shard


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_ring_matches_jax_ring_attention(impl, n_shards, causal):
    b, h, s, d = RING_SHAPES[impl]
    if impl == "flash":
        s *= n_shards  # the Pallas carry kernel needs 128 rows per shard
    rng = np.random.default_rng(n_shards)
    q, k, v = (rng.standard_normal((b, h, s, d), dtype=np.float32) for _ in range(3))
    mesh = make_mesh({"seq": n_shards})
    want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh, axis="seq",
                            causal=causal, impl=impl, interpret=impl == "flash"))
    got = tring.ring_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               ["cpu"] * n_shards, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ring_matches_attention_reference_bf16_gqa():
    """The ring takes grouped heads (the model's build does not) and bf16,
    out in q's dtype, within the plain attention's bf16 output rounding."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 4, 96, 64), dtype=np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((1, 2, 96, 64), dtype=np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((1, 2, 96, 64), dtype=np.float32)).bfloat16()
    got = tring.ring_attention(q, k, v, ["cpu"] * 4)
    want = tattn.attention_reference(q, k, v)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2.0**-5


def test_ring_rejects_indivisible_sequence():
    q = torch.zeros(1, 1, 60, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tring.ring_attention(q, q, q, ["cpu"] * 8)
    with pytest.raises(ValueError, match="at least one device"):
        tring.ring_attention(q, q, q, [])


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_hop_schedule_is_the_references(n_shards, monkeypatch):
    """P^2 hops, hop (step, i) on shard i with the block that started at
    src = (i - step) mod P and rel = (src - i) * S/P — the reference's
    ``_ring_shard_fn`` schedule (ring_attention.py:79-94)."""
    s_local = 8
    k = torch.arange(n_shards * s_local, dtype=torch.float32).reshape(1, 1, -1, 1).repeat(1, 1, 1, 4)
    calls = []
    real = tring.attention_carry

    def record(q, kb, vb, acc, m, l, rel, causal):
        src = int(kb[0, 0, 0, 0]) // s_local  # which block this is, by its first key
        calls.append((int(q[0, 0, 0, 0]) // s_local, src, rel))
        return real(q, kb, vb, acc, m, l, rel, causal)

    monkeypatch.setattr(tring, "attention_carry", record)
    tring.ring_attention(k.clone(), k, k.clone(), ["cpu"] * n_shards)
    want = [(i, (i - step) % n_shards, ((i - step) % n_shards - i) * s_local)
            for step in range(n_shards) for i in range(n_shards)]
    assert calls == want


def test_chip_groups_mirror_the_reference():
    devs = ["cpu"] * 8
    assert [len(g) for g in tmesh.chip_groups(devs, 4)] == [len(g) for g in
                                                             jchip_groups(list(range(8)), 4)]
    assert tmesh.group_mesh(devs, 4, 1) == (torch.device("cpu"),) * 4
    for size in (3, 0):
        with pytest.raises(ValueError) as want:
            jchip_groups(list(range(8)), size)
        with pytest.raises(ValueError) as got:
            tmesh.chip_groups(devs, size)
        assert str(got.value) == str(want.value)
