"""Attention ops: a hand-written CUDA flash-attention kernel + its plain
PyTorch version.

Counterpart of ``tfservingcache_tpu/ops/attention.py``. ``attention`` is the
dispatch the model calls: on a CUDA tensor that passes the reference's gate
it launches the kernel (``flash_attention``), otherwise it runs the plain
version (``attention_reference``). There is no fallback: a kernel that fails
to build or launch raises.

Layouts follow the reference: q ``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)``,
GQA with ``Hq % Hkv == 0``, out in q's dtype.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256
KERNEL_HEAD_DIMS = (64, 128, 192, 256)


class LaunchCounter:
    """Kernel launches since the last reset (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


# bumped once per launch of the flash kernel (chip_smoke.py reads it to show
# that the serving path went through the kernel)
FLASH_LAUNCHES = LaunchCounter()


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """(B, Hq, S, D) x (B, Hkv, S, D) attention, f32 softmax, out in q.dtype.

    Mirrors the reference ``attention_reference``: scores are bf16 products
    accumulated in f32 (computed here from f32 copies, which is exact for
    bf16 inputs), query heads grouped over their K/V head without repeating
    K/V, and p @ v kept in f32."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bkgqd,bkKd->bkgqK", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqK,bkKd->bkgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if not getattr(lib, "_tpusc_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tpusc_flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.tpusc_flash_attention_fwd.restype = i
        lib.tpusc_cuda_error_string.argtypes = [i]
        lib.tpusc_cuda_error_string.restype = ctypes.c_char_p
        lib._tpusc_bound = True
    return lib


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The CUDA kernel (``ops/csrc/flash_attention.cu``) on the current
    stream. Takes contiguous, 16-byte aligned bf16 CUDA tensors with
    head_dim in ``KERNEL_HEAD_DIMS`` and equal q/k/v lengths; raises on
    anything else, CPU tensors included."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, needs a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} must be a contiguous, 16-byte aligned 4-d tensor"
            )
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v must be on one device")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if d > MAX_HEAD_DIM or d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: batch*heads {b * hq} exceeds the grid's 65535")
    from tfservingcache_tpu_torch.ops import _build

    lib = _bind(_build.load("flash_attention"))
    out = torch.empty_like(q)
    if s == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.tpusc_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, d, int(causal), stream,
        )
    if rc != 0:
        msg = lib.tpusc_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (cuda error {rc})")
    FLASH_LAUNCHES.add()
    return out


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Dispatch with the reference's gate (attention.py:812-818): head_dim a
    multiple of 64, seq >= 128, self-attention lengths, GQA-divisible heads.
    Where the reference asks "is the backend a TPU", this asks "is the
    tensor on CUDA". A gated CUDA call runs the kernel and nothing else."""
    if (
        q.device.type == "cuda"
        and q.shape[-1] % 64 == 0
        and q.shape[2] >= 128
        and k.shape[2] == q.shape[2]
        and q.shape[1] % k.shape[1] == 0
    ):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    return attention_reference(q, k, v, causal=causal)
