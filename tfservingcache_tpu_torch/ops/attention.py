"""Attention ops: hand-written CUDA kernels + their plain PyTorch versions.

Counterpart of ``tfservingcache_tpu/ops/attention.py``:
  - ``attention`` is the dispatch the model calls for full-sequence
    attention: on a CUDA tensor it launches the flash kernel
    (``flash_attention``, bf16 or f32), on a CPU tensor it runs the plain
    version (``attention_reference``). Layouts: q ``(B, Hq, S, D)``,
    k/v ``(B, Hkv, S, D)``, GQA with ``Hq % Hkv == 0``, out in q's dtype.
  - ``paged_attention`` is the dispatch of the continuous engine's decode
    step: one query per lane over the paged KV arena. On a CUDA tensor it
    launches the paged decode kernel (``paged_decode_attention_kernel``,
    bf16 / f32 / int8 arenas); on a CPU tensor, or with ``kernel=False``, it
    runs the plain gather + einsum version (``paged_decode_attention``).
    q ``(S, Hq, 1, D)``, pages ``(n_pages, Hkv, page_tokens, D)``, tables
    ``(S, pages_per_slot)`` int32, pos ``(S,)`` int32 -> f32 ``(S, Hq, 1, D)``.
  - ``paged_attention_verify`` is the same with T query positions per lane
    (q ``(S, Hq, T, D)`` at ``pos .. pos + T - 1``, each with its own causal
    frontier): the verify pass of a speculative round and, at T = chunk,
    chunked prefill. It launches the paged verify kernel
    (``paged_verify_attention_kernel``) or runs ``paged_verify_attention``.
    The decode and verify kernels are one CUDA body behind two kernel names
    (``ops/csrc/paged_attention.cu``); the decode kernel is its T = 1 case.
  - ``attention_carry`` is one hop of ring attention
    (``parallel/ring_attention.py``): local q ``(B, H, Sq, D)`` against one
    K/V block ``(B, Hkv, Sk, D)`` with the online-softmax state ``acc``
    ``(B, H, Sq, D)`` / ``m``, ``l`` ``(B, H, Sq, 1)`` carried in f32 and
    returned unnormalized. On a CUDA tensor it launches the carry kernel
    (``flash_attention_carry``: bf16 on the flash kernel's TMA + wgmma
    design, f32 SIMT, in ``ops/csrc/flash_attention.cu``, updating the
    carry in place); on a CPU tensor it runs
    ``flash_attention_carry_reference``.
There is no fallback: on a CUDA tensor a kernel that does not take the
arguments, fails to build or fails to launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256
KERNEL_HEAD_DIMS = (32, 64, 128, 192, 256)


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


# bumped once per launch of each kernel (chip_smoke.py reads them to show
# that the serving paths went through the kernels)
FLASH_LAUNCHES = LaunchCounter()
PAGED_LAUNCHES = LaunchCounter()
VERIFY_LAUNCHES = LaunchCounter()
CARRY_LAUNCHES = LaunchCounter()


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


def _load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` with every entry point's C signature set
    (ctypes would otherwise pass pointers as 32-bit ints)."""
    from tfservingcache_tpu_torch.ops import _build

    lib = _build.load(name)
    if not getattr(lib, "_tpusc_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "flash_attention":
            lib.tpusc_flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            lib.tpusc_flash_attention_fwd.restype = i
            lib.tpusc_flash_attention_fwd_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            lib.tpusc_flash_attention_fwd_f32.restype = i
            lib.tpusc_flash_attention_carry.argtypes = [
                p, p, p, p, p, p, i, i, i, i, i, i, i, i, p,
            ]
            lib.tpusc_flash_attention_carry.restype = i
        else:
            lib.tpusc_paged_attention.argtypes = [
                p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, p,
            ]
            lib.tpusc_paged_attention.restype = i
            lib.tpusc_paged_tiling.argtypes = [i, i, ctypes.POINTER(i)]
            lib.tpusc_paged_tiling.restype = i
        lib.tpusc_cuda_error_string.argtypes = [i]
        lib.tpusc_cuda_error_string.restype = ctypes.c_char_p
        lib._tpusc_bound = True
    return lib


def _check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tpusc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cuda error {rc})")


_FLASH_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The CUDA kernel (``ops/csrc/flash_attention.cu``) on the current
    stream. Takes contiguous, 16-byte aligned CUDA tensors of one dtype,
    bf16 or f32, with head_dim in ``KERNEL_HEAD_DIMS`` and equal q/k/v
    lengths; raises on anything else, CPU tensors included. The output has
    the inputs' dtype (f32 in, f32 scores, f32 p, f32 out; bf16 in, f32
    scores, p rounded to bf16 before p.v, bf16 out — the reference's
    rounding points for each dtype)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, needs a CUDA tensor")
        if t.dtype not in _FLASH_DTYPES:
            raise ValueError(
                f"flash_attention: {name} is {t.dtype}, the kernel takes bfloat16 or float32"
            )
        if t.dtype != q.dtype:
            raise ValueError("flash_attention: q, k and v must have one dtype")
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
    lib = _load("flash_attention")
    out = torch.empty_like(q)
    if s == 0:
        return out
    fwd = (lib.tpusc_flash_attention_fwd if q.dtype == torch.bfloat16
           else lib.tpusc_flash_attention_fwd_f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, d, int(causal), stream,
        )
    _check_launch(lib, rc, "flash_attention")
    FLASH_LAUNCHES.add()
    return out


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Dispatch. Where the reference asks "is the backend a TPU" and then
    gates on the shape (attention.py:812-818), this asks "is the tensor on
    CUDA" and leaves the shape to the kernel: a CUDA call runs the flash
    kernel at any sequence length, and one it does not take (head_dim
    outside ``KERNEL_HEAD_DIMS``, unequal q/k lengths, heads that do not
    group) raises rather than run the plain version on the card. A CPU call
    runs ``attention_reference``."""
    if q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    return attention_reference(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# Ring-attention carry step (context parallelism)
# ---------------------------------------------------------------------------

def flash_attention_carry_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    acc: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    rel: int,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring hop, the plain version of the carry kernel: operation for
    operation the reference's ``_block_attend`` (parallel/ring_attention.py
    :30-56) with the carry kernel's two guards (attention.py:361-365), p = 0
    where a score is masked and alpha = exp(min(m_prev - m_new, 0)), so a
    row that sees no key of the hop keeps its state. Scores are f32 products
    of the input dtype (computed from f32 copies, which is exact for bf16)
    divided by sqrt(D); with ``causal`` local row iq sees local key ik when
    iq - ik >= rel (rel = k_off - q_off in global positions); p is cast to
    v's dtype before p.v, which sums in f32. Query head h reads K/V head
    h // (H / Hkv). q ``(B, H, Sq, D)``, k/v ``(B, Hkv, Sk, D)``, acc
    ``(B, H, Sq, D)`` f32, m/l ``(B, H, Sq, 1)`` f32 -> the new (acc, m, l),
    unnormalized; the inputs are not written."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    g = h // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bkgqd,bkKd->bkgqK", qg, k.float()) / math.sqrt(d)
    if causal:
        iq = torch.arange(sq, device=q.device)[:, None]
        ik = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(iq - ik < rel, NEG_INF)
    m_prev = m.reshape(b, hkv, g, sq, 1)
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new), torch.zeros_like(s))
    alpha = torch.exp(torch.clamp(m_prev - m_new, max=0.0))
    l_new = alpha * l.reshape(b, hkv, g, sq, 1) + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqK,bkKd->bkgqd", p.to(v.dtype).float(), v.float())
    acc_new = acc.reshape(b, hkv, g, sq, d) * alpha + pv
    return (acc_new.reshape(b, h, sq, d), m_new.reshape(b, h, sq, 1),
            l_new.reshape(b, h, sq, 1))


_CARRY_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def flash_attention_carry(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    acc: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    rel: int,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA carry kernel (B4, ``ops/csrc/flash_attention.cu``) on the
    current stream: the contract of ``flash_attention_carry_reference`` at
    any Sq, Sk >= 1, with the carry UPDATED IN PLACE (the ring owns it) and
    returned. A row that sees no key of the hop is neither read nor written,
    so its carry stays bit-identical; the bf16 kernel deals only the query
    tiles some row of which sees a key (a hop none sees launches one block
    that returns at once), the f32 kernel's blocks of blind rows return at
    once. q/k/v are contiguous, 16-byte aligned CUDA tensors of one
    dtype, bf16 or f32, with head_dim in ``KERNEL_HEAD_DIMS``; acc/m/l are
    contiguous, aligned f32 tensors on the same device. Raises on anything
    else, CPU tensors included."""
    for name, t in (("q", q), ("k", k), ("v", v), ("acc", acc), ("m", m), ("l", l)):
        if t.device.type != "cuda":
            raise ValueError(
                f"flash_attention_carry: {name} is on {t.device}, needs a CUDA tensor"
            )
        if t.device != q.device:
            raise ValueError("flash_attention_carry: all tensors must be on one device")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention_carry: {name} must be a contiguous, 16-byte aligned 4-d tensor"
            )
    if q.dtype not in _CARRY_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_carry: q/k/v are {q.dtype}/{k.dtype}/{v.dtype}, the kernel "
            "takes one dtype, bfloat16 or float32"
        )
    if any(t.dtype != torch.float32 for t in (acc, m, l)):
        raise ValueError("flash_attention_carry: the carry acc/m/l must be float32")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_carry: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention_carry: k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not "
            f"match q {tuple(q.shape)}"
        )
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if acc.shape != q.shape or m.shape != (b, hq, sq, 1) or l.shape != m.shape:
        raise ValueError(
            f"flash_attention_carry: carry acc {tuple(acc.shape)} / m {tuple(m.shape)} / "
            f"l {tuple(l.shape)} does not match q {tuple(q.shape)}"
        )
    # rel <= -Sk shows every key to every row (no causal mask); rel >= Sq
    # shows none: clamping keeps the kernel's int in range
    rel = max(-sk, min(int(rel), sq)) if causal else -sk
    lib = _load("flash_attention")
    if sq == 0 or sk == 0:
        return acc, m, l
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.tpusc_flash_attention_carry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), b, hq, hkv, sq, sk, d, rel, _CARRY_DTYPES[q.dtype], stream,
        )
    _check_launch(lib, rc, "flash_attention_carry")
    CARRY_LAUNCHES.add()
    return acc, m, l


def attention_carry(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    acc: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    rel: int,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Carry-step dispatch. It replaces the reference's ``_pick_impl`` gate
    (ring_attention.py:101-114), which runs the einsum body off the TPU and
    whenever the local sequence is no multiple of 128: a CUDA call runs the
    carry kernel at any Sq, Sk >= 1 and raises on what it does not take
    (head_dim outside ``KERNEL_HEAD_DIMS``, heads that do not group); a CPU
    call runs ``flash_attention_carry_reference``. The kernel updates the
    carry in place and the plain version returns new tensors: callers use
    the returned triple."""
    if q.device.type == "cuda":
        return flash_attention_carry(q.contiguous(), k.contiguous(), v.contiguous(),
                                     acc, m, l, rel, causal)
    return flash_attention_carry_reference(q, k, v, acc, m, l, rel, causal)


# ---------------------------------------------------------------------------
# Paged-KV attention (continuous decode engine)
# ---------------------------------------------------------------------------

def paged_gather_kv(
    pages: torch.Tensor, tables: torch.Tensor, page_tokens: int
) -> torch.Tensor:
    """Each lane's logical K or V row out of the shared arena (reference
    attention.py:488): ``pages (n_pages, Hkv, pt, D)`` gathered through
    ``tables (S, pps)`` and laid out in block-table order, so the result
    ``(S, Hkv, pps * pt, D)`` is positionally a dense per-lane cache row.
    A table entry of 0 is the trash page: harmless only while it sits above
    ``pos`` (``TPUSC_PAGECHECK=1`` asserts that before every chunk)."""
    s_lanes, pps = tables.shape
    _, hkv, pt, d = pages.shape
    gathered = pages[tables.long()]                      # (S, PPS, Hkv, pt, D)
    return gathered.transpose(1, 2).reshape(s_lanes, hkv, pps * pt, d)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    page_tokens: int,
) -> torch.Tensor:
    """Single-position attention over a paged KV arena — the plain version
    of the paged decode kernel, the reference's ``paged_decode_attention``
    (attention.py:520). q ``(S, Hq, 1, D)`` -> f32 ``(S, Hq, 1, D)``. It is
    ``paged_verify_attention`` at T = 1, whose operations are the
    reference decode version's one for one."""
    return paged_verify_attention(q, k_pages, v_pages, tables, pos, page_tokens)


def paged_verify_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    page_tokens: int,
) -> torch.Tensor:
    """T query positions per lane over a paged KV arena — the plain version
    of the paged verify kernel, operation for operation the reference's
    ``paged_verify_attention`` (attention.py:567): query ``t`` of lane ``s``
    sits at ``pos[s] + t`` and sees keys ``k_pos <= pos[s] + t`` (NEG_INF
    elsewhere); GQA folds as ``(S, Hkv, g, T, D)`` (query head ``kv*g + j``
    reads KV head ``kv``); scores are products of the stored values summed
    in f32 (computed from f32 copies, which is exact for bf16); the softmax
    is f32; p is cast to the cache dtype before the value product.
    q ``(S, Hq, T, D)`` -> f32 ``(S, Hq, T, D)``."""
    s_lanes, hq, t, d = q.shape
    hkv = k_pages.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    kc = paged_gather_kv(k_pages, tables, page_tokens)   # (S, Hkv, L, D)
    vc = paged_gather_kv(v_pages, tables, page_tokens)
    qg = q.reshape(s_lanes, hkv, g, t, d).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, kc.float()) / math.sqrt(d)
    k_pos = torch.arange(kc.shape[2], device=q.device)
    q_pos = pos.long()[:, None] + torch.arange(t, device=q.device)[None, :]  # (S, T)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]                        # (S, T, L)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", p.to(vc.dtype).float(), vc.float())
    return out.reshape(s_lanes, hq, t, d)


def dequantize_pages(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """An int8 arena ``(n_pages, Hkv, pt, D)`` against its per-(page, head,
    token) f32 scales ``(n_pages, Hkv, pt)`` back to f32 rows (reference
    attention.py:615) — the kernel does the same multiply in registers."""
    return pages.float() * scales[..., None]


# The paged kernels' page-axis split (ops/csrc/paged_attention.cu): a grid
# of lanes x KV heads x row tiles under SPLIT_BLOCKS_PER_SM[path] blocks an
# SM is split into as many runs of pages as keep it at or under that many
# blocks, and no split gets fewer keys than SPLIT_MIN_KEYS (a split pays a
# pipeline prologue and a combine row). An mma.sync block (bf16 q over bf16
# pages) holds ~100 KiB of staged K/V, so two fit an SM: a grid past one
# such wave runs a ragged second one. The SIMT path's blocks are bound by
# their own math over ragged lanes, so finer splits pay up to eight an SM
# (tools/paged_split_sweep.py and tools/paged_kernel_ab.py on an H100;
# PERF.md section 6). The row tile and the path are the kernel library's
# (tpusc_paged_tiling), read by paged_launch_plan.
SPLIT_BLOCKS_PER_SM = {"mma": 2, "simt": 8}
SPLIT_MIN_KEYS = 128


def paged_split_plan(
    lanes: int, hkv: int, rows: int, pps: int, page_tokens: int, sm_count: int,
    row_tile: int, blocks_per_sm: int,
) -> tuple[int, int]:
    """How the paged kernels split the page axis: -> (n_splits,
    pages_per_split), with ``1 <= n_splits <= pps`` and ``(n_splits - 1) *
    pages_per_split < pps <= n_splits * pages_per_split``. From shapes
    alone (``rows`` = T * g folded query rows, ``row_tile`` the rows a
    block holds), never from ``pos``: the plan needs no device read, so a
    paged call adds no host sync. The most splits that keep the grid at or
    under ``blocks_per_sm`` blocks an SM, each of at least
    ``SPLIT_MIN_KEYS`` keys; one when the unsplit grid is already there."""
    args = (lanes, hkv, rows, pps, page_tokens, sm_count, row_tile, blocks_per_sm)
    if not all(type(a) is int for a in args):
        raise TypeError("paged_split_plan takes ints (shapes), got "
                        f"{[type(a).__name__ for a in args]}")
    if min(args) < 1:
        raise ValueError(f"paged_split_plan: every size must be >= 1, got {args}")
    blocks = lanes * hkv * -(-rows // row_tile)
    target = blocks_per_sm * sm_count
    if blocks >= target:
        return 1, pps
    most = max(1, min(pps, pps * page_tokens // SPLIT_MIN_KEYS))
    return _even_split(pps, min(target // blocks, most))


def _even_split(pps: int, n_splits: int) -> tuple[int, int]:
    per = -(-pps // n_splits)
    return -(-pps // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _paged_tiling(q_type: int, kv_type: int) -> tuple[bool, int, int]:
    """(mma path, row tile, rows a warp owns) of a (q, page) type pair, as
    the kernel library states them."""
    lib = _load("paged_attention")
    tiling = (ctypes.c_int * 3)()
    _check_launch(lib, lib.tpusc_paged_tiling(q_type, kv_type, tiling), "paged_attention tiling")
    return bool(tiling[0]), tiling[1], tiling[2]


def paged_launch_plan(
    q: torch.Tensor, k_pages: torch.Tensor, tables: torch.Tensor, splits: int | None = None,
) -> dict:
    """The launch the paged wrappers make for these arguments (q ``(S, Hq,
    T, D)`` and pages on one CUDA device): ``{"mma", "row_tile", "unit",
    "n_splits", "pages_per_split"}``, the tiling from the kernel library and
    the split from ``paged_split_plan`` (``splits`` forces the number of
    splits, for tests). Reads shapes and dtypes only."""
    s_lanes, hq, t_q, _ = q.shape
    hkv, pt = k_pages.shape[1], k_pages.shape[2]
    pps = tables.shape[1]
    mma, row_tile, unit = _paged_tiling(_PAGED_Q_TYPES[q.dtype], _PAGED_KV_TYPES[k_pages.dtype])
    if splits is None:
        n_splits, per = paged_split_plan(
            s_lanes, hkv, t_q * (hq // hkv), pps, pt, _sm_count(q.device.index or 0),
            row_tile, SPLIT_BLOCKS_PER_SM["mma" if mma else "simt"])
    else:
        n_splits, per = _even_split(pps, max(1, min(int(splits), pps)))
    return {"mma": mma, "row_tile": row_tile, "unit": unit, "n_splits": n_splits,
            "pages_per_split": per}


_PAGED_Q_TYPES = {torch.bfloat16: 0, torch.float32: 1}
_PAGED_KV_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _paged_kernel(
    verify: bool,
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    k_scale: torch.Tensor | None,
    v_scale: torch.Tensor | None,
    page_tokens: int,
    splits: int | None = None,
) -> torch.Tensor:
    """Check the arguments of the paged verify kernel (``verify``) or the
    paged decode kernel (one body, ``ops/csrc/paged_attention.cu``) and
    launch it on the current stream, with the page axis split as
    ``paged_launch_plan`` says (``splits`` forces the number of splits, for
    tests). Reads nothing back from the device. -> f32 ``(S, Hq, T, D)``."""
    what = "paged_verify_attention" if verify else "paged_decode_attention"
    fn = f"{what}_kernel"
    quantized = k_scale is not None
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("tables", tables), ("pos", pos)]
    if quantized:
        if v_scale is None:
            raise ValueError(f"{fn}: k_scale given without v_scale")
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, needs a CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"{fn}: all tensors must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    if q.dtype not in _PAGED_Q_TYPES:
        raise ValueError(f"{fn}: q is {q.dtype}, takes bf16 or f32")
    if k_pages.dtype not in _PAGED_KV_TYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(
            f"{fn}: pages are {k_pages.dtype}/{v_pages.dtype}, "
            "the kernel takes one of bf16, f32, int8"
        )
    if (k_pages.dtype == torch.int8) != quantized:
        raise ValueError(f"{fn}: int8 pages need k_scale/v_scale and only int8 pages take them")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{fn}: tables and pos must be int32")
    if q.dim() != 4:
        raise ValueError(f"{fn}: q must be (S, Hq, T, D), got {tuple(q.shape)}")
    s_lanes, hq, t_q, d = q.shape
    n_pages, hkv, pt, dk = k_pages.shape
    if t_q < 1 or (not verify and t_q != 1) or dk != d or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"{fn}: q {tuple(q.shape)} / pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)} do not match"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if pt != page_tokens:
        raise ValueError(f"arena page_tokens {pt} != {page_tokens}")
    if tables.dim() != 2 or tables.shape[0] != s_lanes or tuple(pos.shape) != (s_lanes,):
        raise ValueError(
            f"{fn}: tables {tuple(tables.shape)} / pos {tuple(pos.shape)} do not match "
            f"{s_lanes} lanes"
        )
    if quantized and (k_scale.shape != k_pages.shape[:3] or v_scale.shape != k_scale.shape
                      or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError(f"{fn}: scales must be f32 (n_pages, Hkv, pt)")
    lib = _load("paged_attention")
    out = torch.empty((s_lanes, hq, t_q, d), dtype=torch.float32, device=q.device)
    if s_lanes == 0:
        return out
    pps = tables.shape[1]
    plan = paged_launch_plan(q, k_pages, tables, splits)
    n_splits, per = plan["n_splits"], plan["pages_per_split"]
    part_ml = part_acc = None
    if n_splits > 1:  # scratch for the combine kernel: (rows, splits, 2) and (rows, splits, D)
        part_ml = torch.empty((s_lanes * hq * t_q, n_splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((s_lanes * hq * t_q, n_splits, d), dtype=torch.float32,
                               device=q.device)
    args = [
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part_ml.data_ptr() if part_ml is not None else None,
        part_acc.data_ptr() if part_acc is not None else None,
        s_lanes, hq, hkv, d, pt, pps, n_pages,
        _PAGED_Q_TYPES[q.dtype], _PAGED_KV_TYPES[k_pages.dtype], t_q, int(verify),
        n_splits, per,
    ]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.tpusc_paged_attention(*args, stream)
    _check_launch(lib, rc, what)
    return out


def paged_decode_attention_kernel(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    page_tokens: int,
) -> torch.Tensor:
    """The CUDA paged decode kernel (``ops/csrc/paged_attention.cu``) on the
    current stream: the contract of ``paged_decode_attention``, in
    one pass over the live K/V rows of each lane (split along the page axis
    as ``paged_launch_plan`` says, the splits merged by a second kernel). q ``(S, Hq, 1, D)`` is
    bf16 or f32; pages are bf16, f32 or int8 (int8 with
    ``k_scale``/``v_scale`` ``(n_pages, Hkv, pt)`` f32); tables ``(S, pps)``
    and pos ``(S,)`` are int32 device tensors the kernel reads itself.
    Raises on a CPU tensor or anything else the kernel does not take."""
    out = _paged_kernel(False, q, k_pages, v_pages, tables, pos,
                        k_scale, v_scale, page_tokens)
    PAGED_LAUNCHES.add()
    return out


def paged_verify_attention_kernel(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    page_tokens: int,
) -> torch.Tensor:
    """The CUDA paged verify kernel (``ops/csrc/paged_attention.cu``) on the
    current stream: the contract of ``paged_verify_attention`` for any
    T >= 1 query positions per lane, q ``(S, Hq, T, D)`` -> f32
    ``(S, Hq, T, D)``, each lane's live K/V rows read once per tile of
    folded query rows (64 on the mma.sync path, 16 on the SIMT path: once
    for a spec round). The arguments are those of
    ``paged_decode_attention_kernel``, with the same checks; it runs the
    decode kernel's body, so the two agree bit for bit at T = 1. Raises on a
    CPU tensor."""
    out = _paged_kernel(True, q, k_pages, v_pages, tables, pos,
                        k_scale, v_scale, page_tokens)
    VERIFY_LAUNCHES.add()
    return out


def _paged_dispatch(
    kernel_fn, plain_fn, q, k_pages, v_pages, tables, pos, page_tokens, k_scale, v_scale, kernel
) -> torch.Tensor:
    if kernel and (q.device.type == "cuda" or k_pages.device.type == "cuda"):
        return kernel_fn(q.contiguous(), k_pages, v_pages, tables, pos, k_scale, v_scale,
                         page_tokens=page_tokens)
    if k_scale is not None:
        k_pages = dequantize_pages(k_pages, k_scale)
        v_pages = dequantize_pages(v_pages, v_scale)
    return plain_fn(q, k_pages, v_pages, tables, pos, page_tokens)


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    page_tokens: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    kernel: bool = True,
) -> torch.Tensor:
    """Paged decode dispatch. Where the reference asks "is the backend a
    TPU" and then gates on the shape (attention.py:848-855), this asks "is
    the tensor on CUDA" and leaves the shape to the kernel: a CUDA call runs
    the decode kernel, and one it does not take (head_dim outside
    ``KERNEL_HEAD_DIMS``, heads that do not group) raises rather than run
    the plain version on the card. A CPU call, or ``kernel=False``
    (serving.kv_paged_kernel), runs the plain version; an int8 arena there
    is dequantized first (:860-864)."""
    return _paged_dispatch(paged_decode_attention_kernel, paged_decode_attention, q, k_pages,
                           v_pages, tables, pos, page_tokens, k_scale, v_scale, kernel)


def paged_attention_verify(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    page_tokens: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    kernel: bool = True,
) -> torch.Tensor:
    """Multi-position (verify) dispatch, ``paged_attention``'s rules with
    the verify kernel and ``paged_verify_attention`` (reference
    attention.py:1049-1081)."""
    return _paged_dispatch(paged_verify_attention_kernel, paged_verify_attention, q, k_pages,
                           v_pages, tables, pos, page_tokens, k_scale, v_scale, kernel)
