#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``tfservingcache_tpu_torch``).

Drives the port's main path on one NVIDIA GPU and checks every kernel on it:

  1. environment — torch/CUDA versions, the card (nvidia-smi), which optional
     packages exist (information only); exits non-zero without a CUDA device
     or outside a checkout of the repo;
  2. build — compiles every kernel in ``tfservingcache_tpu_torch/ops/csrc``
     with nvcc, one process per source, all started together; prints ptxas's
     registers, spills and warnings, and checks that the bf16 flash and
     carry kernels' SASS holds wgmma (HGMMA) and TMA loads (UTMALDG), that
     the paged kernels' SASS holds cp.async (LDGSTS) and mma.sync (HMMA),
     and that the built paged and carry kernels use no local memory (no
     spills: ``cuobjdump -res-usage``);
  3. kernels — each kernel against its plain PyTorch version on the card at
     the main paths' shapes and a few edge shapes, with the stated
     tolerance; CUDA-event times (warm, median), the least time the card
     could take (bound), and one PyTorch library call's time as a yardstick:
     flash attention in bf16 and f32, paged decode attention over bf16,
     int8 and f32 arenas, paged verify attention at T in {1, 5, 9, 256}
     (with its T = 1 gap to the decode kernel), each paged row with the
     page-axis split the wrappers chose, and the ring-attention carry
     step from a carried state at the ring phase's hop (a past block, the
     diagonal, a future block that must leave the carry bit-identical), GQA,
     ragged lengths down to 1 and f32; then the 4-shard ring on one card
     against the plain attention, timed beside the flash kernel and SDPA,
     and the carry kernel's gap to the flash kernel (two kernels of one
     design: within ATTN_TOL);
  4. artifact — writes a random-weight transformer_lm artifact at the full
     llama-7b width (depth cut, see --layers) into a temporary store, two
     drafts (an exact copy under another name, and a 1-layer model from the
     target's embed, layer 0 and ln_f), and the same weights under
     ``"attention": "ring"``;
  5. serve — builds a cache node on ``cuda`` through ``server.build_node``
     (what ``cli serve`` calls) and sends REST ``:predict`` requests over
     localhost: cold, then warm. Every response is checked (HTTP 200, shape,
     finite, agreement with the plain path on the card), and the flash
     kernel's launch counter must show the path went through it (every
     request's forward and the load's warm-up forward);
  6. generate — REST ``:generate`` on the same artifact in seven arms: (a)
     the continuous paged engine over a bf16 arena, 16 concurrent greedy
     requests plus a top_k=1 sampled one; (b) the solo path, two seeded
     sampled requests; (c) the continuous engine over an int8 arena; (d)
     (a) with speculative rounds drafted by the exact copy (>= 0.8 x
     (spec + 1) tokens per lane-round, tokens as (a)'s up to near-ties);
     (e) (c) with rounds drafted by the 1-layer draft; (f) two solo
     ``"draft_model"`` requests; (g) (d) over an int8 arena, on 8 of the
     prompts, so that accepted int8 verify rows decide served tokens (the
     1-layer draft of (e) has every proposal rejected, which leaves only
     position 0 of each verify pass served). Every response is checked against the
     plain path on the card (teacher-forced logits), the page census must
     be green after each arm (both arenas with a draft), and the kernels'
     launch counters must equal what the engine ran in each continuous arm
     (paged = n_layers x plain decode steps + draft layers x (spec + 1) x
     spec rounds, verify = n_layers x spec rounds) and stay 0 on the solo
     paths;
  7. ring — REST ``:predict`` of the ring artifact on a ``CacheNode``
     around ``TorchModelRuntime(devices=[cuda:0] * 4)`` (one card runs the
     group's four shards one after another): cold, then warm, at (1, 4096)
     (1024 rows a shard), (2, 1024), (1, 300) (pads to 512) and (1, 2)
     (bucket 2: no ring divides it, so the flash kernel runs). Every answer
     is checked against the plain single-device path; the carry kernel's
     launches must be n_layers x 16 a ring request and the flash kernel's
     n_layers a fall-through request (+ the load's warm-up forward). One
     warm (1, 4096) forward is profiled beside the one-card "auto" model's.

The last three lines of standard output are the card's name and power limit
(nvidia-smi), a JSON object with one entry per kernel, and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
them.

Run from the root of a checkout:  python3 chip_smoke.py [--layers N | --full-depth]
(``TPUSC_PAGECHECK=1`` is set for the run: every paged decode chunk and
speculative round first asserts that no live lane maps the trash page.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# |kernel - plain| bound for attention on N(0, 1) inputs: bf16 output
# values reach |x| ~ 4-8, where one bf16 ulp is 1/32; the kernel also
# rounds p to bf16 before p.v where the plain version keeps f32.
ATTN_TOL = 1.0 / 32
# f32 flash kernel vs the plain version: the same f32 math in another
# summation order (TF32 is off for the plain version, see the environment
# phase)
ATTN_TOL_F32 = 1e-4
# |REST logits - plain-path logits| bound at llama-7b width: logits are
# ~N(0, 1); both paths run bf16 matmuls and differ in attention rounding
# (above) through every layer, 32 bf16 ulps at |x| ~ 1.
LOGITS_TOL = 0.125
# the same bound for tokens decoded over an int8 KV arena: an int8 row
# carries a rounding error of up to absmax/254 per element (absmax ~ 3
# sigma for N(0, sigma) rows: ~0.7% rms of the row's scale), about 3.5x the
# relative error of a bf16 row (2**-9 ~ 0.2%); the bound is 4x the bf16 one
LOGITS_TOL_INT8 = 0.5
# paged decode kernel vs its plain version (f32 out): int8 and f32 arenas
# dequantize to the same f32 values on both sides (other summation order);
# a bf16 arena rounds p to bf16 on both sides but at other points of the
# online softmax, a bf16 ulp of p on a convex mix of N(0, 1) rows
PAGED_TOL = {"bfloat16": 2.0**-8, "int8": 1e-4, "float32": 1e-4}

# (B, Hq, Hkv, S, D): the serving path's attention at llama-7b width for the
# request shapes below (seq buckets 128, 1024, 512), a long sequence, the
# default preset's GQA width, and a length that is no multiple of a tile
KERNEL_SHAPES = [
    (1, 32, 32, 128, 128),
    (2, 32, 32, 1024, 128),
    (1, 32, 32, 4096, 128),
    (4, 8, 4, 1024, 64),
    (1, 32, 32, 200, 128),
]
MAIN_SHAPE = (2, 32, 32, 1024, 128)  # the largest attention call of the served requests
# f32 inputs take the kernel's f32 instantiation (an f32 artifact's :predict)
KERNEL_SHAPES_F32 = [(1, 8, 8, 256, 128)]
# paged decode (S lanes, Hq, Hkv, D, page_tokens, max pos): the generate
# phase's occupancy at llama-7b width (8 lanes, prompts up to 1024 + 64 new
# tokens), full max_seq, GQA g = 4, a small page, head_dim 64
PAGED_SHAPES = [
    (8, 32, 32, 128, 16, 1088),
    (32, 32, 32, 128, 16, 4095),
    (16, 32, 8, 128, 16, 2047),
    (4, 32, 32, 128, 8, 300),
    (8, 16, 16, 64, 16, 500),
]
PAGED_MAIN = PAGED_SHAPES[0]
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores (the paged kernel's FMAs)
# paged verify (S lanes, Hq, Hkv, D, page_tokens, max pos, T, arenas, lane 0
# past its table): the spec rounds of the generate phase (T = spec + 1 = 5)
# and T = 1 / 9 at its occupancy, GQA g = 4, a lane whose pos + T runs past
# its table, and the chunked-prefill shape (T = 256)
_ALL_ARENAS = ("bfloat16", "int8", "float32")
VERIFY_SHAPES = [
    (8, 32, 32, 128, 16, 1088, 1, _ALL_ARENAS, False),
    (8, 32, 32, 128, 16, 1088, 5, _ALL_ARENAS, False),
    (8, 32, 32, 128, 16, 1088, 9, _ALL_ARENAS, False),
    (16, 32, 8, 128, 16, 2047, 5, ("bfloat16", "int8"), False),
    (4, 32, 32, 128, 8, 300, 5, ("bfloat16", "int8"), True),
    (8, 32, 32, 128, 16, 1088, 256, ("bfloat16", "int8"), False),
]
VERIFY_MAIN = (8, 32, 32, 128, 16, 1088, 5)
# :generate phase: 16 single-row greedy requests from 8 client threads,
# prompt lengths seeded-random in [64, 1024], 64 new tokens each
GEN_REQUESTS = 16
GEN_CLIENTS = 8
GEN_PROMPT_RANGE = (64, 1024)
GEN_NEW_TOKENS = 64
# draft tokens per speculative round in arms (d)-(g)
SPEC_TOKENS = 4
# arm (g), the exact-copy draft over an int8 arena, runs the first 8 prompts
SPEC_INT8_REQUESTS = 8
# :predict request shapes; (1, 300) pads to the 512 bucket
REQUEST_SHAPES = [(1, 128), (2, 1024), (1, 300)]
# B4 ring hops (B, Hq, Hkv, Sq, Sk, D, dtype, rel), each from a carried
# state: the ring phase's hop at llama-7b width (a (1, 4096) request over 4
# shards: 1024 rows a shard) as a past block, the diagonal and a future
# block; GQA (which the kernel takes though the ring's build does not);
# ragged lengths down to 1; f32
CARRY_MAIN = (1, 32, 32, 1024, 1024, 128)
CARRY_HOPS = [
    (*CARRY_MAIN, "bfloat16", -1024),
    (*CARRY_MAIN, "bfloat16", 0),
    (*CARRY_MAIN, "bfloat16", 1024),
    (1, 32, 8, 1024, 1024, 128, "bfloat16", 0),
    (1, 32, 32, 64, 64, 128, "bfloat16", 0),
    (1, 32, 32, 64, 64, 128, "bfloat16", -64),
    (1, 32, 32, 1, 1, 128, "bfloat16", 0),
    (1, 32, 32, 1, 1, 128, "bfloat16", -1),
    (1, 8, 8, 256, 256, 128, "float32", 0),
    (1, 8, 8, 256, 256, 128, "float32", -256),
]
# |kernel - plain| of the normalized hop output acc / l: bf16 as the paged
# kernels' (both round p to bf16, from f32 p values a few ulps apart and at
# other points of the online softmax); f32: the same f32 math in another
# summation order
CARRY_TOL = {"bfloat16": 2.0**-8, "float32": 1e-4}
# |kernel m - plain m|: f32 scores (~N(0, 1) here) summed in another order,
# and the bf16 body's log2 units converted at both ends: a few dozen f32
# ulps at most
CARRY_M_TOL = 1e-4
# the ring phase: a group of RING_SHARDS copies of the card (one card runs
# the shards one after another), and the request shapes: (1, 4096) is 1024
# rows a shard, (1, 300) pads to 512, and (1, 2)'s bucket of 2 does not
# divide by 4, so it falls through to the flash kernel
RING_SHARDS = 4
RING_DEVICE = "cuda:0"
RING_REQUEST_SHAPES = [(1, 4096), (2, 1024), (1, 300), (1, 2)]
RING_CHAIN = (1, 32, 32, 4096, 128)  # (B, H, Hkv, S, D) of the chained ring on one card
# every phase runs on device 0: the last line's device count
CARDS_USED = 1


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "Phase":
        self.t0 = time.monotonic()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"== phase {self.name}: {status} in {time.monotonic() - self.t0:.2f}s")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` calls, each between
    its own pair of CUDA events, after ``warmup`` untimed calls. A spin
    kernel queued first keeps the device busy while the host enqueues every
    timed call, so host launch overhead does not enter the device times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # ~0.1 s of device time at H100 clocks
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn()`` in ms (``fn`` ends in a device
    sync), after one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        fn()
        times.append((time.monotonic() - t0) * 1e3)
    return statistics.median(times)


def device_kernels(fn) -> dict[str, float]:
    """{kernel name: device ms} of one warm ``fn()`` under ``torch.profiler``
    (empty when the profiler records no device time on this machine)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    # kernel rows only: CPU ops would double-count
    return {row.key: row.self_device_time_total / 1e3 for row in prof.key_averages()
            if row.device_type == torch.autograd.DeviceType.CUDA and row.self_device_time_total > 0}


def device_kernel_ms(fn, matches: tuple[str, ...] = (),
                     kernels: dict[str, float] | None = None) -> tuple[float, list[float]] | None:
    """(sum of device kernel time, [the part in kernels whose name contains
    each of ``matches``]) of one ``fn()`` (or of ``kernels``, a
    ``device_kernels`` result), in ms; None when the profiler records no
    device time on this machine."""
    kernels = device_kernels(fn) if kernels is None else kernels
    if not kernels:
        return None
    return (sum(kernels.values()),
            [sum(ms for name, ms in kernels.items() if m in name) for m in matches])


def device_busy_ms(fn) -> float | None:
    """Sum of device kernel time of one ``fn()`` under ``torch.profiler``
    (None when the profiler records no device time on this machine)."""
    got = device_kernel_ms(fn)
    return None if got is None else got[0]


def attention_bound_ms(b: int, hq: int, hkv: int, s: int, d: int, causal: bool) -> tuple[float, str]:
    """The larger of (operations / bf16 peak) and (bytes / HBM rate). A
    causal call needs half the score matrix: 2*B*Hq*S^2*D flops for the two
    products together; full attention twice that. Bytes: q, k, v read once,
    out written once, bf16."""
    flops = (2 if causal else 4) * b * hq * s * s * d
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def carry_bound_ms(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, rel: int,
                   itemsize: int, f32: bool = False) -> tuple[float, str]:
    """The larger of bytes / HBM rate and operations / peak rate for one
    ring hop over THIS hop's mask (row iq sees key ik when iq - ik >= rel).
    Operations: 4*B*Hq*D per visible (query, key) pair (two FMAs each for
    q.k and p.v) over the bf16 tensor-core peak, or the f32 peak for f32
    inputs. Bytes: the q rows that see a key, the K/V rows some row sees,
    and those rows' carry read and written (acc D f32, m and l f32). A
    future block needs nothing."""
    pairs = sum(max(0, min(sk, iq - rel + 1)) for iq in range(sq))
    rows = min(sq, max(0, sq - max(rel, 0)))
    keys = min(sk, max(0, sq - rel))
    flops = 4 * b * hq * d * pairs
    nbytes = (b * hq * rows * d * itemsize + 2 * b * hkv * keys * d * itemsize
              + 2 * b * hq * rows * (d + 2) * 4)
    t_ops = flops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def phase_environment() -> None:
    import torch

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    for mod in ("ninja", "aiohttp", "grpc", "yaml", "ml_dtypes"):
        found = importlib.util.find_spec(mod) is not None
        log(f"optional package {mod}: {'present' if found else 'absent'} (not needed)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    log(f"device 0: {torch.cuda.get_device_name(0)}; devices: {torch.cuda.device_count()}")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    # plain-version matmuls in full f32 (both TF32 switches off, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sass_counts(lib_path, kernel: str, opcodes: tuple[str, ...]) -> dict[str, int]:
    """How many instructions of each opcode the SASS of every function
    whose name contains ``kernel`` holds (``cuobjdump -sass`` of the built
    library, found beside nvcc)."""
    from tfservingcache_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = dict.fromkeys(opcodes, 0)
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            for op in opcodes:
                counts[op] += f" {op}" in line
    return counts


def resource_usage(lib_path, kernel: str) -> dict:
    """What ptxas allotted every function whose name contains ``kernel``,
    read from the built library (``cuobjdump -res-usage``, found beside
    nvcc), so it holds whether or not this run compiled it: how many there
    are, the most registers one uses, and the stack frame and local memory
    bytes summed over them, with the functions that have either. A spill
    lives in the stack frame, so 0 stack and 0 local bytes is 0 spills."""
    from tfservingcache_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    usage = {"functions": 0, "max_registers": 0, "stack_bytes": 0, "local_bytes": 0,
             "with_stack_or_local": []}
    name = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
            continue
        if name is None or kernel not in name or "REG:" not in line:
            name = None
            continue
        fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
        usage["functions"] += 1
        usage["max_registers"] = max(usage["max_registers"], int(fields["REG"]))
        stack, local = int(fields.get("STACK", 0)), int(fields.get("LOCAL", 0))
        usage["stack_bytes"] += stack
        usage["local_bytes"] += local
        if stack or local:
            usage["with_stack_or_local"].append(name)
        name = None
    return usage


def phase_build() -> dict:
    from tfservingcache_tpu_torch.ops import _build

    paths = _build.build()
    for name, path in paths.items():
        log(f"built {name}: {os.path.relpath(path, ROOT)}")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                log(f"  ptxas: {line.strip()}")
    # the bf16 flash kernel (B2) is built on wgmma and TMA
    sass = sass_counts(paths["flash_attention"], "flash_fwd_kernel", ("HGMMA", "UTMALDG"))
    log(f"flash_fwd_kernel SASS: {sass} (HGMMA: wgmma, UTMALDG: TMA loads)")
    if not all(sass.values()):
        raise AssertionError(f"flash_fwd_kernel SASS lacks wgmma or TMA: {sass}")
    # the paged kernels (B1, B3) stage K/V with cp.async (LDGSTS) and run
    # mma.sync (HMMA) on bf16 pages, and use no local memory (no spills)
    paged = {}
    for kernel in ("paged_decode_attention_kernel", "paged_verify_attention_kernel"):
        paged[kernel] = sass_counts(paths["paged_attention"], kernel, ("LDGSTS", "HMMA"))
        log(f"{kernel} SASS: {paged[kernel]} (LDGSTS: cp.async, HMMA: mma.sync)")
        if not all(paged[kernel].values()):
            raise AssertionError(f"{kernel} SASS lacks cp.async or mma.sync: {paged[kernel]}")
    usage = resource_usage(paths["paged_attention"], "paged_")
    log(f"paged kernels, registers and local memory (cuobjdump -res-usage): {usage}")
    if not usage["functions"]:
        raise AssertionError("cuobjdump -res-usage reports no paged kernel")
    if usage["stack_bytes"] or usage["local_bytes"]:
        raise AssertionError(f"the paged kernels use local memory (spills): {usage}")
    # the bf16 carry kernel (B4) is built on B2's design (wgmma, TMA), and
    # neither carry kernel (bf16, f32) uses local memory
    carry_sass = sass_counts(paths["flash_attention"], "flash_attention_carry_kernel",
                             ("HGMMA", "UTMALDG"))
    log(f"flash_attention_carry_kernel SASS: {carry_sass} (HGMMA: wgmma, UTMALDG: TMA loads)")
    if not all(carry_sass.values()):
        raise AssertionError(f"flash_attention_carry_kernel SASS lacks wgmma or TMA: {carry_sass}")
    carry_usage = resource_usage(paths["flash_attention"], "flash_attention_carry")
    log(f"carry kernels, registers and local memory (cuobjdump -res-usage): {carry_usage}")
    if not carry_usage["functions"]:
        raise AssertionError("cuobjdump -res-usage reports no carry kernel")
    if carry_usage["stack_bytes"] or carry_usage["local_bytes"]:
        raise AssertionError(f"the carry kernels use local memory (spills): {carry_usage}")
    return {"flash_attention": sass,
            "flash_attention_carry": {**carry_sass, "resources": carry_usage},
            "paged_attention": {**paged, "resources": usage}}


def phase_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    main = None
    log(f"flash_attention vs attention_reference, tolerance {ATTN_TOL} (max |diff|)")
    for (b, hq, hkv, s, d) in KERNEL_SHAPES:
        for causal in (True, False):
            q = torch.randn(b, hq, s, d, device="cuda", generator=gen).bfloat16()
            k = torch.randn(b, hkv, s, d, device="cuda", generator=gen).bfloat16()
            v = torch.randn(b, hkv, s, d, device="cuda", generator=gen).bfloat16()
            out = A.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            ref = A.attention_reference(q, k, v, causal)
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            worst = max(worst, err)
            ms = cuda_ms(lambda: A.flash_attention(q, k, v, causal))
            plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, causal), reps=10, warmup=1)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv))
            bound, bound_by = attention_bound_ms(b, hq, hkv, s, d, causal)
            log(
                f"  B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}: "
                f"max_abs_err={err:.6g} finite={finite} kernel={ms:.4f}ms "
                f"plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms bound={bound:.4f}ms ({bound_by}) "
                f"bound/kernel={bound / ms:.3f}"
            )
            if not finite or not err <= ATTN_TOL:
                raise AssertionError(
                    f"flash_attention disagrees at {(b, hq, hkv, s, d)} causal={causal}: "
                    f"max_abs_err {err} > {ATTN_TOL} or non-finite"
                )
            if (b, hq, hkv, s, d) == MAIN_SHAPE and causal:
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms}
            del q, k, v, out, ref
    worst_f32 = 0.0
    log(f"flash_attention f32 vs attention_reference, tolerance {ATTN_TOL_F32} (max |diff|)")
    for (b, hq, hkv, s, d) in KERNEL_SHAPES_F32:
        for causal in (True, False):
            q = torch.randn(b, hq, s, d, device="cuda", generator=gen)
            k = torch.randn(b, hkv, s, d, device="cuda", generator=gen)
            v = torch.randn(b, hkv, s, d, device="cuda", generator=gen)
            out = A.attention(q, k, v, causal)  # the dispatch: f32 passes the gate
            torch.cuda.synchronize()
            ref = A.attention_reference(q, k, v, causal)
            err = (out - ref).abs().max().item()
            worst_f32 = max(worst_f32, err)
            ms = cuda_ms(lambda: A.flash_attention(q, k, v, causal))
            plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, causal), reps=10, warmup=1)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
            flops = (2 if causal else 4) * b * hq * s * s * d
            nbytes = 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
            t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
            bound, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            log(
                f"  f32 B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}: "
                f"max_abs_err={err:.6g} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                f"sdpa={lib_ms:.4f}ms bound={bound:.4f}ms ({bound_by}, f32 FMA peak) "
                f"bound/kernel={bound / ms:.3f}"
            )
            if out.dtype != torch.float32 or not err <= ATTN_TOL_F32:
                raise AssertionError(
                    f"f32 flash_attention disagrees at {(b, hq, hkv, s, d)} causal={causal}: "
                    f"max_abs_err {err} > {ATTN_TOL_F32} (dtype {out.dtype})"
                )
            del q, k, v, out, ref
    torch.cuda.empty_cache()
    return {
        "flash_attention": {
            "name": "flash_attention",
            "route": "cuda",
            "source": "tfservingcache_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "tfservingcache_tpu/ops/attention.py:211",
            "launches": 0,
            "max_abs_err": worst,
            **main,
            "shape": list(MAIN_SHAPE),
            "causal": True,
            "max_abs_err_f32": worst_f32,
        }
    }


def _paged_arena(gen, cgen, lanes, hkv, d, pt, max_pos, t_q=1, overrun=False):
    """A scattered arena (random rows from the card's generator ``cgen``)
    with ragged positions (lane 0 at ``max_pos``, the
    others uniform in [max_pos / 4, max_pos]), each lane's pages at shuffled
    arena slots and its table slots past the live pages on the trash page
    0 (the layout tests/test_paged_kernel.py builds). With T query
    positions a lane's live pages reach pos + T - 1; ``overrun`` sizes the
    tables to max_pos and puts lane 0 where pos + T runs past its table."""
    import torch

    pps = -(-(max_pos + (1 if overrun else t_q)) // pt)
    n_pages = lanes * pps + 1
    tables = (torch.randperm(n_pages - 1, generator=gen) + 1).reshape(lanes, pps).int()
    pos = torch.randint(max_pos // 4, max_pos + 1, (lanes,), generator=gen).int()
    pos[0] = pps * pt - max(1, t_q // 2) if overrun else max_pos
    for s in range(lanes):
        tables[s, -(-(int(pos[s]) + t_q) // pt):] = 0
    kp = torch.randn(n_pages, hkv, pt, d, generator=cgen, device="cuda")
    vp = torch.randn(n_pages, hkv, pt, d, generator=cgen, device="cuda")
    return kp, vp, tables, pos


def paged_bound_ms(pos, hq, hkv, d, pt, kv_itemsize, q_itemsize, quantized, t_q=1,
                   max_keys=None, f32=False):
    """The larger of bytes / HBM rate and operations / peak rate for one
    paged attention call with T query positions per lane (T = 1: a decode
    step) over THIS run's positions. Bytes: the K/V rows visible to each
    lane's deepest frontier (min(pos + T, max_keys), K and V), their f32
    scales for int8, the table entries read, pos, q and the f32 output.
    Operations: 4*Hq*D per (query, visible key) pair (two FMAs each for q.k
    and p.v) over the bf16 tensor-core peak, or the f32 peak for an f32
    arena. At T = 1 the operations' time is two orders below the bytes'."""
    cap = max_keys if max_keys is not None else float("inf")
    lanes = len(pos)
    rows = sum(min(int(p) + t_q, cap) for p in pos)
    pairs = sum(min(int(p) + t + 1, cap) for p in pos for t in range(t_q))
    nbytes = rows * hkv * d * 2 * kv_itemsize
    if quantized:
        nbytes += rows * hkv * 2 * 4
    nbytes += sum(-(-min(int(p) + t_q, cap) // pt) for p in pos) * 4 + lanes * 4
    nbytes += lanes * hq * t_q * d * (q_itemsize + 4)
    flops = 4 * hq * d * pairs
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def paged_plan(A, q, kp, tables) -> list[int]:
    """[n_splits, pages_per_split] of the launch the paged wrappers make
    for these arguments."""
    plan = A.paged_launch_plan(q, kp, tables)
    return [plan["n_splits"], plan["pages_per_split"]]


def phase_paged_kernel(seed: int) -> dict:
    """paged_decode_attention_kernel vs its plain version on the card, for
    bf16 and int8 arenas at every shape and an f32 arena at the first."""
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows
    from tfservingcache_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(seed + 1)
    cgen = torch.Generator(device="cuda").manual_seed(seed + 1)
    main = None
    worst = {}
    log("paged_decode_attention vs paged_decode_attention (plain), tolerance "
        f"{PAGED_TOL} (max |diff|); yardstick: F.scaled_dot_product_attention on "
        "K/V ALREADY GATHERED to dense (S, Hkv, L, D) with a boolean mask, the "
        "gather excluded (no single PyTorch call computes paged attention)")
    for shape in PAGED_SHAPES:
        lanes, hq, hkv, d, pt, max_pos = shape
        kp32, vp32, tables_h, pos_h = _paged_arena(gen, cgen, lanes, hkv, d, pt, max_pos)
        q32 = torch.randn(lanes, hq, 1, d, generator=cgen, device="cuda")
        arenas = ["bfloat16", "int8"] + (["float32"] if shape == PAGED_MAIN else [])
        tables, pos = tables_h.cuda(), pos_h.cuda()
        for arena in arenas:
            ks = vs = None
            if arena == "int8":
                q = q32.bfloat16()
                kp, ks = _quantize_kv_rows(kp32)
                vp, vs = _quantize_kv_rows(vp32)
                plain_k, plain_v = A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs)
                kv_item, dense_dt = 1, torch.bfloat16
            else:
                dt = getattr(torch, arena)
                q, kp, vp = q32.to(dt), kp32.to(dt), vp32.to(dt)
                plain_k, plain_v = kp, vp
                kv_item, dense_dt = kp.element_size(), dt
            out = A.paged_decode_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
            torch.cuda.synchronize()
            ref = A.paged_decode_attention(q, plain_k, plain_v, tables, pos, pt)
            err = (out - ref).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            worst[arena] = max(worst.get(arena, 0.0), err)
            ms = cuda_ms(lambda: A.paged_decode_attention_kernel(
                q, kp, vp, tables, pos, ks, vs, page_tokens=pt))
            plain_ms = cuda_ms(lambda: A.paged_decode_attention(
                q, plain_k, plain_v, tables, pos, pt), reps=5, warmup=1)
            # yardstick: SDPA over K/V gathered to dense beforehand (excluded)
            kd = A.paged_gather_kv(plain_k, tables, pt).to(dense_dt)
            vd = A.paged_gather_kv(plain_v, tables, pt).to(dense_dt)
            mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
                    <= pos.long()[:, None])[:, None, None, :]
            qd = q.to(dense_dt)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=hq != hkv))
            bound, bound_by = paged_bound_ms(pos_h.tolist(), hq, hkv, d, pt, kv_item,
                                             q.element_size(), arena == "int8",
                                             f32=arena == "float32")
            splits = paged_plan(A, q, kp, tables)
            log(
                f"  S={lanes} Hq={hq} Hkv={hkv} D={d} pt={pt} max_pos={max_pos} "
                f"(live rows {int(pos_h.sum()) + lanes}) {arena} splits={splits}: "
                f"max_abs_err={err:.6g} "
                f"finite={finite} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                f"sdpa_on_gathered={lib_ms:.4f}ms bound={bound:.4f}ms ({bound_by}) "
                f"bound/kernel={bound / ms:.3f}"
            )
            if not finite or not err <= PAGED_TOL[arena]:
                raise AssertionError(
                    f"paged_decode_attention disagrees at {shape} {arena}: max_abs_err "
                    f"{err} > {PAGED_TOL[arena]} or non-finite"
                )
            if shape == PAGED_MAIN and arena == "bfloat16":
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms, "splits": splits}
            del out, ref, kd, vd, kp, vp, plain_k, plain_v
        del kp32, vp32
        torch.cuda.empty_cache()
    return {
        "paged_decode_attention": {
            "name": "paged_decode_attention",
            "route": "cuda",
            "source": "tfservingcache_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "tfservingcache_tpu/ops/attention.py:705",
            "launches": 0,
            "max_abs_err": max(worst.values()),
            **main,
            "library_note": "SDPA on K/V already gathered to dense, gather excluded",
            "shape": list(PAGED_MAIN),
            "arena": "bfloat16",
            "max_abs_err_by_arena": worst,
        }
    }


def phase_verify_kernel(seed: int) -> dict:
    """paged_verify_attention_kernel (B3) vs its plain version on the card
    at every VERIFY_SHAPES row; at T = 1 also its gap to the decode kernel
    (B1) on the same inputs (one body: 0 expected)."""
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows
    from tfservingcache_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(seed + 3)
    cgen = torch.Generator(device="cuda").manual_seed(seed + 3)
    main = None
    worst = {}
    t1_gap = 0.0
    log("paged_verify_attention vs paged_verify_attention (plain), tolerance "
        f"{PAGED_TOL} (max |diff|); yardstick: F.scaled_dot_product_attention on "
        "K/V ALREADY GATHERED to dense (S, Hkv, L, D) with a boolean (T, L) mask per "
        "lane, the gather excluded")
    for (lanes, hq, hkv, d, pt, max_pos, t_q, arenas, overrun) in VERIFY_SHAPES:
        shape = (lanes, hq, hkv, d, pt, max_pos, t_q)
        kp32, vp32, tables_h, pos_h = _paged_arena(gen, cgen, lanes, hkv, d, pt, max_pos,
                                                   t_q=t_q, overrun=overrun)
        q32 = torch.randn(lanes, hq, t_q, d, generator=cgen, device="cuda")
        tables, pos = tables_h.cuda(), pos_h.cuda()
        max_keys = tables_h.shape[1] * pt
        for arena in arenas:
            ks = vs = None
            if arena == "int8":
                q = q32.bfloat16()
                kp, ks = _quantize_kv_rows(kp32)
                vp, vs = _quantize_kv_rows(vp32)
                plain_k, plain_v = A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs)
                kv_item, dense_dt = 1, torch.bfloat16
            else:
                dt = getattr(torch, arena)
                q, kp, vp = q32.to(dt), kp32.to(dt), vp32.to(dt)
                plain_k, plain_v = kp, vp
                kv_item, dense_dt = kp.element_size(), dt
            out = A.paged_verify_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
            torch.cuda.synchronize()
            ref = A.paged_verify_attention(q, plain_k, plain_v, tables, pos, pt)
            err = (out - ref).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            worst[arena] = max(worst.get(arena, 0.0), err)
            gap = ""
            if t_q == 1:
                b1 = A.paged_decode_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
                torch.cuda.synchronize()
                g1 = (out - b1).abs().max().item()
                t1_gap = max(t1_gap, g1)
                gap = f" |B3 - B1|={g1:.3g}"
            ms = cuda_ms(lambda: A.paged_verify_attention_kernel(
                q, kp, vp, tables, pos, ks, vs, page_tokens=pt))
            plain_ms = cuda_ms(lambda: A.paged_verify_attention(
                q, plain_k, plain_v, tables, pos, pt), reps=5, warmup=1)
            kd = A.paged_gather_kv(plain_k, tables, pt).to(dense_dt)
            vd = A.paged_gather_kv(plain_v, tables, pt).to(dense_dt)
            q_pos = pos.long()[:, None] + torch.arange(t_q, device="cuda")[None, :]
            mask = (torch.arange(kd.shape[2], device="cuda")[None, None, :]
                    <= q_pos[:, :, None])[:, None]                         # (S, 1, T, L)
            qd = q.to(dense_dt)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=hq != hkv))
            bound, bound_by = paged_bound_ms(pos_h.tolist(), hq, hkv, d, pt, kv_item,
                                             q.element_size(), arena == "int8", t_q=t_q,
                                             max_keys=max_keys, f32=arena == "float32")
            splits = paged_plan(A, q, kp, tables)
            log(
                f"  S={lanes} Hq={hq} Hkv={hkv} D={d} pt={pt} max_pos={max_pos} T={t_q}"
                f"{' (lane 0 past its table)' if overrun else ''} {arena} splits={splits}: "
                f"max_abs_err={err:.6g} finite={finite}{gap} kernel={ms:.4f}ms "
                f"plain={plain_ms:.4f}ms sdpa_on_gathered={lib_ms:.4f}ms "
                f"bound={bound:.4f}ms ({bound_by}) bound/kernel={bound / ms:.3f}"
            )
            if not finite or not err <= PAGED_TOL[arena]:
                raise AssertionError(
                    f"paged_verify_attention disagrees at {shape} {arena}: max_abs_err "
                    f"{err} > {PAGED_TOL[arena]} or non-finite"
                )
            if shape == VERIFY_MAIN and arena == "bfloat16":
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms, "splits": splits}
            del out, ref, kd, vd, kp, vp, plain_k, plain_v
        del kp32, vp32
        torch.cuda.empty_cache()
    log(f"paged_verify_attention at T = 1 vs paged_decode_attention (B1), same inputs: "
        f"max |diff| {t1_gap:.3g} (one body)")
    return {
        "paged_verify_attention": {
            "name": "paged_verify_attention",
            "route": "cuda",
            "source": "tfservingcache_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "tfservingcache_tpu/ops/attention.py:945",
            "launches": 0,
            "max_abs_err": max(worst.values()),
            **main,
            "library_note": "SDPA on K/V already gathered to dense with a (T, L) mask, "
                            "gather excluded",
            "shape": list(VERIFY_MAIN),
            "arena": "bfloat16",
            "max_abs_err_by_arena": worst,
            "t1_gap_to_paged_decode": t1_gap,
        }
    }


def _empty_carry(b: int, h: int, s: int, d: int):
    import torch

    from tfservingcache_tpu_torch.ops import attention as A

    return (torch.zeros(b, h, s, d, device="cuda"),
            torch.full((b, h, s, 1), A.NEG_INF, device="cuda"),
            torch.zeros(b, h, s, 1, device="cuda"))


def phase_carry_kernel(seed: int) -> dict:
    """flash_attention_carry (B4) vs its plain version on the card at every
    CARRY_HOPS row, each from a carried state (the plain hop over an earlier
    block every row sees); the future hop must leave the carry bit-identical.
    Then the chained ring on one card (RING_CHAIN over RING_SHARDS shards)
    against attention_reference, timed beside B2 and SDPA at the full shape,
    and B4's gap to B2 (one hop at rel 0 from an empty carry, normalized as
    B2 normalizes): two kernels of one design, held to B2's own ATTN_TOL.
    Every row prints its bound over the kernel's time."""
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.parallel.ring_attention import ring_attention

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    worst = {}
    worst_m = 0.0
    main = None
    log("flash_attention_carry vs flash_attention_carry_reference (plain) from a carried "
        f"state, tolerance {CARRY_TOL} on acc / l and {CARRY_M_TOL} on m (max |diff|); no "
        "PyTorch call computes one hop (library yardstick: the chained ring below)")
    for (b, hq, hkv, sq, sk, d, dt, rel) in CARRY_HOPS:
        dtype = getattr(torch, dt)

        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

        q, k, v, k0, v0 = (rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d),
                           rnd(b, hkv, sk, d), rnd(b, hkv, sk, d))
        carry = A.flash_attention_carry_reference(q, k0, v0, *_empty_carry(b, hq, sq, d), -sk)
        want = A.flash_attention_carry_reference(q, k, v, *carry, rel)
        got = A.flash_attention_carry(q, k, v, *[t.clone() for t in carry], rel)
        torch.cuda.synchronize()
        err = ((got[0] / got[2].clamp_min(1e-30)) - (want[0] / want[2].clamp_min(1e-30))
               ).abs().max().item()
        m_err = (got[1] - want[1]).abs().max().item()
        blind = max(0, min(rel, sq))  # rows 0 .. rel - 1 see no key of this hop
        kept = all(torch.equal(g[:, :, :blind], c[:, :, :blind]) for g, c in zip(got, carry))
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        worst[dt] = max(worst.get(dt, 0.0), err)
        worst_m = max(worst_m, m_err)
        scratch = [t.clone() for t in carry]  # the timed calls update it in place
        ms = cuda_ms(lambda: A.flash_attention_carry(q, k, v, *scratch, rel))
        plain_ms = cuda_ms(lambda: A.flash_attention_carry_reference(q, k, v, *carry, rel),
                           reps=10, warmup=1)
        bound, bound_by = carry_bound_ms(b, hq, hkv, sq, sk, d, rel, q.element_size(),
                                         f32=dtype == torch.float32)
        share = f"bound/kernel={bound / ms:.3f}" if bound > 0 else "bound 0 (no row sees a key)"
        log(f"  B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} {dt} rel={rel}: "
            f"max_abs_err={err:.6g} m_err={m_err:.3g} finite={finite} "
            f"blind rows kept={kept} ({blind}) kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
            f"bound={bound:.4f}ms ({bound_by}) {share}")
        if not finite or not err <= CARRY_TOL[dt] or not m_err <= CARRY_M_TOL or not kept:
            raise AssertionError(
                f"flash_attention_carry disagrees at {(b, hq, hkv, sq, sk, d)} {dt} rel={rel}: "
                f"max_abs_err {err} (tolerance {CARRY_TOL[dt]}), m {m_err}, blind rows kept "
                f"{kept}, finite {finite}")
        if blind == sq and not all(torch.equal(g, c) for g, c in zip(got, carry)):
            raise AssertionError(f"the future hop rel={rel} changed the carry")
        if (b, hq, hkv, sq, sk, d) == CARRY_MAIN and dt == "bfloat16" and rel == -sk:
            main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}
        del q, k, v, k0, v0, carry, want, got, scratch
        torch.cuda.empty_cache()

    # the chained ring on one card against the plain attention, B2 and SDPA
    b, h, hkv, s, d = RING_CHAIN
    q, k, v = (torch.randn(b, n, s, d, device="cuda", generator=gen).bfloat16()
               for n in (h, hkv, hkv))
    before = A.CARRY_LAUNCHES.value
    out = ring_attention(q, k, v, [RING_DEVICE] * RING_SHARDS)
    torch.cuda.synchronize()
    hops = A.CARRY_LAUNCHES.value - before
    ref = A.attention_reference(q, k, v)
    chain_err = (out.float() - ref.float()).abs().max().item()
    del ref
    torch.cuda.empty_cache()
    chain_ms = cuda_ms(lambda: ring_attention(q, k, v, [RING_DEVICE] * RING_SHARDS), reps=10)
    b2_ms = cuda_ms(lambda: A.flash_attention(q, k, v, True), reps=10)
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), reps=10)
    prof = device_kernel_ms(lambda: ring_attention(q, k, v, [RING_DEVICE] * RING_SHARDS),
                            ("flash_attention_carry",))
    b4_ms = None if prof is None else prof[1][0]
    bound, bound_by = attention_bound_ms(b, h, hkv, s, d, True)
    log(f"chained ring on one card: {RING_CHAIN} (B, H, Hkv, S, D) causal over {RING_SHARDS} "
        f"shards: {hops} carry launches, max |ring - attention_reference| = {chain_err:.6g} "
        f"(tolerance {ATTN_TOL}); ring {chain_ms:.4f} ms (its B4 launches "
        f"{'not measured' if b4_ms is None else f'{b4_ms:.4f} ms, torch.profiler'}; the rest "
        f"is shard copies, the carry's set-up and the normalization), B2 {b2_ms:.4f} ms, "
        f"SDPA {sdpa_ms:.4f} ms, attention bound {bound:.4f} ms ({bound_by})")
    if hops != RING_SHARDS**2 or not chain_err <= ATTN_TOL:
        raise AssertionError(f"chained ring: {hops} launches, max_abs_err {chain_err}")
    del q, k, v, out

    # B4's gap to B2: one hop at rel 0 from an empty carry, normalized as
    # B2 normalizes (times the reciprocal of max(l, 1e-30), rounded to bf16)
    b, hq, hkv, s, d = MAIN_SHAPE
    q = torch.randn(b, hq, s, d, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b, hkv, s, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b, hkv, s, d, device="cuda", generator=gen).bfloat16()
    acc, _m, l = A.flash_attention_carry(q, k, v, *_empty_carry(b, hq, s, d), 0)
    b4_out = (acc * (1.0 / l.clamp_min(1e-30))).bfloat16()
    b2_gap = (b4_out.float() - A.flash_attention(q, k, v, True).float()).abs().max().item()
    log(f"flash_attention_carry at rel 0 from an empty carry vs flash_attention (B2) at "
        f"{MAIN_SHAPE}: max |diff| {b2_gap:.3g} (tolerance {ATTN_TOL})")
    if not b2_gap <= ATTN_TOL:
        raise AssertionError(f"B4 at rel 0 differs from B2 by {b2_gap} > {ATTN_TOL}")
    del q, k, v, acc, l, b4_out
    torch.cuda.empty_cache()
    return {
        "flash_attention_carry": {
            "name": "flash_attention_carry",
            "route": "cuda",
            "source": "tfservingcache_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "tfservingcache_tpu/ops/attention.py:393",
            "launches": 0,
            "max_abs_err": worst["bfloat16"],
            **main,
            "library_ms": sdpa_ms,
            "library_note": "no PyTorch call computes one hop: SDPA(is_causal) over the whole "
                            f"{list(RING_CHAIN)} (B, H, Hkv, S, D), beside chain_ms (the ring "
                            f"of {RING_SHARDS} shards on one card, {RING_SHARDS ** 2} B4 "
                            "launches) and chain_b2_ms (B2 at that shape)",
            "shape": list(CARRY_MAIN),
            "rel": -CARRY_MAIN[4],
            "max_abs_err_f32": worst["float32"],
            "max_m_err": worst_m,
            "chain_shape": list(RING_CHAIN),
            "chain_ms": chain_ms,
            "chain_b4_ms": b4_ms,
            "chain_b2_ms": b2_ms,
            "chain_max_abs_err": chain_err,
            "b2_gap": b2_gap,
        }
    }


def _post(url: str, body: dict, timeout: float) -> tuple[int, dict, float]:
    data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    dt = time.monotonic() - t0  # the client's own JSON parse stays outside
    return status, json.loads(raw), dt


class Artifact:
    """The random-weight llama-7b-width artifact both serving phases load,
    and the same weights as a module on the card for the plain path."""

    def __init__(self, layers: int, seed: int) -> None:
        import torch

        from tfservingcache_tpu_torch.models import registry
        from tfservingcache_tpu_torch.models.transformer_lm import LLAMA7B_CONFIG
        from tfservingcache_tpu_torch.types import ModelId

        self.layers = layers
        self.model_id = ModelId("llama7b", 1)
        model_cfg = dict(LLAMA7B_CONFIG, n_layers=layers)
        model_def = registry.build("transformer_lm", model_cfg)
        self.vocab = model_cfg["vocab_size"]
        log(f"transformer_lm at llama-7b width: d_model={model_cfg['d_model']} "
            f"heads={model_cfg['n_heads']} d_ff={model_cfg['d_ff']} vocab={self.vocab}, "
            f"n_layers={layers} (of 32)")
        self.work = tempfile.mkdtemp(prefix="tpusc_chip_smoke_")
        t0 = time.monotonic()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = model_def.init(gen)

        def to_bf16(tree):
            if isinstance(tree, dict):
                return {k: to_bf16(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [to_bf16(v) for v in tree]
            return tree.to(torch.bfloat16)

        params = to_bf16(params)  # the artifact's storage dtype, cast on the card
        self.store = os.path.join(self.work, "store")
        registry.save_artifact(os.path.join(self.store, "llama7b", "1"), model_def, params)
        self.nbytes = os.path.getsize(os.path.join(self.store, "llama7b", "1", "params.bin"))
        log(f"wrote random-weight artifact (seed {seed}): {self.nbytes} bytes "
            f"in {time.monotonic() - t0:.2f}s")
        self.plain_model = model_def.make_module(params).eval()  # same weights, plain path
        # two drafts for the speculative arms: an exact copy of the target
        # under another name, and a 1-layer model built from the target's
        # embed, layer 0 and ln_f
        t0 = time.monotonic()
        shutil.copytree(os.path.join(self.store, "llama7b"), os.path.join(self.store, "copy"))
        self.draft_layers = 1
        registry.save_artifact(
            os.path.join(self.store, "layer0", "1"),
            registry.build("transformer_lm", dict(model_cfg, n_layers=self.draft_layers)),
            {"embed": params["embed"], "layers": params["layers"][:self.draft_layers],
             "ln_f": params["ln_f"]},
        )
        log(f"wrote the drafts: 'copy' (the target, {layers} layers) and 'layer0' "
            f"(embed + layer 0 + ln_f) in {time.monotonic() - t0:.2f}s")
        # the same weights under "attention": "ring" for the ring phase
        t0 = time.monotonic()
        self.ring_id = ModelId("llama7b_ring", 1)
        registry.save_artifact(
            os.path.join(self.store, self.ring_id.name, "1"),
            registry.build("transformer_lm", dict(model_cfg, attention="ring")), params)
        log(f"wrote '{self.ring_id.name}' (the same weights, \"attention\": \"ring\") in "
            f"{time.monotonic() - t0:.2f}s")

    def node_config(self, name: str, **serving) -> dict:
        return {
            "serving": {"load_timeout_s": 900.0, "max_concurrent_models": 2, **serving},
            "cache": {"base_dir": os.path.join(self.work, f"cache_{name}"),
                      "disk_capacity_bytes": 4 * self.nbytes},
            "model_provider": {"type": "disk", "base_dir": self.store},
            "cache_node": {"rest_port": 0},
        }

    def close(self) -> None:
        shutil.rmtree(self.work, ignore_errors=True)


def phase_serve(art: Artifact, seed: int, warm_reps: int, kernels: dict) -> None:
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.model_runtime import next_bucket
    from tfservingcache_tpu_torch.server import build_node

    model_id, vocab, layers, plain_model = art.model_id, art.vocab, art.layers, art.plain_model
    node = None
    try:
        cfg = config_from_dict(art.node_config("serve"))
        node = build_node(cfg, device="cuda")
        port = node.start("127.0.0.1")
        url = f"http://127.0.0.1:{port}/v1/models/{model_id.name}/versions/1:predict"
        rng = np.random.default_rng(seed)
        requests = []
        for shape in REQUEST_SHAPES:
            ids = rng.integers(0, vocab, size=shape, dtype=np.int64)
            requests += [(shape, ids, i == 0) for i in range(1 + warm_reps)]

        # --- the main path: counters to 0, REST requests, counters read ----
        A.FLASH_LAUNCHES.reset()
        results = []
        for n, (shape, ids, _first) in enumerate(requests):
            status, body, dt = _post(url, {"instances": ids.tolist()}, timeout=900.0)
            results.append((shape, ids, status, body, dt, n == 0))
        launches = A.FLASH_LAUNCHES.value
        # -------------------------------------------------------------------

        # the cold request's load runs one warm-up forward (seq 1) as well
        expected = layers * (len(requests) + 1)
        log(f"flash_attention launches on the serving path: {launches} "
            f"(n_layers {layers} x ({len(requests)} requests + the load's warm-up "
            f"forward) = {expected})")
        if launches != expected:
            raise AssertionError(f"kernel launch count {launches} != {expected}")
        kernels["flash_attention"]["launches"] = launches

        cold = [dt for *_, dt, is_cold in results if is_cold]
        log(f"cold :predict (fetch + load + first request, shape {REQUEST_SHAPES[0]}): "
            f"{cold[0] * 1e3:.1f} ms")
        checked = set()
        for shape in REQUEST_SHAPES:
            rows = [r for r in results if r[0] == shape and not r[5]]
            warm = [r[4] for r in rows]
            log(f"warm :predict {shape}: p50 {statistics.median(warm) * 1e3:.2f} ms "
                f"over {len(warm)} requests (host clock, localhost HTTP, JSON)")
        for shape, ids, status, body, _dt, _cold in results:
            if status != 200:
                raise AssertionError(f":predict {shape} answered {status}: {body}")
            pred = np.asarray(body["predictions"], dtype=np.float32)
            if pred.shape != (shape[0], vocab) or not np.isfinite(pred).all():
                raise AssertionError(f":predict {shape}: predictions {pred.shape}, finite="
                                     f"{bool(np.isfinite(pred).all())}")
            if shape in checked:
                continue
            checked.add(shape)
            padded = _check_logits(plain_model, shape, ids, pred)
            # where a warm request's time goes: the forward on the kernel
            # path (host clock, ends in a sync), the device kernels inside
            # it (profiler), the runtime's whole predict, the reply's JSON
            dev_in = {"input_ids": torch.from_numpy(padded).cuda()}

            def forward():
                with torch.inference_mode():
                    plain_model(dev_in)
                torch.cuda.synchronize()

            fwd_ms = host_ms(forward)
            predict_ms = host_ms(lambda: node.runtime.predict(model_id, {"input_ids": ids}))
            t0 = time.monotonic()
            json.dumps({"predictions": pred.tolist()})
            enc_ms = (time.monotonic() - t0) * 1e3
            log(f"  {shape} breakdown: forward {fwd_ms:.2f} ms, runtime.predict (pad + H2D "
                f"+ forward + D2H) {predict_ms:.2f} ms, JSON encode {enc_ms:.2f} ms")
            busy = device_busy_ms(lambda: plain_model(dev_in))
            if busy is None:
                log(f"  {shape} device busy share: not measured (the profiler saw no device time)")
            else:
                log(f"  {shape} device busy share of the forward: kernels {busy:.2f} ms of "
                    f"{fwd_ms:.2f} ms = {busy / fwd_ms:.3f} (torch.profiler, one forward)")
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        if node is not None:
            node.close()


def _check_logits(plain_model, shape, ids, pred):
    """A ``:predict`` answer's (B, V) last-token logits against the plain
    path on the card: the same weights, the same bucket-padded input,
    attention_reference in every layer. Within LOGITS_TOL, and argmax equal
    on every row whose top-2 margin exceeds twice its own |diff| (a
    narrower margin is a bf16 near-tie). -> the padded input."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.model_runtime import next_bucket

    padded = np.zeros((next_bucket(shape[0]), next_bucket(shape[1])), np.int32)
    padded[: shape[0], : shape[1]] = ids
    with torch.inference_mode():
        logits = plain_model(
            {"input_ids": torch.from_numpy(padded).cuda()},
            attention_fn=A.attention_reference,
        )["logits"]
        ref = logits[: shape[0], shape[1] - 1, :].cpu().numpy()
        del logits
    row_err = np.abs(pred - ref).max(axis=-1)
    err = float(row_err.max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    decided = margin > 2 * row_err
    agree = pred.argmax(-1) == ref.argmax(-1)
    log(f"  {shape}: max|logits - plain| = {err:.5g} (tolerance {LOGITS_TOL}); "
        f"argmax equal {agree.tolist()}; top-2 margins {np.round(margin, 4).tolist()}")
    if not err <= LOGITS_TOL:
        raise AssertionError(f"{shape}: logits differ from the plain path by {err}")
    if not agree[decided].all():
        raise AssertionError(f"{shape}: argmax differs from the plain path")
    if not decided.all():
        log(f"  {shape}: {int((~decided).sum())} row(s) with a top-2 margin under "
            "twice their max |diff| (a bf16 near-tie): argmax not binding")
    return padded


def phase_ring(art: Artifact, seed: int, warm_reps: int, kernels: dict) -> None:
    """REST :predict of the "ring" artifact on a node whose runtime is bound
    to RING_SHARDS copies of the card (``TorchModelRuntime(devices=...)``
    behind ``CacheNode``): cold, then warm, at RING_REQUEST_SHAPES. Every
    answer is checked against the plain single-device path, and the
    launches must be n_layers x RING_SHARDS^2 carry launches a ring request
    and n_layers flash launches a fall-through request (+ the load's seq-1
    warm-up forward, which no ring divides). Then one warm (1, 4096) ring
    forward's profile beside the same forward of the one-card "auto" model
    (B2)."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime, next_bucket
    from tfservingcache_tpu_torch.server import CacheNode

    cfg = config_from_dict(art.node_config("ring"))
    runtime = TorchModelRuntime(cfg.serving, devices=[RING_DEVICE] * RING_SHARDS)
    node = CacheNode(cfg, runtime)
    try:
        port = node.start("127.0.0.1")
        url = f"http://127.0.0.1:{port}/v1/models/{art.ring_id.name}/versions/1:predict"
        rng = np.random.default_rng(seed + 5)
        requests = []
        for shape in RING_REQUEST_SHAPES:
            ids = rng.integers(0, art.vocab, size=shape, dtype=np.int64)
            requests += [(shape, ids) for _ in range(1 + warm_reps)]

        # --- the main path: counters to 0, REST requests, counters read ----
        A.CARRY_LAUNCHES.reset()
        A.FLASH_LAUNCHES.reset()
        results = []
        for shape, ids in requests:
            status, body, dt = _post(url, {"instances": ids.tolist()}, timeout=900.0)
            results.append((shape, ids, status, body, dt))
        carry, flash = A.CARRY_LAUNCHES.value, A.FLASH_LAUNCHES.value
        # -------------------------------------------------------------------

        rings = sum(next_bucket(shape[1]) % RING_SHARDS == 0 for shape, _ in requests)
        falls = len(requests) - rings
        want_carry = art.layers * RING_SHARDS**2 * rings
        want_flash = art.layers * (falls + 1)
        log(f"carry launches on the ring path: {carry} (n_layers {art.layers} x "
            f"{RING_SHARDS}^2 hops x {rings} ring requests = {want_carry}); flash launches: "
            f"{flash} (n_layers x ({falls} fall-through requests + the load's warm-up "
            f"forward) = {want_flash})")
        if carry != want_carry or flash != want_flash or not carry:
            raise AssertionError(f"ring phase launches carry {carry} / flash {flash} != "
                                 f"{want_carry} / {want_flash}")
        kernels["flash_attention_carry"]["launches"] = carry
        kernels["flash_attention"]["launches"] += flash
        log(f"cold ring :predict (fetch + load + first request, shape {requests[0][0]}): "
            f"{results[0][4] * 1e3:.1f} ms")
        for shape in RING_REQUEST_SHAPES:
            warm = [r[4] for r in results if r[0] == shape][1:]
            kind = "ring" if next_bucket(shape[1]) % RING_SHARDS == 0 else "falls through to B2"
            log(f"warm ring-node :predict {shape} ({kind}): p50 "
                f"{statistics.median(warm) * 1e3:.2f} ms over {len(warm)} requests (host "
                "clock, localhost HTTP, JSON)")
        checked = set()
        for shape, ids, status, body, _dt in results:
            if status != 200:
                raise AssertionError(f"ring :predict {shape} answered {status}: {body}")
            pred = np.asarray(body["predictions"], dtype=np.float32)
            if pred.shape != (shape[0], art.vocab) or not np.isfinite(pred).all():
                raise AssertionError(f"ring :predict {shape}: predictions {pred.shape}, finite="
                                     f"{bool(np.isfinite(pred).all())}")
            if shape not in checked:
                checked.add(shape)
                _check_logits(art.plain_model, shape, ids, pred)
        torch.cuda.empty_cache()

        # one warm (1, 4096) forward: the ring module (B4 apart) and the
        # one-card "auto" model on the same weights (B2)
        ring_model = runtime._resident.get(art.ring_id, touch=False).module
        dev_in = {"input_ids": torch.from_numpy(
            rng.integers(0, art.vocab, size=RING_REQUEST_SHAPES[0], dtype=np.int64)).cuda()}
        for name, model, matches in (
                ("ring, 4 shards on one card", ring_model, ("flash_attention_carry",)),
                ("one-card auto (B2)", art.plain_model, ("flash_fwd_kernel",))):
            def forward():
                with torch.inference_mode():
                    model(dev_in)
                torch.cuda.synchronize()

            fwd_ms = host_ms(forward, reps=3)
            by_kernel = device_kernels(lambda: model(dev_in))
            prof = device_kernel_ms(None, matches, by_kernel)
            if prof is None:
                log(f"  (1, 4096) forward, {name}: {fwd_ms:.2f} ms host clock; device time "
                    "not measured (the profiler saw none)")
                continue
            busy, (attn,) = prof
            log(f"  (1, 4096) forward, {name}: {fwd_ms:.2f} ms host clock; device kernels "
                f"{busy:.2f} ms (busy share {busy / fwd_ms:.3f}, torch.profiler); "
                f"{matches[0]} {attn:.3f} ms = {attn / busy:.3f} of device time, "
                f"{attn / art.layers:.4f} ms a layer")
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
            log("    largest kernels: " + "; ".join(
                f"{ms / busy:.3f} {key[:60]}" for key, ms in top))
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        node.close()


def _teacher_forced_logits(plain_model, prompt, tokens):
    """The plain path's logits (``attention_reference`` in every layer) over
    prompt + emitted tokens: row j is the distribution token j was drawn
    from. -> (len(tokens), V) f32 on the host."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.ops import attention as A

    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int32)[None]
    with torch.inference_mode():
        logits = plain_model({"input_ids": torch.from_numpy(seq).cuda()},
                             attention_fn=A.attention_reference)["logits"][0]
        return logits[len(prompt) - 1:].cpu().numpy()


def _check_greedy(art, prompt, tokens, tol, what) -> float:
    """Every emitted token's plain logit lies within ``tol`` of its
    position's maximum (a served argmax, up to bf16/int8 near-ties).
    -> the largest gap."""
    import numpy as np

    logits = _teacher_forced_logits(art.plain_model, prompt, tokens)
    gap = logits.max(-1) - logits[np.arange(len(tokens)), tokens]
    worst = float(gap.max())
    if not worst <= tol:
        j = int(gap.argmax())
        raise AssertionError(f"{what}: token {j} ({tokens[j]}) is {worst} below the plain "
                             f"path's max logit (tolerance {tol})")
    return worst


def _post_many(url, bodies, clients):
    """POST every body from ``clients`` threads at once. -> [(status, body,
    seconds)] in the order of ``bodies``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=clients) as pool:
        return list(pool.map(lambda b: _post(url, b, timeout=900.0), bodies))


def _decode_chunk_breakdown(rt, model_id, layers: int, chunk: int = 8,
                            prompt_tokens: int = 600) -> None:
    """One warm decode chunk with every lane live at ``prompt_tokens``
    (the arena rows are whatever earlier rows left, fine for timing): host
    clock, device kernel time under torch.profiler, the paged kernel's
    share. Runs on the runtime directly while the engine is idle, and
    hands every page back."""
    st = rt._slot_states[model_id]
    for lane in range(st.slots):
        if not st.reserve_pages(lane, prompt_tokens + 8 * chunk):
            raise AssertionError("arena too small for the chunk breakdown")
        st.pos[lane], st.tok[lane], st.active[lane] = prompt_tokens, 1, True
        st.temps[lane], st.topks[lane] = 0.0, 0
    try:
        def one_chunk():
            rt.slot_decode_chunk(st, chunk)  # ends in a device-to-host copy

        ms = host_ms(one_chunk, reps=3)
        # the name family: the kernel and, with the page axis split, its combine kernel
        prof = device_kernel_ms(one_chunk, ("paged_decode_attention",))
    finally:
        for lane in range(st.slots):
            st.release_pages(lane)
        st.active[:] = False
        st.pos[:] = 0
    st.check_page_conservation()
    if prof is None:
        log(f"  warm decode chunk ({st.slots} lanes at {prompt_tokens} tokens, {chunk} steps): "
            f"{ms:.2f} ms host clock; device time not measured (the profiler saw none)")
        return
    busy, (paged,) = prof
    log(f"  warm decode chunk ({st.slots} lanes at {prompt_tokens} tokens, {chunk} steps): "
        f"{ms:.2f} ms host clock; device kernels {busy:.2f} ms (busy share {busy / ms:.3f}, "
        f"torch.profiler); paged kernel {paged:.3f} ms = {paged / busy:.3f} of device time, "
        f"{paged / (chunk * layers):.4f} ms a launch")


def _spec_round_breakdown(rt, model_id, layers: int, prompt_tokens: int = 600) -> None:
    """One warm speculative round with every lane live at
    ``prompt_tokens`` on both arenas (rows are whatever earlier rows left,
    fine for timing): host clock, device kernel time under torch.profiler,
    the draft's decode kernel's (B1) and the target's verify kernel's (B3)
    shares. Runs on the runtime directly while the engine is idle,
    and hands every page back."""
    st = rt._slot_states[model_id]
    d_st = st.spec_draft
    budget = prompt_tokens + 64  # the rounds below advance pos by <= spec + 1 each
    for lane in range(st.slots):
        if not (st.reserve_pages(lane, budget) and d_st.reserve_pages(lane, budget)):
            raise AssertionError("arena too small for the round breakdown")
        st.pos[lane], st.tok[lane], st.active[lane] = prompt_tokens, 1, True
        st.temps[lane], st.topks[lane] = 0.0, 0
    try:
        def one_round():
            rt.slot_decode_spec_round(st)  # ends in a device-to-host copy

        ms = host_ms(one_round, reps=3)
        prof = device_kernel_ms(
            one_round, ("paged_decode_attention", "paged_verify_attention"))
    finally:
        for lane in range(st.slots):
            st.release_pages(lane)
            d_st.release_pages(lane)
        st.active[:] = False
        st.pos[:] = 0
    st.check_page_conservation()
    d_st.check_page_conservation()
    what = (f"  warm spec round ({st.slots} lanes at {prompt_tokens} tokens, spec "
            f"{st.spec_tokens}): {ms:.2f} ms host clock")
    if prof is None:
        log(f"{what}; device time not measured (the profiler saw none)")
        return
    busy, (decode, verify) = prof
    log(f"{what}; device kernels {busy:.2f} ms (busy share {busy / ms:.3f}, torch.profiler); "
        f"draft decode kernel (B1) {decode:.3f} ms = {decode / busy:.3f} of device time; "
        f"target verify kernel (B3) {verify:.3f} ms = {verify / busy:.3f}, "
        f"{verify / layers:.4f} ms a launch")


def _continuous_arm(art, name, serving, prompts, tol, top1: bool, draft_layers: int = 0):
    """One continuous-engine arm on a fresh node: a warm-up request, the
    concurrent greedy burst, optionally an unseeded top_k=1 request. Every
    response checked; the census must be green (on both arenas with a
    draft) and the kernels' launches must equal what the engine ran:
    paged = n_layers x plain decode steps + draft_layers x (spec + 1) x
    spec rounds, verify = n_layers x spec rounds. -> (node, its :generate
    url, the arm's paged launches, its verify launches, greedy tokens)."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    cfg = config_from_dict(art.node_config(
        name, generate_engine="continuous", generate_slots=8, generate_chunk_tokens=8,
        kv_page_tokens=16, **serving))
    spec = cfg.serving.spec_tokens
    node = build_node(cfg, device="cuda")
    url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/llama7b/versions/1:generate"
    n_new = GEN_NEW_TOKENS
    bodies = [{"input_ids": [p.tolist()], "max_new_tokens": n_new} for p in prompts]
    # --- the main path: counters to 0, the arm's requests, counters read ---
    A.PAGED_LAUNCHES.reset()
    A.VERIFY_LAUNCHES.reset()
    t0 = time.monotonic()
    warm = _post(url, {"input_ids": [prompts[0][:32].tolist()], "max_new_tokens": 8}, 900.0)
    cold_s = time.monotonic() - t0
    t0 = time.monotonic()
    results = _post_many(url, bodies, GEN_CLIENTS)
    wall = time.monotonic() - t0
    top1_res = None
    if top1:
        top1_res = _post(url, dict(bodies[0], temperature=0.8, top_k=1), 900.0)
    launches = A.PAGED_LAUNCHES.value
    verify = A.VERIFY_LAUNCHES.value
    # ------------------------------------------------------------------------
    eng = node.engine
    expected = art.layers * eng.decode_steps + draft_layers * (spec + 1) * eng.spec_rounds
    expected_verify = art.layers * eng.spec_rounds
    log(f"  [{name}] paged kernel launches: {launches} (n_layers {art.layers} x decode steps "
        f"{eng.decode_steps} + draft layers {draft_layers} x (spec + 1) x spec rounds "
        f"{eng.spec_rounds} = {expected}); verify kernel launches: {verify} (n_layers "
        f"{art.layers} x spec rounds = {expected_verify}); chunks {eng.chunks}, admitted "
        f"{eng.admitted}, mean lanes per plain decode step "
        f"{eng.lane_steps / max(1, eng.decode_steps):.2f} (warm-up request included)")
    if launches != expected or launches == 0 or verify != expected_verify:
        raise AssertionError(f"[{name}] launches paged {launches} / verify {verify} != "
                             f"{expected} / {expected_verify}")
    if draft_layers and not verify:
        raise AssertionError(f"[{name}] no speculative round ran")
    if warm[0] != 200:
        raise AssertionError(f"[{name}] warm-up :generate answered {warm[0]}: {warm[1]}")
    greedy = []
    worst = 0.0
    for p, (status, body, _dt) in zip(prompts, results):
        if status != 200:
            raise AssertionError(f"[{name}] :generate answered {status}: {body}")
        toks = np.asarray(body["tokens"])
        if toks.shape != (1, n_new) or not ((toks >= 0) & (toks < art.vocab)).all():
            raise AssertionError(f"[{name}] tokens {toks.shape}, in vocab "
                                 f"{bool(((toks >= 0) & (toks < art.vocab)).all())}")
        greedy.append(toks[0])
        worst = max(worst, _check_greedy(art, p, toks[0], tol, name))
    st = node.runtime._slot_states[art.model_id]
    for s in (st, st.spec_draft) if draft_layers else (st,):
        s.check_page_conservation()
        if sorted(s.free_pages) != list(range(1, s.arena_pages + 1)):
            raise AssertionError(f"[{name}] pages of {s.model_id} still held after the drain")
    lat = [dt for *_, dt in results]
    log(f"  [{name}] {len(prompts)} requests x {n_new} tokens from {GEN_CLIENTS} clients: "
        f"wall {wall * 1e3:.1f} ms, {len(prompts) * n_new / wall:.1f} generated tok/s, "
        f"per-request p50 {statistics.median(lat) * 1e3:.1f} ms (host clock, localhost HTTP); "
        f"cold first request {cold_s * 1e3:.1f} ms; teacher-forced max gap to the plain "
        f"path's max logit {worst:.4f} (tolerance {tol}); census green, "
        f"{st.arena_pages} pages free ({st.arena_dtype or 'model dtype'} arena, "
        f"{(st.k.nbytes + st.v.nbytes + sum(t.nbytes for t in (st.scales or {}).values())) / 2**30:.2f} GiB)")
    if draft_layers:
        lane_rounds = eng.drafted / spec
        per_round = eng.accepted / max(1.0, lane_rounds)
        log(f"  [{name}] spec rounds {eng.spec_rounds} (lane-rounds {lane_rounds:.0f}), "
            f"{per_round:.3f} tokens emitted per lane-round (spec {spec}: at most {spec + 1}), "
            f"plain decode steps {eng.decode_steps}; draft census green "
            f"({st.spec_draft.arena_pages} pages)")
    if top1_res is not None:
        status, body, _dt = top1_res
        if status != 200:
            raise AssertionError(f"[{name}] top_k=1 :generate answered {status}: {body}")
        t1 = np.asarray(body["tokens"])[0]
        diff = np.nonzero(t1 != greedy[0])[0]
        if diff.size:
            # only an exact tie at the top lets a top_k=1 draw leave greedy
            j = int(diff[0])
            logits = _teacher_forced_logits(art.plain_model, prompts[0], greedy[0])[j]
            top = logits.max()
            if not (top - logits[t1[j]] <= tol and top - logits[greedy[0][j]] <= tol):
                raise AssertionError(f"[{name}] top_k=1 left greedy at token {j} off a near-tie")
            log(f"  [{name}] top_k=1 at t=0.8 equals greedy up to token {j}, a near-tie")
        else:
            log(f"  [{name}] top_k=1 at t=0.8 equals greedy ({n_new} tokens)")
    if draft_layers:
        _spec_round_breakdown(node.runtime, art.model_id, art.layers)
    else:
        _decode_chunk_breakdown(node.runtime, art.model_id, art.layers)
    return node, url, launches, verify, greedy


def _compare_to_plain_arm(art, name, prompts, plain, spec_toks, tol) -> None:
    """Spec-on tokens against the plain arm's: identical up to a first
    divergence, where the shared prefix's teacher-forced logits must make
    both tokens a near-tie (each within ``tol`` of the step's max)."""
    import numpy as np

    same = 0
    for p, a, b in zip(prompts, plain, spec_toks):
        diff = np.nonzero(a != b)[0]
        if not diff.size:
            same += 1
            continue
        j = int(diff[0])
        logits = _teacher_forced_logits(art.plain_model, p, a)[j]
        top = logits.max()
        if not (top - logits[a[j]] <= tol and top - logits[b[j]] <= tol):
            raise AssertionError(f"[{name}] leaves the plain arm's tokens at {j} off a near-tie")
    log(f"  [{name}] tokens identical to the plain arm's in {same} of {len(prompts)} "
        "requests; every divergence starts at a near-tie of the plain path")


def phase_generate(art: Artifact, seed: int, kernels: dict) -> None:
    """REST :generate: (a) continuous engine over a bf16 arena, (b) the solo
    path, (c) continuous engine over an int8 arena, (d) (a) with speculative
    rounds drafted by an exact copy of the target, (e) (c) with rounds
    drafted by the 1-layer draft, (f) two solo "draft_model" requests, (g)
    (d) over an int8 arena on the first SPEC_INT8_REQUESTS prompts."""
    import numpy as np

    from tfservingcache_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 2)
    lo, hi = GEN_PROMPT_RANGE
    prompts = [rng.integers(0, art.vocab, int(n)) for n in rng.integers(lo, hi + 1, GEN_REQUESTS)]
    log(f"prompt lengths {[len(p) for p in prompts]}, {GEN_NEW_TOKENS} new tokens each")
    node = None
    launches = verify = 0
    try:
        node, url, n, v, plain_greedy = _continuous_arm(art, "a: bf16 arena", {}, prompts,
                                                        LOGITS_TOL, top1=True)
        launches += n
        verify += v
        # (b) the solo path: seeded requests bypass the engine
        body = {"input_ids": [prompts[1].tolist()], "max_new_tokens": GEN_NEW_TOKENS,
                "temperature": 0.8, "top_k": 40, "seed": 7}
        A.PAGED_LAUNCHES.reset()
        solo = [_post(url, body, 900.0) for _ in range(2)]
        solo_launches = A.PAGED_LAUNCHES.value
        for status, out, _dt in solo:
            if status != 200:
                raise AssertionError(f"[b: solo] :generate answered {status}: {out}")
        a, b = (np.asarray(out["tokens"]) for _s, out, _dt in solo)
        if a.shape != (1, GEN_NEW_TOKENS) or not (a == b).all():
            raise AssertionError("[b: solo] the same seed gave other tokens")
        if solo_launches != 0:
            raise AssertionError(f"[b: solo] the paged kernel ran {solo_launches} times")
        logits = _teacher_forced_logits(art.plain_model, prompts[1], a[0])
        kth = np.sort(logits, axis=-1)[:, -40]
        gap = float((kth - logits[np.arange(GEN_NEW_TOKENS), a[0]]).max())
        if not gap <= LOGITS_TOL:
            raise AssertionError(f"[b: solo] a sampled token is {gap} below its step's top-40")
        log(f"  [b: solo] 2 seeded requests (t=0.8, top_k=40, seed=7): identical; every token "
            f"in its step's top-40 of the plain path (largest shortfall {max(gap, 0.0):.4f}, "
            f"tolerance {LOGITS_TOL}); {solo[0][2] * 1e3:.1f} / {solo[1][2] * 1e3:.1f} ms; "
            f"paged kernel launches {solo_launches}")
        node.close()
        node = None
        node, _url, n, v, int8_greedy = _continuous_arm(
            art, "c: int8 arena", {"kv_arena_dtype": "int8"}, prompts, LOGITS_TOL_INT8,
            top1=False)
        launches += n
        verify += v
        node.close()
        node = None
        # (d) speculative rounds drafted by an exact copy of the target: every
        # proposal should be accepted, up to bf16 near-ties between the
        # draft's width-1 and the target's width-(spec+1) forwards
        name = "d: spec, exact-copy draft"
        node, _url, n, v, spec_greedy = _continuous_arm(
            art, name, {"spec_draft_model": "copy", "spec_tokens": SPEC_TOKENS}, prompts,
            LOGITS_TOL, top1=False, draft_layers=art.layers)
        launches += n
        verify += v
        eng = node.engine
        per_round = eng.accepted / max(1.0, eng.drafted / SPEC_TOKENS)
        if not per_round >= 0.8 * (SPEC_TOKENS + 1):
            raise AssertionError(f"[{name}] {per_round:.3f} tokens per lane-round < "
                                 f"0.8 x (spec + 1) = {0.8 * (SPEC_TOKENS + 1)}")
        _compare_to_plain_arm(art, name, prompts, plain_greedy, spec_greedy, LOGITS_TOL)
        node.close()
        node = None
        # (e) the int8 arena with the 1-layer draft (acceptance reported as is)
        node, _url, n, v, _g = _continuous_arm(
            art, "e: spec, 1-layer draft, int8 arena",
            {"kv_arena_dtype": "int8", "spec_draft_model": "layer0", "spec_tokens": SPEC_TOKENS},
            prompts, LOGITS_TOL_INT8, top1=False, draft_layers=art.draft_layers)
        launches += n
        verify += v
        node.close()
        node = None
        node = _solo_draft_arm(art, prompts)
        node.close()
        node = None
        # (g) the exact-copy draft over an int8 arena: accepted rows of B3
        # over int8 pages decide served tokens under the teacher-forced check
        name = "g: spec, exact-copy draft, int8 arena"
        few = prompts[:SPEC_INT8_REQUESTS]
        node, _url, n, v, spec8_greedy = _continuous_arm(
            art, name,
            {"kv_arena_dtype": "int8", "spec_draft_model": "copy", "spec_tokens": SPEC_TOKENS},
            few, LOGITS_TOL_INT8, top1=False, draft_layers=art.layers)
        launches += n
        verify += v
        eng = node.engine
        per_round = eng.accepted / max(1.0, eng.drafted / SPEC_TOKENS)
        if not per_round >= 0.8 * (SPEC_TOKENS + 1):
            raise AssertionError(f"[{name}] {per_round:.3f} tokens per lane-round < "
                                 f"0.8 x (spec + 1) = {0.8 * (SPEC_TOKENS + 1)}")
        _compare_to_plain_arm(art, name, few, int8_greedy, spec8_greedy, LOGITS_TOL_INT8)
    finally:
        if node is not None:
            node.close()
    kernels["paged_decode_attention"]["launches"] = launches
    kernels["paged_verify_attention"]["launches"] = verify


def _solo_draft_arm(art, prompts):
    """(f) two solo "draft_model" requests with the 1-layer draft on a fresh
    continuous node: greedy tokens checked against the plain path, identical
    to each other; the engine's counters and the paged kernels' launches
    must not move (the solo path runs dense caches, no kernel). -> the
    node."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    name = "f: solo draft_model"
    cfg = config_from_dict(art.node_config(
        name, generate_engine="continuous", generate_slots=8, kv_page_tokens=16))
    node = build_node(cfg, device="cuda")
    url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/llama7b/versions/1:generate"
    body = {"input_ids": [prompts[2].tolist()], "max_new_tokens": GEN_NEW_TOKENS,
            "draft_model": "layer0", "spec_tokens": SPEC_TOKENS}
    eng, rt = node.engine, node.runtime
    before = (eng.admitted, eng.chunks, eng.spec_rounds, eng.decode_steps)
    A.PAGED_LAUNCHES.reset()
    A.VERIFY_LAUNCHES.reset()
    res = [_post(url, body, 900.0) for _ in range(2)]
    paged, verify = A.PAGED_LAUNCHES.value, A.VERIFY_LAUNCHES.value
    after = (eng.admitted, eng.chunks, eng.spec_rounds, eng.decode_steps)
    for status, out, _dt in res:
        if status != 200:
            raise AssertionError(f"[{name}] :generate answered {status}: {out}")
    a, b = (np.asarray(out["tokens"]) for _s, out, _dt in res)
    if a.shape != (1, GEN_NEW_TOKENS) or not (a == b).all():
        raise AssertionError(f"[{name}] two greedy requests gave other tokens")
    worst = _check_greedy(art, prompts[2], a[0], LOGITS_TOL, name)
    if after != before or paged or verify:
        raise AssertionError(f"[{name}] the engine path moved: counters {before} -> {after}, "
                             f"paged {paged}, verify {verify} launches")
    rounds, emitted = rt.spec_rounds["solo"], rt.spec_emitted["solo"]
    if not rounds:
        raise AssertionError(f"[{name}] no speculative round ran")
    log(f"  [{name}] 2 greedy requests with the 1-layer draft (spec {SPEC_TOKENS}): identical; "
        f"teacher-forced max gap {worst:.4f} (tolerance {LOGITS_TOL}); {rounds} rounds, "
        f"{emitted / rounds:.3f} tokens a round; {res[0][2] * 1e3:.1f} / {res[1][2] * 1e3:.1f} "
        f"ms; engine counters and paged/verify launches unchanged ({paged}, {verify})")
    return node


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    depth = parser.add_mutually_exclusive_group()
    depth.add_argument("--layers", type=int, default=4,
                       help="transformer layers of the served model (default 4, ~1.9 GB bf16)")
    depth.add_argument("--full-depth", action="store_true",
                       help="serve all 32 layers (~13.5 GB bf16)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--warm", type=int, default=5, help="warm requests per shape")
    args = parser.parse_args(argv)
    layers = 32 if args.full_depth else args.layers

    # the pre-chunk trash-page assertion, read when the runtime is imported
    os.environ["TPUSC_PAGECHECK"] = "1"
    with Phase("environment"):
        phase_environment()
    sys.path.insert(0, ROOT)
    if importlib.util.find_spec("tfservingcache_tpu_torch") is None:
        raise SystemExit(f"chip_smoke: tfservingcache_tpu_torch not found next to {__file__}; "
                         "run it from a checkout of the repo")
    import torch

    with Phase("build"):
        sass = phase_build()
    with Phase("kernels"):
        kernels = phase_kernels(args.seed)
        kernels["flash_attention"]["sass"] = sass["flash_attention"]
        kernels.update(phase_paged_kernel(args.seed))
        kernels.update(phase_verify_kernel(args.seed))
        for name in ("paged_decode_attention", "paged_verify_attention"):
            kernels[name]["sass"] = sass["paged_attention"]
        kernels.update(phase_carry_kernel(args.seed))
        kernels["flash_attention_carry"]["sass"] = sass["flash_attention_carry"]
    with Phase("artifact"):
        art = Artifact(layers, args.seed)
    try:
        with Phase("serve"):
            phase_serve(art, args.seed, args.warm, kernels)
        with Phase("generate"):
            phase_generate(art, args.seed, kernels)
        with Phase("ring"):
            phase_ring(art, args.seed, args.warm, kernels)
    finally:
        art.close()

    log(nvidia_smi_line())
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": CARDS_USED,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
