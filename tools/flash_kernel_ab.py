#!/usr/bin/env python3
"""Compare builds of the port's flash-attention source on one card.

Builds every given ``flash_attention.cu`` with the port's nvcc flags, loads
the libraries side by side in one process and, for the flash kernel (B2) at
every ``chip_smoke.KERNEL_SHAPES`` row in bf16 and ``KERNEL_SHAPES_F32`` in
f32, causal and not, and, where a source has it, the carry kernel (B4) at
every ``B4_CASES`` hop from one carried state:
  - checks each build's output against the first build's, bit for bit, and
    prints the max |diff| to it and, for B2, to ``attention_reference``;
  - times each build in turns, first to last then last to first (CUDA
    events, median of 25 launches, chip_smoke.cuda_ms), so that two
    versions are compared only within one run on one card (a B4 hop is
    timed on a scratch carry that each launch updates in place, without
    the reset that the bitwise check does);
  - for bf16 B2, the host time of one call of the C entry (ctypes included,
    no sync: what a forward pays on the host for each launch);
  - prints each build's ptxas registers and spills for every kernel.

Run on a machine with the card, from the root of a checkout, e.g. against
an earlier commit:

    git show <commit>:tfservingcache_tpu_torch/ops/csrc/flash_attention.cu > old_flash.cu
    python3 tools/flash_kernel_ab.py old_flash.cu tfservingcache_tpu_torch/ops/csrc/flash_attention.cu

A source may carry one macro definition, ``FILE:NAME=VALUE``: e.g.
``SRC:TPUSC_CARRY_LOADS_ONLY=1`` builds B4's loads-only ablation beside
``SRC``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# B4 hops (B, Hq, Hkv, Sq, Sk, D), dtype, rel: the ring phase's hop
# (chip_smoke.CARRY_MAIN) as a past block, the diagonal and a future block,
# the GQA row, and f32 at rel 0 and a past block
B4_CASES = [
    ((1, 32, 32, 1024, 1024, 128), "bfloat16", -1024),
    ((1, 32, 32, 1024, 1024, 128), "bfloat16", 0),
    ((1, 32, 32, 1024, 1024, 128), "bfloat16", 1024),
    ((1, 32, 8, 1024, 1024, 128), "bfloat16", 0),
    ((1, 8, 8, 256, 256, 128), "float32", 0),
    ((1, 8, 8, 256, 256, 128), "float32", -256),
]


def compile_all(sources: list[str], workdir: str,
                defines: list[list[str]] | None = None) -> dict[str, ctypes.CDLL]:
    """One nvcc per source with the port's flags (and, per source, the
    given ``NAME=VALUE`` macro definitions), all started together; prints
    each build's ptxas registers, spills and warnings per kernel.
    -> {label: loaded library}."""
    from tfservingcache_tpu_torch.ops import _build

    defines = defines or [[] for _ in sources]
    procs = {}
    for n, (src, defs) in enumerate(zip(sources, defines)):
        label = f"{n}:{os.path.basename(src)}" + "".join(f"[{d}]" for d in defs)
        out = os.path.join(workdir, f"lib{n}.so")
        procs[label] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defs), "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for label, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {label}:\n{log}")
        lines = log.splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                regs = next((x.strip() for x in lines[k + 1:k + 4] if "Used" in x), "")
                spill = next((x.strip() for x in lines[k + 1:k + 4] if "spill" in x), "")
                print(f"{label} ptxas {name}: {regs}; {spill}")
            elif "warning" in line:
                print(f"{label} {line.strip()}")
        libs[label] = ctypes.CDLL(out)
    return libs


def parse_sources(specs: list[str]) -> tuple[list[str], list[list[str]]]:
    """``FILE[:NAME=VALUE]`` specs -> (files, macro definitions per file)."""
    files, defines = [], []
    for spec in specs:
        path, _, define = spec.partition(":")
        files.append(path)
        defines.append([define] if define else [])
    return files, defines


def build(specs: list[str], workdir: str) -> dict[str, ctypes.CDLL]:
    """``compile_all`` of ``FILE[:NAME=VALUE]`` specs with the flash entry
    points' C signatures set."""
    files, defines = parse_sources(specs)
    libs = compile_all(files, workdir, defines)
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        for fn in (lib.tpusc_flash_attention_fwd, lib.tpusc_flash_attention_fwd_f32):
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        if hasattr(lib, "tpusc_flash_attention_carry"):
            lib.tpusc_flash_attention_carry.argtypes = [p] * 6 + [i] * 8 + [p]
            lib.tpusc_flash_attention_carry.restype = i
    return libs


def compare(libs: dict[str, ctypes.CDLL], run, what: str, ref=None, timed=None) -> None:
    """``run(lib)`` launches once and returns its outputs; checks every
    library's against the first's (and its first output against ``ref``)
    and times ``timed(lib)`` (default ``run``) for all of them in turns."""
    import torch

    from chip_smoke import cuda_ms

    labels = list(libs)
    outs = {lb: run(libs[lb]) for lb in labels}
    torch.cuda.synchronize()
    first = outs[labels[0]]
    checks = []
    for lb in labels:
        equal = all(torch.equal(a, b) for a, b in zip(outs[lb], first))
        diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs[lb], first))
        line = f"{lb} bitwise equal {equal}, max |diff| {diff:.4g}"
        if ref is not None:
            line += f", to attention_reference {(outs[lb][0].float() - ref.float()).abs().max().item():.4g}"
        checks.append(line)
    del outs, first
    timed = timed or run
    times = [(lb, cuda_ms(lambda: timed(libs[lb]))) for lb in labels + labels[::-1]]
    print(f"{what}: against {labels[0]}: " + "; ".join(checks) + "; in turns: "
          + ", ".join(f"{lb} {t:.4f} ms" for lb, t in times), flush=True)


def host_us(libs: dict[str, ctypes.CDLL], call, reps: int = 200) -> str:
    """Host microseconds of one ``call(lib)`` (launch only, no sync), in
    turns."""
    import time

    import torch

    res = []
    for lb in list(libs) + list(libs)[::-1]:
        call(libs[lb])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call(libs[lb])
        res.append(f"{lb} {(time.perf_counter() - t0) / reps * 1e6:.1f} us")
        torch.cuda.synchronize()
    return ", ".join(res)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+",
                        help="flash_attention.cu files to compare, each FILE[:NAME=VALUE]")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import KERNEL_SHAPES, KERNEL_SHAPES_F32, nvidia_smi_line
    from tfservingcache_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention_carry_reference,
    )

    if not torch.cuda.is_available():
        raise SystemExit("flash_kernel_ab: no CUDA device")
    print(nvidia_smi_line(), flush=True)
    from tfservingcache_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)  # gitignored build outputs
    libs = build(args.sources, tempfile.mkdtemp(prefix="flash_ab_", dir=_build.BUILD_DIR))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    b2_cases = ([(shape, "bfloat16", c) for shape in KERNEL_SHAPES for c in (True, False)]
                + [(shape, "float32", c) for shape in KERNEL_SHAPES_F32 for c in (True, False)])
    for (b, hq, hkv, s, d), dt, causal in b2_cases:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, n, s, d, device="cuda", generator=gen).to(dtype)
                   for n in (hq, hkv, hkv))
        o = torch.empty_like(q)

        def launch(lib):
            fn = lib.tpusc_flash_attention_fwd if dt == "bfloat16" else lib.tpusc_flash_attention_fwd_f32
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv, s, d,
                    int(causal), stream)
            assert rc == 0, rc

        def fwd(lib):
            launch(lib)
            return (o.clone(),)

        what = f"B2 {(b, hq, hkv, s, d)} {dt} causal={causal}"
        compare(libs, fwd, what, ref=attention_reference(q, k, v, causal), timed=launch)
        if dt == "bfloat16" and causal:
            print(f"{what}: host time of one call: {host_us(libs, launch)}", flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    carry_libs = {lb: lib for lb, lib in libs.items() if hasattr(lib, "tpusc_flash_attention_carry")}
    for (b, h, hkv, sq, sk, d), dt, rel in B4_CASES if carry_libs else ():
        dtype = getattr(torch, dt)
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
        k, v, k0, v0 = (torch.randn(b, hkv, sk, d, device="cuda", generator=gen).to(dtype)
                        for _ in range(4))
        empty = (torch.zeros(b, h, sq, d, device="cuda"),
                 torch.full((b, h, sq, 1), -1e30, device="cuda"),
                 torch.zeros(b, h, sq, 1, device="cuda"))
        # the carried state: a hop over an earlier block every row sees
        carry = flash_attention_carry_reference(q, k0, v0, *empty, -sk)
        io = [t.clone() for t in carry]
        scratch = [t.clone() for t in carry]

        def launch(lib, tensors=scratch):
            acc, m, l = tensors
            rc = lib.tpusc_flash_attention_carry(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), b, h, hkv, sq, sk, d, rel, int(dt == "float32"), stream)
            assert rc == 0, rc

        def hop(lib):
            for t, c in zip(io, carry):
                t.copy_(c)
            launch(lib, io)
            return tuple(t.clone() for t in io)

        compare(carry_libs, hop, f"B4 {(b, h, hkv, sq, sk, d)} {dt} rel {rel}", timed=launch)
        del q, k, v, k0, v0, empty, carry, io, scratch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
