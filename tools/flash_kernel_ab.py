#!/usr/bin/env python3
"""Compare builds of the port's flash-attention source on one card.

Builds every given ``flash_attention.cu`` with the port's nvcc flags, loads
the libraries side by side in one process and, for the flash kernel (B2) at
its serving shapes (bf16 (2,32,32,1024,128) and (1,32,32,4096,128), f32
(1,8,8,256,128), causal) and, where a source has it, the carry kernel (B4;
one bf16 and one f32 hop at rel 0):
  - checks each build's output against the first build's, bit for bit;
  - times each build in turns, first to last then last to first (CUDA
    events, median of 25 launches, chip_smoke.cuda_ms), so that two
    versions are compared only within one run on one card;
  - prints each build's ptxas registers and spills for every kernel.

Run on a machine with the card, from the root of a checkout, e.g. against
an earlier commit:

    git show <commit>:tfservingcache_tpu_torch/ops/csrc/flash_attention.cu > old_flash.cu
    python3 tools/flash_kernel_ab.py old_flash.cu tfservingcache_tpu_torch/ops/csrc/flash_attention.cu
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B2_CASES = [((2, 32, 32, 1024, 128), "bfloat16"), ((1, 32, 32, 4096, 128), "bfloat16"),
            ((1, 8, 8, 256, 128), "float32")]
B4_CASES = [((1, 32, 32, 1024, 128), "bfloat16"), ((1, 8, 8, 256, 128), "float32")]


def build(sources: list[str], workdir: str) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all started together; -> {label: library}."""
    from tfservingcache_tpu_torch.ops import _build

    procs = {}
    for n, src in enumerate(sources):
        label = f"{n}:{os.path.basename(src)}"
        out = os.path.join(workdir, f"lib{n}.so")
        procs[label] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
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
        lib = ctypes.CDLL(out)
        for fn in (lib.tpusc_flash_attention_fwd, lib.tpusc_flash_attention_fwd_f32):
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        if hasattr(lib, "tpusc_flash_attention_carry"):
            lib.tpusc_flash_attention_carry.argtypes = [p] * 6 + [i] * 8 + [p]
            lib.tpusc_flash_attention_carry.restype = i
        libs[label] = lib
    return libs


def compare(libs: dict[str, ctypes.CDLL], run, what: str) -> None:
    """``run(lib)`` launches once and returns its outputs; checks every
    library's against the first's and times all of them in turns."""
    import torch

    from chip_smoke import cuda_ms

    labels = list(libs)
    first = run(libs[labels[0]])
    torch.cuda.synchronize()
    equal = {lb: all(torch.equal(a, b) for a, b in zip(run(libs[lb]), first)) for lb in labels}
    times = [(lb, cuda_ms(lambda: run(libs[lb]))) for lb in labels + labels[::-1]]
    print(f"{what}: outputs equal to {labels[0]}: {equal}; in turns: "
          + ", ".join(f"{lb} {t:.4f} ms" for lb, t in times), flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+", help="flash_attention.cu files to compare")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import nvidia_smi_line

    if not torch.cuda.is_available():
        raise SystemExit("flash_kernel_ab: no CUDA device")
    print(nvidia_smi_line(), flush=True)
    from tfservingcache_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)  # gitignored build outputs
    libs = build(args.sources, tempfile.mkdtemp(prefix="flash_ab_", dir=_build.BUILD_DIR))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for (b, hq, hkv, s, d), dt in B2_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, n, s, d, device="cuda", generator=gen).to(dtype)
                   for n in (hq, hkv, hkv))

        def fwd(lib):
            o = torch.empty_like(q)
            fn = lib.tpusc_flash_attention_fwd if dt == "bfloat16" else lib.tpusc_flash_attention_fwd_f32
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv, s, d, 1,
                    stream)
            assert rc == 0, rc
            return (o,)

        compare(libs, fwd, f"B2 {(b, hq, hkv, s, d)} {dt} causal")
    carry_libs = {lb: lib for lb, lib in libs.items() if hasattr(lib, "tpusc_flash_attention_carry")}
    for (b, h, hkv, s, d), dt in B4_CASES if carry_libs else ():
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, n, s, d, device="cuda", generator=gen).to(dtype)
                   for n in (h, hkv, hkv))
        acc, m, l = (torch.empty(b, h, s, n, device="cuda") for n in (d, 1, 1))

        def hop(lib):
            acc.zero_()
            m.fill_(-1e30)
            l.zero_()
            rc = lib.tpusc_flash_attention_carry(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), b, h, hkv, s, s, d, 0, int(dt == "float32"), stream)
            assert rc == 0, rc
            return acc.clone(), l.clone()

        compare(carry_libs, hop, f"B4 {(b, h, hkv, s, s, d)} {dt} rel 0 (with the carry's reset)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
