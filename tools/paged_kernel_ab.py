#!/usr/bin/env python3
"""Compare builds of the port's paged-attention source on one card.

Builds every given ``paged_attention.cu`` with the port's nvcc flags (a
source given as ``FILE:NAME=VALUE`` is built with that macro, e.g.
``TPUSC_PAGED_LOADS_ONLY=1``, the source's ablation that skips the math),
loads the libraries side by side in one process and calls each through its
own C signature: a source whose ``tpusc_paged_attention`` takes the split
scratch (``part_ml``) gets the page-axis split that
``ops.attention.paged_launch_plan`` chooses for the port's own build and
scratch allocated once a row; an earlier source gets its shorter argument
list. At every ``chip_smoke.PAGED_SHAPES`` row (the decode kernel,
B1: bf16 and int8 arenas, and f32 at the first row) and every
``chip_smoke.VERIFY_SHAPES`` row with its arenas (the verify kernel, B3):
  - the max |diff| of each build to the plain version
    (``paged_verify_attention`` on the same, dequantized, pages) and to the
    first build, and whether the two are bit for bit equal;
  - each build's time in turns, first to last then last to first (CUDA
    events, median of 25 launches, ``chip_smoke.cuda_ms``), so that two
    versions are compared only within one run on one card;
  - each build's ptxas registers and spills for every kernel.

Run on a machine with the card, from the root of a checkout, e.g. against
an earlier commit:

    git show <commit>:tfservingcache_tpu_torch/ops/csrc/paged_attention.cu > old_paged.cu
    python3 tools/paged_kernel_ab.py old_paged.cu tfservingcache_tpu_torch/ops/csrc/paged_attention.cu

or the kernel against its own loads-only ablation:

    SRC=tfservingcache_tpu_torch/ops/csrc/paged_attention.cu
    python3 tools/paged_kernel_ab.py $SRC $SRC:TPUSC_PAGED_LOADS_ONLY=1
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bind(libs: dict[str, ctypes.CDLL], sources: list[str]) -> dict[str, tuple[ctypes.CDLL, bool]]:
    """Set each library's C signature. -> {label: (library, takes the split)}."""
    p, i = ctypes.c_void_p, ctypes.c_int
    bound = {}
    for (label, lib), src in zip(libs.items(), sources):
        with open(src) as f:
            split = "part_ml" in f.read()
        fn = lib.tpusc_paged_attention
        fn.argtypes = [p] * 10 + [i] * 13 + [p] if split else [p] * 8 + [i] * 11 + [p]
        fn.restype = i
        bound[label] = (lib, split)
    return bound


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+",
                        help="paged_attention.cu files to compare, each FILE or FILE:NAME=VALUE")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch

    from chip_smoke import (PAGED_MAIN, PAGED_SHAPES, VERIFY_SHAPES, _paged_arena, cuda_ms,
                            nvidia_smi_line)
    from flash_kernel_ab import compile_all, parse_sources
    from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows
    from tfservingcache_tpu_torch.ops import _build
    from tfservingcache_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("paged_kernel_ab: no CUDA device")
    print(nvidia_smi_line(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)  # gitignored build outputs
    files, defines = parse_sources(args.sources)
    workdir = tempfile.mkdtemp(prefix="paged_ab_", dir=_build.BUILD_DIR)
    libs = bind(compile_all(files, workdir, defines), files)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(5)
    cgen = torch.Generator(device="cuda").manual_seed(5)

    rows = [((lanes, hq, hkv, d, pt, max_pos, 1),
             ("bfloat16", "int8") + (("float32",) if shape == PAGED_MAIN else ()), False, False)
            for shape in PAGED_SHAPES for (lanes, hq, hkv, d, pt, max_pos) in [shape]]
    rows += [((lanes, hq, hkv, d, pt, max_pos, t_q), arenas, overrun, True)
             for (lanes, hq, hkv, d, pt, max_pos, t_q, arenas, overrun) in VERIFY_SHAPES]
    for (lanes, hq, hkv, d, pt, max_pos, t_q), arenas, overrun, verify in rows:
        kp32, vp32, tables_h, pos_h = _paged_arena(gen, cgen, lanes, hkv, d, pt, max_pos,
                                                   t_q=t_q, overrun=overrun)
        q32 = torch.randn(lanes, hq, t_q, d, generator=cgen, device="cuda")
        tables, pos = tables_h.cuda(), pos_h.cuda()
        pps, n_pages = tables.shape[1], kp32.shape[0]
        for arena in arenas:
            ks = vs = None
            if arena == "int8":
                q = q32.bfloat16()
                kp, ks = _quantize_kv_rows(kp32)
                vp, vs = _quantize_kv_rows(vp32)
                plain_k, plain_v = A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs)
            else:
                dt = getattr(torch, arena)
                q, kp, vp = q32.to(dt), kp32.to(dt), vp32.to(dt)
                plain_k, plain_v = kp, vp
            plain = A.paged_verify_attention(q, plain_k, plain_v, tables, pos, pt)
            plan = A.paged_launch_plan(q, kp, tables)
            n_splits, per = plan["n_splits"], plan["pages_per_split"]
            part_ml = torch.empty(lanes * hq * t_q, n_splits, 2, device="cuda")
            part_acc = torch.empty(lanes * hq * t_q, n_splits, d, device="cuda")
            out = torch.empty(lanes, hq, t_q, d, device="cuda")
            head = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    ks.data_ptr() if ks is not None else None,
                    vs.data_ptr() if vs is not None else None,
                    tables.data_ptr(), pos.data_ptr(), out.data_ptr()]
            types = [A._PAGED_Q_TYPES[q.dtype], A._PAGED_KV_TYPES[kp.dtype], t_q, int(verify)]

            def launch(label):
                lib, split = libs[label]
                if split:
                    rc = lib.tpusc_paged_attention(
                        *head, part_ml.data_ptr(), part_acc.data_ptr(),
                        lanes, hq, hkv, d, pt, pps, n_pages, *types, n_splits, per, stream)
                else:
                    rc = lib.tpusc_paged_attention(*head, lanes, hq, hkv, d, pt, pps, n_pages,
                                                   *types, stream)
                assert rc == 0, (label, rc)

            outs = {}
            for label in libs:
                launch(label)
                torch.cuda.synchronize()
                outs[label] = out.clone()
            first = next(iter(outs.values()))
            checks = "; ".join(
                f"{lb} to plain {(o - plain).abs().max().item():.4g}, to the first "
                f"{(o - first).abs().max().item():.4g} (bitwise {torch.equal(o, first)})"
                for lb, o in outs.items())
            labels = list(libs)
            times = [(lb, cuda_ms(lambda lb=lb: launch(lb))) for lb in labels + labels[::-1]]
            kernel = "B3" if verify else "B1"
            print(f"{kernel} S={lanes} Hq={hq} Hkv={hkv} D={d} pt={pt} max_pos={max_pos} "
                  f"T={t_q}{' (lane 0 past its table)' if overrun else ''} {arena} "
                  f"splits={n_splits}x{per}: {checks}; in turns: "
                  + ", ".join(f"{lb} {t:.4f} ms" for lb, t in times), flush=True)
            del outs, first, plain, out, part_ml, part_acc, kp, vp, plain_k, plain_v
        del kp32, vp32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
