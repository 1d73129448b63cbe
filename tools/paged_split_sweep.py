#!/usr/bin/env python3
"""Time the paged kernels (B1, B3) under every page-axis split on one card.

At each row below (lanes, Hq, Hkv, D, page_tokens, max_pos, T, arena) the
port's own kernel runs through ``ops.attention._paged_kernel(...,
splits=n)`` for n in ``SPLITS``, timed in turns (first to last, then last
to first: CUDA events, median of 25 calls, ``chip_smoke.cuda_ms``). Each
line gives every split's two times, the best split, and the split
``ops.attention.paged_launch_plan`` chooses with its time over the best.
The rows are the decode step and the spec round at llama-7b width at 1 to
8 lanes (the engine's occupancy), the same at a long context, and GQA
g = 4; lanes' positions as ``chip_smoke._paged_arena`` draws them (lane 0
at max_pos, the others uniform in [max_pos / 4, max_pos]).

Run on a machine with the card, from the root of a checkout:

    python3 tools/paged_split_sweep.py
"""

from __future__ import annotations

import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (1, 2, 3, 4, 6, 8)


def rows() -> list[tuple]:
    out = []
    for arena in ("bfloat16", "int8"):
        for t_q in (1, 5):
            out += [(lanes, 32, 32, 128, 16, 1088, t_q, arena) for lanes in (1, 2, 4, 6, 8)]
            out += [(lanes, 32, 32, 128, 16, 4095, t_q, arena) for lanes in (1, 2, 4)]
            out += [(lanes, 32, 8, 128, 16, 2047, t_q, arena) for lanes in (1, 2, 4, 8, 16)]
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import _paged_arena, cuda_ms, nvidia_smi_line
    from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows
    from tfservingcache_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("paged_split_sweep: no CUDA device")
    print(nvidia_smi_line(), flush=True)
    print(f"SPLIT_BLOCKS_PER_SM={A.SPLIT_BLOCKS_PER_SM} SPLIT_MIN_KEYS={A.SPLIT_MIN_KEYS}",
          flush=True)
    gen = torch.Generator().manual_seed(7)
    cgen = torch.Generator(device="cuda").manual_seed(7)
    for lanes, hq, hkv, d, pt, max_pos, t_q, arena in rows():
        kp32, vp32, tables_h, pos_h = _paged_arena(gen, cgen, lanes, hkv, d, pt, max_pos, t_q=t_q)
        q = torch.randn(lanes, hq, t_q, d, generator=cgen, device="cuda").bfloat16()
        tables, pos = tables_h.cuda(), pos_h.cuda()
        ks = vs = None
        if arena == "int8":
            kp, ks = _quantize_kv_rows(kp32)
            vp, vs = _quantize_kv_rows(vp32)
        else:
            kp, vp = kp32.bfloat16(), vp32.bfloat16()
        pps = tables.shape[1]
        splits = [n for n in SPLITS if n <= pps]
        verify = t_q > 1

        def call(n):
            return A._paged_kernel(verify, q, kp, vp, tables, pos, ks, vs, pt, splits=n)

        times = {n: [] for n in splits}
        for n in splits + splits[::-1]:
            times[n].append(cuda_ms(lambda n=n: call(n)))
        mean = {n: statistics.mean(ts) for n, ts in times.items()}
        best = min(mean, key=mean.get)
        plan = A.paged_launch_plan(q, kp, tables)
        chosen = plan["n_splits"]
        chosen_ms = mean.get(chosen)
        if chosen_ms is None:  # a plan outside the sweep: time it in the same way
            chosen_ms = statistics.mean(cuda_ms(lambda: call(chosen)) for _ in range(2))
        blocks = lanes * hkv * -(-(t_q * (hq // hkv)) // plan["row_tile"])
        print(f"S={lanes} Hq={hq} Hkv={hkv} D={d} pt={pt} max_pos={max_pos} T={t_q} {arena} "
              f"(unsplit blocks {blocks}, pos {pos_h.tolist()}): "
              + ", ".join(f"{n}: {ts[0]:.4f}/{ts[1]:.4f}" for n, ts in times.items())
              + f" ms; best {best} ({mean[best]:.4f}); plan {chosen}x{plan['pages_per_split']} "
              f"({chosen_ms:.4f}, {chosen_ms / mean[best]:.3f} of best)", flush=True)
        del kp, vp, kp32, vp32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
