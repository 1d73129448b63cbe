#!/usr/bin/env python3
"""Host time of one warm decode chunk through the port's runtime on one card.

``write ART_DIR`` writes the 4-layer random-weight artifact at llama-7b width
(``LLAMA7B_CONFIG``, bf16, seed 0) that ``time`` loads.

``time ROOT ART_DIR MODE [--ops]`` imports the port from the checkout at
ROOT, loads the artifact on one card (MODE ``one``; ``one8`` with an int8
arena) or on the group ``[cuda:0] * 2`` (``tp``, ``tp8``), takes a paged
slot state of 8 slots (pages of 16), puts every lane at 600 tokens and
times ``slot_decode_chunk(state, 8)`` (8 steps, ending in a device-to-host
copy): 3 warm-up chunks, then the median, min and max of 7 on the host
clock. ``--ops`` then profiles one chunk's host side (``torch.profiler``,
CPU activity) and prints the ops with the most self CPU time and their
counts, ``cudaLaunchKernel`` among them.

Compare two checkouts only within one run on one card, in turns, e.g. the
parent unpacked beside the change:

    mkdir -p _verify/parent && git archive HEAD | tar -x -C _verify/parent
    python3 tools/decode_chunk_ab.py write /tmp/ab_art
    for r in _verify/parent . . _verify/parent; do
        python3 tools/decode_chunk_ab.py time $r /tmp/ab_art one; done
    for m in one one8 tp tp8; do python3 tools/decode_chunk_ab.py time . /tmp/ab_art $m --ops; done
"""

from __future__ import annotations

import os
import statistics
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write(art_dir: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.models.transformer_lm import LLAMA7B_CONFIG

    model_def = registry.build("transformer_lm", dict(LLAMA7B_CONFIG, n_layers=4))
    params = model_def.init(torch.Generator(device="cuda").manual_seed(0))

    def bf16(tree):
        if isinstance(tree, dict):
            return {k: bf16(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [bf16(v) for v in tree]
        return tree.to(torch.bfloat16)

    registry.save_artifact(os.path.join(art_dir, "llama7b", "1"), model_def, bf16(params))
    print("artifact written", flush=True)


def time_chunk(root: str, art_dir: str, mode: str, ops: bool) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from tfservingcache_tpu_torch.config import ServingConfig
    from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
    from tfservingcache_tpu_torch.types import Model, ModelId

    mid = ModelId("llama7b", 1)
    cfg = ServingConfig(kv_page_tokens=16, kv_arena_dtype="int8" if mode.endswith("8") else "")
    if mode.startswith("tp"):
        rt = TorchModelRuntime(cfg, devices=["cuda:0"] * 2)
    else:
        rt = TorchModelRuntime(cfg, device="cuda")
    try:
        rt.ensure_loaded(Model(identifier=mid, path=os.path.join(art_dir, "llama7b", "1")))
        st = rt.slot_decode_state(mid, 8)
        for lane in range(8):
            if not st.reserve_pages(lane, 664):
                raise SystemExit("arena too small")
            st.pos[lane], st.tok[lane], st.active[lane] = 600, 1, True

        def chunk():
            rt.slot_decode_chunk(st, 8)

        for _ in range(3):
            chunk()
        times = []
        for _ in range(7):
            t0 = time.monotonic()
            chunk()
            times.append((time.monotonic() - t0) * 1e3)
        print(f"[{root} {mode}] warm decode chunk host ms: median {statistics.median(times):.2f} "
              f"(min {min(times):.2f}, max {max(times):.2f})", flush=True)
        if ops:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]) as prof:
                chunk()
            rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)[:18]
            total = sum(r.self_cpu_time_total for r in prof.key_averages()) / 1e3
            print(f"[{mode}] host ops of one chunk, self CPU ms total {total:.2f}:")
            for r in rows:
                print(f"    {r.self_cpu_time_total / 1e3:8.2f} ms  {r.count:6d}x  {r.key[:70]}")
    finally:
        rt.close()


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "write":
        write(argv[1])
        return 0
    if len(argv) >= 4 and argv[0] == "time" and argv[3] in ("one", "one8", "tp", "tp8"):
        time_chunk(argv[1], argv[2], argv[3], "--ops" in argv[4:])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
