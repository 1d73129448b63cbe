#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``tfservingcache_tpu_torch``).

Drives the port's main path on one NVIDIA GPU and checks every kernel on it:

  1. environment — torch/CUDA versions, the card (nvidia-smi), which optional
     packages exist (information only); exits non-zero without a CUDA device
     or outside a checkout of the repo;
  2. build — compiles every kernel in ``tfservingcache_tpu_torch/ops/csrc``
     with nvcc, one process per source, all started together;
  3. kernels — each kernel against its plain PyTorch version on the card at
     the main path's shapes and a few edge shapes, with the stated
     tolerance; CUDA-event times (warm, median), the least time the card
     could take (bound), and one PyTorch library call's time as a yardstick;
  4. serve — writes a random-weight transformer_lm artifact at the full
     llama-7b width (depth cut, see --layers) into a temporary store,
     builds a cache node on ``cuda`` through ``server.build_node`` (what
     ``cli serve`` calls) and sends REST ``:predict`` requests over
     localhost: cold, then warm. Every response is checked (HTTP 200, shape,
     finite, agreement with the plain path on the card), and the kernels'
     launch counters must show the path went through them.

The last three lines of standard output are the card's name and power limit
(nvidia-smi), a JSON object with one entry per kernel, and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
them.

Run from the root of a checkout:  python3 chip_smoke.py [--layers N | --full-depth]
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
# |REST logits - plain-path logits| bound at llama-7b width: logits are
# ~N(0, 1); both paths run bf16 matmuls and differ in attention rounding
# (above) through every layer, 32 bf16 ulps at |x| ~ 1.
LOGITS_TOL = 0.125

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
# :predict request shapes; (1, 300) pads to the 512 bucket
REQUEST_SHAPES = [(1, 128), (2, 1024), (1, 300)]


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


def device_busy_ms(fn) -> float | None:
    """Sum of device kernel time of one ``fn()`` under ``torch.profiler``
    (None when the profiler records no device time on this machine)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    total_us = 0.0
    for row in prof.key_averages():  # kernel rows only: CPU ops would double-count
        if row.device_type == torch.autograd.DeviceType.CUDA:
            total_us += row.self_device_time_total
    return total_us / 1e3 if total_us > 0 else None


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


def phase_build() -> None:
    from tfservingcache_tpu_torch.ops import _build

    paths = _build.build()
    for name, path in paths.items():
        log(f"built {name}: {os.path.relpath(path, ROOT)}")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


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


def phase_serve(layers: int, seed: int, warm_reps: int, kernels: dict) -> None:
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.models.transformer_lm import LLAMA7B_CONFIG
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.model_runtime import next_bucket
    from tfservingcache_tpu_torch.server import build_node
    from tfservingcache_tpu_torch.types import ModelId

    model_id = ModelId("llama7b", 1)
    model_cfg = dict(LLAMA7B_CONFIG, n_layers=layers)
    model_def = registry.build("transformer_lm", model_cfg)
    vocab = model_cfg["vocab_size"]
    log(f"transformer_lm at llama-7b width: d_model={model_cfg['d_model']} "
        f"heads={model_cfg['n_heads']} d_ff={model_cfg['d_ff']} vocab={vocab}, "
        f"n_layers={layers} (of 32)")
    work = tempfile.mkdtemp(prefix="tpusc_chip_smoke_")
    node = None
    try:
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
        registry.save_artifact(os.path.join(work, "store", "llama7b", "1"), model_def, params)
        art_bytes = os.path.getsize(os.path.join(work, "store", "llama7b", "1", "params.bin"))
        log(f"wrote random-weight artifact (seed {seed}): {art_bytes} bytes "
            f"in {time.monotonic() - t0:.2f}s")
        plain_model = model_def.make_module(params).eval()  # same weights, for the plain path

        cfg = config_from_dict({
            "serving": {"load_timeout_s": 900.0, "max_concurrent_models": 2},
            "cache": {"base_dir": os.path.join(work, "cache"),
                      "disk_capacity_bytes": 4 * art_bytes},
            "model_provider": {"type": "disk", "base_dir": os.path.join(work, "store")},
            "cache_node": {"rest_port": 0},
        })
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

        expected = layers * len(requests)
        log(f"flash_attention launches on the serving path: {launches} "
            f"(n_layers {layers} x {len(requests)} requests = {expected})")
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
            # the plain path on the card: same weights, same padded input,
            # attention_reference in every layer
            padded = np.zeros((next_bucket(shape[0]), next_bucket(shape[1])), np.int32)
            padded[: shape[0], : shape[1]] = ids
            with torch.inference_mode():
                logits = plain_model(
                    {"input_ids": torch.from_numpy(padded).cuda()},
                    attention_fn=A.attention_reference,
                )["logits"]
                ref = logits[: shape[0], shape[1] - 1, :].cpu().numpy()
            row_err = np.abs(pred - ref).max(axis=-1)
            err = float(row_err.max())
            top2 = np.sort(ref, axis=-1)[:, -2:]
            margin = top2[:, 1] - top2[:, 0]
            # a row whose top-2 margin exceeds twice its own disagreement
            # must keep its argmax; a narrower margin is a bf16 near-tie
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
        shutil.rmtree(work, ignore_errors=True)


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

    with Phase("environment"):
        phase_environment()
    sys.path.insert(0, ROOT)
    if importlib.util.find_spec("tfservingcache_tpu_torch") is None:
        raise SystemExit(f"chip_smoke: tfservingcache_tpu_torch not found next to {__file__}; "
                         "run it from a checkout of the repo")
    import torch

    with Phase("build"):
        phase_build()
    with Phase("kernels"):
        kernels = phase_kernels(args.seed)
    with Phase("serve"):
        phase_serve(layers, args.seed, args.warm, kernels)

    log(nvidia_smi_line())
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
