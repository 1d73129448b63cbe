"""Command line (``python -m tfservingcache_tpu_torch.cli``; counterpart of
``tfservingcache_tpu/cli.py``):

  serve   run a single-GPU cache node until SIGINT/SIGTERM, and a router on
          the proxy ports beside it when the config sets ``discovery.type``
          (``server.serve``); with ``mesh.coordinator`` and
          ``mesh.num_processes > 1`` a process other than 0 runs a pure
          follower of the group that spans processes (its group-work
          service only);
  export  write a family's artifact with random weights from ``--seed``
          (``--quantize int8``, ``--config-json`` overrides), initialized on
          ``serving.device``;
  repack  rewrite a ``tpusc.v2`` artifact, int8 leaves carried as they are;
  warm    load an artifact and run its serving shapes once, which builds
          every kernel they launch into ``ops/_build/``.

``--config`` (before the command; ``serve --config`` too) names a JSON or
YAML config; without it ``./config.yaml`` is read when it exists.
``TPUSC_<SECTION>_<FIELD>`` environment variables override either
(``TPUSC_SERVING_DEVICE=cpu`` exports, serves and warms on the CPU). Logging
follows the config's ``logging`` section (``level``, ``fmt`` text | json)."""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
import time

from tfservingcache_tpu_torch import server
from tfservingcache_tpu_torch.config import Config, load_config
from tfservingcache_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("tpusc_torch.cli")

ARTIFACT_FORMAT_V1 = "tpusc.v1"


def serve(cfg: Config) -> int:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    if cfg.mesh.coordinator and cfg.mesh.num_processes > 1 and cfg.mesh.process_id:
        log.info("starting follower %d of a group across %d processes on %s",
                 cfg.mesh.process_id, cfg.mesh.num_processes, cfg.serving.device)
    else:
        log.info("starting a cache node on %s%s", cfg.serving.device,
                 f" and a router ({cfg.discovery.type} discovery)" if cfg.discovery.type
                 else "")
    server.serve(cfg, stop)
    return 0


def export(cfg: Config, args: argparse.Namespace) -> int:
    from tfservingcache_tpu_torch.models.registry import export_artifact

    config = None
    if args.config_json is not None:
        # an empty string fails json.loads like every other malformed value
        # (a silently ignored unset $CFG would export defaults)
        try:
            config = json.loads(args.config_json)
            if not isinstance(config, dict):
                raise ValueError("must be a JSON object")
        except ValueError as e:
            log.error("invalid --config-json: %s", e)
            return 2
    print(export_artifact(args.model, args.dest, name=args.name, version=args.version,
                          config=config, seed=args.seed, device=cfg.serving.device,
                          quantize=args.quantize))
    return 0


def repack(args: argparse.Namespace) -> int:
    """The source's quantize marker and its int8 bytes carried through: a
    raw load's ``QuantLeaf`` leaves are written as they are (a dequantize
    and requantize would shift scales on every repack)."""
    from tfservingcache_tpu_torch.models.registry import load_artifact, save_artifact

    try:
        with open(os.path.join(args.src, "model.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        meta = {}
    if meta.get("format") == ARTIFACT_FORMAT_V1:
        # flax msgpack: reading it needs flax and msgpack, which a serving
        # machine need not have
        log.error("%s is a %s (flax msgpack) artifact; convert it with the JAX package's "
                  "repack (python -m tfservingcache_tpu.cli repack %s <dest>)",
                  args.src, ARTIFACT_FORMAT_V1, args.src)
        return 2
    model, params = load_artifact(args.src, raw_quant=True)
    print(save_artifact(args.dest, model, params, quantize=meta.get("quantize")))
    return 0


def warm(cfg: Config, args: argparse.Namespace) -> int:
    """Load an artifact through the serving runtime on ``serving.device``
    and run the shapes traffic asks for (the reference's ``_warm``): each
    ``--batches`` bucket, the first dynamic axis of every input as the batch
    and every later one at ``--lm-seq``, and for the LM families a
    ``generate`` of ``--generate-tokens`` (both clamped to ``max_seq``).
    What persists across processes is the kernel libraries those shapes
    build into ``ops/_build/``; the port has no program cache to fill."""
    import numpy as np

    from tfservingcache_tpu_torch.cache.disk_cache import dir_size_bytes
    from tfservingcache_tpu_torch.ops import _build
    from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
    from tfservingcache_tpu_torch.types import Model, ModelId

    art = os.path.abspath(args.artifact)
    version_s = os.path.basename(art)
    name = os.path.basename(os.path.dirname(art))
    mid = ModelId(name or "model", int(version_s) if version_s.isdigit() else 1)
    rt = TorchModelRuntime(cfg.serving, device=cfg.serving.device)
    ran = []
    t0 = time.perf_counter()
    try:
        rt.ensure_loaded(Model(identifier=mid, path=art, size_on_disk=dir_size_bytes(art)))
        in_spec, _, _ = rt.signature(mid)
        family = rt.family_of(mid)
        max_seq = rt.max_seq_of(mid) or 0
        seq, gen_tokens = args.lm_seq, args.generate_tokens
        if max_seq:
            # clamp to what the model serves: the default 128/32 against a
            # small max_seq warms the usable shapes instead of failing
            seq = min(seq, max(1, max_seq // 2))
            gen_tokens = min(gen_tokens, max_seq - seq)
            if (seq, gen_tokens) != (args.lm_seq, args.generate_tokens):
                log.info("clamped to seq=%d, generate_tokens=%d (max_seq %d)",
                         seq, gen_tokens, max_seq)
        for b in sorted({int(x) for x in args.batches.split(",") if x.strip()}):
            inputs = {}
            for nm, spec in in_spec.items():
                shape, dyn = [], 0
                for d in spec.norm_shape():
                    if isinstance(d, str):
                        shape.append(b if dyn == 0 else seq)
                        dyn += 1
                    else:
                        shape.append(d)
                inputs[nm] = np.zeros(tuple(shape), spec.np_dtype())
            rt.predict(mid, inputs)
            ran.append(f"predict b={b}")
        if family in ("transformer_lm", "moe_lm") and gen_tokens > 0:
            rt.generate(mid, np.zeros((1, seq), np.int32), max_new_tokens=gen_tokens)
            ran.append(f"generate b=1 new={gen_tokens}")
    finally:
        rt.close()
    dt = time.perf_counter() - t0
    if rt.device.type == "cuda":
        built = ", ".join(sorted(_build._loaded)) or "no kernel on these shapes"
        where = f"{_build.BUILD_DIR} ({built})"
    else:
        where = f"nothing built ({rt.device.type}: the plain path)"
    print(f"warmed {mid} ({family}): {', '.join(ran)} in {dt:.1f}s -> {where}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tfservingcache_tpu_torch.cli", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default=None,
                        help="path to a JSON or YAML config (default ./config.yaml if present)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    srv = sub.add_parser("serve", help="run a cache node on one GPU (and a router with "
                                       "discovery.type set)")
    # ``serve --config cfg.json``, the form this command has always taken
    srv.add_argument("--config", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    exp = sub.add_parser("export",
                         help="export a model artifact with random weights to a provider dir")
    exp.add_argument("model", help="model family name (see models/registry.py)")
    exp.add_argument("dest", help="destination dir (<dest>/<name>/<version> is created)")
    exp.add_argument("--name", default=None)
    exp.add_argument("--version", type=int, default=1)
    exp.add_argument("--quantize", choices=["int8"], default=None,
                     help="store large float weights as int8 + per-channel scales "
                          "(dequantized on the device at load)")
    exp.add_argument("--config-json", default=None, metavar="JSON",
                     help="family config overrides as a JSON object, merged over the "
                          "family's defaults")
    exp.add_argument("--seed", type=int, default=0, help="parameter init seed")
    rep = sub.add_parser("repack",
                         help="rewrite a tpusc.v2 artifact (the family's storage dtype, "
                              "int8 leaves carried)")
    rep.add_argument("src", help="existing artifact dir (<...>/<name>/<version>)")
    rep.add_argument("dest", help="output artifact dir")
    wrm = sub.add_parser("warm",
                         help="load an artifact and run its serving shapes once, building "
                              "the kernels they launch")
    wrm.add_argument("artifact", help="artifact dir (<...>/<name>/<version>)")
    wrm.add_argument("--batches", default="1,2,4,8",
                     help="comma-separated predict batch buckets to run")
    wrm.add_argument("--lm-seq", type=int, default=128,
                     help="length of every non-batch dynamic axis (an LM's prompt, "
                          "t5's src and tgt)")
    wrm.add_argument("--generate-tokens", type=int, default=32,
                     help="decode length for the LM families (0 skips generate)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    setup_logging(cfg.logging.level, cfg.logging.fmt)
    if args.cmd == "serve":
        return serve(cfg)
    if args.cmd == "export":
        return export(cfg, args)
    if args.cmd == "repack":
        return repack(args)
    return warm(cfg, args)


if __name__ == "__main__":
    raise SystemExit(main())
