"""Command line: ``python -m tfservingcache_tpu_torch.cli serve --config <json>``
runs a single-GPU cache node until SIGINT/SIGTERM. Logging follows the
config's ``logging`` section (``level``, ``fmt`` text | json)."""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from tfservingcache_tpu_torch.config import Config, load_config
from tfservingcache_tpu_torch.server import build_node, configure_observability
from tfservingcache_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("tpusc_torch.cli")


def serve(cfg: Config) -> int:
    configure_observability(cfg)
    node = build_node(cfg)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    port = node.start()
    log.info("cache node serving REST on :%d, gRPC on %s (device %s)", port,
             f":{node.grpc_port}" if node.grpc_port is not None else "none",
             node.runtime.device)
    try:
        stop.wait()
    finally:
        node.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tfservingcache_tpu_torch.cli", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    srv = sub.add_parser("serve", help="run a cache node on one GPU")
    srv.add_argument("--config", default=None,
                     help="path to a JSON (or YAML) config; serving.device picks the device")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    setup_logging(cfg.logging.level, cfg.logging.fmt)
    return serve(cfg)


if __name__ == "__main__":
    raise SystemExit(main())
