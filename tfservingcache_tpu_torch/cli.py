"""Command line: ``python -m tfservingcache_tpu_torch.cli serve --config <json>``
runs a single-GPU cache node until SIGINT/SIGTERM."""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from tfservingcache_tpu_torch.config import load_config
from tfservingcache_tpu_torch.server import build_node

log = logging.getLogger("tpusc_torch.cli")


def serve(config_path: str | None) -> int:
    cfg = load_config(config_path)
    node = build_node(cfg)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    port = node.start()
    log.info("cache node serving REST on :%d (device %s)", port, node.runtime.device)
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
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    return serve(args.config)


if __name__ == "__main__":
    raise SystemExit(main())
