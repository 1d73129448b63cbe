"""Command line: ``python -m tfservingcache_tpu_torch.cli serve --config <json>``
runs a single-GPU cache node until SIGINT/SIGTERM, and a router on the proxy
ports beside it when the config sets ``discovery.type``
(``server.serve``). Logging follows the config's ``logging`` section
(``level``, ``fmt`` text | json)."""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from tfservingcache_tpu_torch import server
from tfservingcache_tpu_torch.config import Config, load_config
from tfservingcache_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("tpusc_torch.cli")


def serve(cfg: Config) -> int:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    log.info("starting a cache node on %s%s", cfg.serving.device,
             f" and a router ({cfg.discovery.type} discovery)" if cfg.discovery.type else "")
    server.serve(cfg, stop)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tfservingcache_tpu_torch.cli", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    srv = sub.add_parser("serve", help="run a cache node on one GPU (and a router with "
                                       "discovery.type set)")
    srv.add_argument("--config", default=None,
                     help="path to a JSON (or YAML) config; serving.device picks the device")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    setup_logging(cfg.logging.level, cfg.logging.fmt)
    return serve(cfg)


if __name__ == "__main__":
    raise SystemExit(main())
