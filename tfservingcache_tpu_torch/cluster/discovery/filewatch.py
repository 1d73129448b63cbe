"""File discovery: a JSON members file, polled (counterpart of
``tfservingcache_tpu/cluster/discovery/filewatch.py``; the file's format is
the reference's, ``{"nodes": ["host:rest:grpc", ...]}``, so port and
reference nodes can share one).

``register`` adds this node's ident (write to a temporary name, then
rename); a poll thread re-reads the file every ``poll_interval_s``, puts
back an ident of its own that a racing writer dropped, and publishes the
membership when it changed. A poll that finds the file unreadable (another
writer caught mid-write) skips its round rather than writing back only this
node's idents over the others'. ``unregister`` stops the thread and removes
this node's idents. ``register`` and ``unregister`` re-read an unreadable
file a few times; if it stays unreadable they leave it alone (the poll
thread adds a registered ident once the file reads again), where the
reference's would write this node's ident alone, or ``[]``, over it."""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable

from tfservingcache_tpu_torch.cluster.discovery.base import DiscoveryService
from tfservingcache_tpu_torch.types import NodeInfo

log = logging.getLogger("tpusc_torch.discovery.file")

# an unreadable file is re-read this many times, this far apart, before
# register/unregister give up their write
READ_RETRIES = 5
READ_RETRY_S = 0.05


class FileDiscoveryService(DiscoveryService):
    def __init__(self, path: str, poll_interval_s: float = 2.0) -> None:
        super().__init__()
        self.path = path
        self.poll_interval_s = poll_interval_s
        self._self_idents: list[str] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _read(self) -> list[str] | None:
        """The file's idents; [] when it is missing, None when unreadable."""
        try:
            with open(self.path) as f:
                data = json.load(f)
            return list(data.get("nodes", []))
        except FileNotFoundError:
            return []
        except (json.JSONDecodeError, AttributeError) as e:
            log.warning("membership file %s unreadable: %s", self.path, e)
            return None

    def _read_settled(self) -> list[str] | None:
        """``_read``, retried while another writer is caught mid-write;
        None when the file stays unreadable."""
        for attempt in range(READ_RETRIES):
            if attempt:
                time.sleep(READ_RETRY_S)
            idents = self._read()
            if idents is not None:
                return idents
        return None

    def _write(self, idents: list[str]) -> None:
        tmp = f"{self.path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump({"nodes": sorted(set(idents))}, f)
        os.replace(tmp, self.path)

    def register(self, self_node: NodeInfo, is_healthy: Callable[[], bool]) -> None:
        self._self_idents.append(self_node.ident)
        idents = self._read_settled()
        if idents is None:
            log.warning("membership file %s unreadable: %s joins at the next poll",
                        self.path, self_node.ident)
        elif self_node.ident not in idents:
            self._write(idents + [self_node.ident])
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._poll_loop, name="tpusc-discovery-file",
                                            daemon=True)
            self._thread.start()

    def _poll_loop(self) -> None:
        last: list[str] | None = None
        while not self._stop.is_set():
            idents = self._read()
            if idents is None:
                self._stop.wait(self.poll_interval_s)
                continue
            # two nodes registering at once can clobber each other's
            # unlocked read-modify-write: put ours back within one poll
            missing = [i for i in self._self_idents if i not in idents]
            if missing:
                try:
                    self._write(idents + missing)
                    reread = self._read()
                    idents = reread if reread is not None else idents + missing
                except OSError as e:
                    log.warning("could not re-register in %s: %s", self.path, e)
            if idents != last:
                last = idents
                nodes = []
                for ident in idents:
                    try:
                        nodes.append(NodeInfo.from_ident(ident))
                    except ValueError:
                        log.warning("bad node ident in %s: %r", self.path, ident)
                self._publish(nodes)
            self._stop.wait(self.poll_interval_s)

    def unregister(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._self_idents:
            mine = set(self._self_idents)
            idents = self._read_settled()
            if idents is None:
                log.warning("membership file %s unreadable: %s left in it",
                            self.path, sorted(mine))
            else:
                try:
                    self._write([i for i in idents if i not in mine])
                except OSError as e:
                    log.warning("could not deregister from %s: %s", self.path, e)
            self._self_idents.clear()
