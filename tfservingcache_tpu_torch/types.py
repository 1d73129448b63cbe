"""Core shared types (counterpart of ``tfservingcache_tpu/types.py``).

``ModelId`` keys every tier; ``ModelState`` is TF Serving's model version
lifecycle (START/LOADING/AVAILABLE/UNLOADING/END), tracked in-process by the
runtime; ``NodeInfo`` names a ring member by ``host:restPort:grpcPort``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, NamedTuple


class ModelId(NamedTuple):
    name: str
    version: int

    @property
    def key(self) -> str:
        """Consistent-hash routing key (``name##version``)."""
        return f"{self.name}##{self.version}"

    def __str__(self) -> str:
        return f"{self.name}@{self.version}"


@dataclass
class Model:
    """A fetched model artifact on local disk."""

    identifier: ModelId
    path: str = ""                 # absolute path of the artifact dir in the disk cache
    size_on_disk: int = 0
    metadata: dict[str, Any] = field(default_factory=dict)


class ModelState(enum.IntEnum):
    """TF Serving's ``ModelVersionStatus_State`` values."""

    UNKNOWN = 0
    START = 10
    LOADING = 20
    AVAILABLE = 30
    UNLOADING = 40
    END = 50


@dataclass
class NodeInfo:
    """A serving peer; its identity string (the ring member) is
    ``host:restPort:grpcPort``."""

    host: str
    rest_port: int
    grpc_port: int

    @property
    def ident(self) -> str:
        return f"{self.host}:{self.rest_port}:{self.grpc_port}"

    @classmethod
    def from_ident(cls, s: str) -> "NodeInfo":
        host, rest, grpc = s.rsplit(":", 2)
        return cls(host=host, rest_port=int(rest), grpc_port=int(grpc))
