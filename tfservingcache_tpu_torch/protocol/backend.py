"""The seam between the REST server and whatever fulfils requests
(counterpart of ``tfservingcache_tpu/protocol/backend.py``, REST only)."""

from __future__ import annotations

import abc
from dataclasses import dataclass


@dataclass
class RestResponse:
    status: int
    body: bytes  # JSON


class BackendError(Exception):
    """A request failure with the HTTP status the server answers with."""

    def __init__(self, message: str, http_status: int = 500) -> None:
        super().__init__(message)
        self.http_status = http_status


class ServingBackend(abc.ABC):
    @abc.abstractmethod
    def handle_rest(
        self,
        method: str,
        model_name: str,
        version: int | None,
        verb: str | None,
        body: bytes,
        query: dict[str, str] | None = None,
    ) -> RestResponse:
        """Serve one parsed model URL. ``verb`` is ``predict``, ``generate``
        (and the verbs later slices add), ``metadata``, or None for a status
        GET; ``query`` holds the URL's query parameters."""
