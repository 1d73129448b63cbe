"""The seam between the protocol servers and whatever fulfils requests
(counterpart of ``tfservingcache_tpu/protocol/backend.py``). The REST server
calls ``handle_rest``; the gRPC server (``protocol/grpc_server.py``) calls
the backend's message-shaped methods (``predict``, ``classify``, ...), which
take and return the TF Serving protobuf messages."""

from __future__ import annotations

import abc
from collections.abc import Iterator
from dataclasses import dataclass, field


@dataclass
class RestResponse:
    status: int
    body: bytes  # JSON
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)
    # a streamed reply (``:generate?stream=true``): byte frames the server
    # writes one by one over chunked transfer, after the status and headers.
    # Those ship before the first frame, so a request that cannot stream
    # must fail before the backend returns.
    token_stream: Iterator[bytes] | None = None


# the TF Serving gRPC services (their names need no grpcio: the router
# builds gRPC calls from them and imports grpc only when one arrives)
PREDICTION_SERVICE = "tensorflow.serving.PredictionService"
MODEL_SERVICE = "tensorflow.serving.ModelService"
SESSION_SERVICE = "tensorflow.serving.SessionService"
# trailing-metadata key carrying a node's completed span subtree back to a
# caller that sent a traceparent
TRACE_SUBTREE_TRAILER = "tpusc-trace"

# the gRPC status a failure answers with where its raise site names none
_GRPC_CODE_OF_HTTP = {
    400: "INVALID_ARGUMENT", 404: "NOT_FOUND", 405: "UNIMPLEMENTED",
    412: "FAILED_PRECONDITION", 501: "UNIMPLEMENTED", 503: "UNAVAILABLE",
    504: "DEADLINE_EXCEEDED",
}


class BackendError(Exception):
    """A request failure with the HTTP status the REST server answers with
    and the name of the ``grpc.StatusCode`` the gRPC server answers with
    (a name, so that raising one needs no ``grpc``)."""

    def __init__(self, message: str, http_status: int = 500,
                 grpc_code: str | None = None) -> None:
        super().__init__(message)
        self.http_status = http_status
        self.grpc_code = grpc_code or _GRPC_CODE_OF_HTTP.get(http_status, "INTERNAL")


class ServingBackend(abc.ABC):
    @abc.abstractmethod
    def handle_rest(
        self,
        method: str,
        model_name: str,
        version: int | None,
        verb: str | None,
        body: bytes,
        label: str | None = None,
        query: dict[str, str] | None = None,
    ) -> RestResponse:
        """Serve one parsed model URL. ``verb`` is ``predict``,
        ``classify``, ``regress``, ``generate``, ``metadata``, or None for a
        status GET; ``version`` and ``label`` (a ``/labels/<label>`` URL)
        exclude each other; ``query`` holds the URL's query parameters."""
