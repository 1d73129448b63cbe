"""gRPC client for the tensorflow.serving protocol (counterpart of
``tfservingcache_tpu/protocol/grpc_client.py``) on a synchronous channel:
callables built from the server's ``METHOD_TABLE``, so the two sides
cannot drift. Needs ``grpcio`` and ``protobuf``."""

from __future__ import annotations

import grpc

from tfservingcache_tpu_torch.protocol.grpc_server import METHOD_TABLE
from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv


class ServingStub:
    """Every tensorflow.serving method on one channel, built at first use."""

    def __init__(self, channel: grpc.Channel) -> None:
        self.channel = channel
        self._callables: dict[tuple[str, str], grpc.UnaryUnaryMultiCallable] = {}

    def method(self, service: str, method: str) -> grpc.UnaryUnaryMultiCallable:
        key = (service, method)
        if key not in self._callables:
            req_cls, resp_cls = METHOD_TABLE[key]
            self._callables[key] = self.channel.unary_unary(
                f"/{service}/{method}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )
        return self._callables[key]

    def generate_stream(self) -> grpc.UnaryStreamMultiCallable:
        """PredictionService/GenerateStream (server streaming)."""
        return self.channel.unary_stream(
            "/tensorflow.serving.PredictionService/GenerateStream",
            request_serializer=sv.PredictRequest.SerializeToString,
            response_deserializer=sv.PredictResponse.FromString,
        )


def make_channel(target: str, max_message_bytes: int = 16 << 20) -> grpc.Channel:
    """An insecure channel with the reference's message cap and reconnect
    backoff (reference grpc_client.py:33-45)."""
    return grpc.insecure_channel(
        target,
        options=[
            ("grpc.max_receive_message_length", max_message_bytes),
            ("grpc.max_send_message_length", max_message_bytes),
            ("grpc.initial_reconnect_backoff_ms", 100),
            ("grpc.max_reconnect_backoff_ms", 5000),
        ],
    )
