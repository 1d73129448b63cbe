"""The TF Serving protocol's generated protobuf modules: copies of the JAX
package's ``protocol/protos/*_pb2.py`` in which only the ``from ... import``
lines differ. The serialized descriptors are byte for byte the same, so
both packages can load them in one process (protobuf's default pool takes an
identical file twice) and share the message classes. Importing them needs
``protobuf``; nothing imports them unless gRPC or the tensor codec is used.
"""
