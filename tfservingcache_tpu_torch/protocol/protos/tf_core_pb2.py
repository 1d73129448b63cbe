# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tfservingcache_tpu/protocol/protos/tf_core.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n0tfservingcache_tpu/protocol/protos/tf_core.proto\x12\ntensorflow\"z\n\x10TensorShapeProto\x12-\n\x03\x64im\x18\x02 \x03(\x0b\x32 .tensorflow.TensorShapeProto.Dim\x12\x14\n\x0cunknown_rank\x18\x03 \x01(\x08\x1a!\n\x03\x44im\x12\x0c\n\x04size\x18\x01 \x01(\x03\x12\x0c\n\x04name\x18\x02 \x01(\t\"\xed\x02\n\x0bTensorProto\x12#\n\x05\x64type\x18\x01 \x01(\x0e\x32\x14.tensorflow.DataType\x12\x32\n\x0ctensor_shape\x18\x02 \x01(\x0b\x32\x1c.tensorflow.TensorShapeProto\x12\x16\n\x0eversion_number\x18\x03 \x01(\x05\x12\x16\n\x0etensor_content\x18\x04 \x01(\x0c\x12\x10\n\x08half_val\x18\r \x03(\x05\x12\x11\n\tfloat_val\x18\x05 \x03(\x02\x12\x12\n\ndouble_val\x18\x06 \x03(\x01\x12\x0f\n\x07int_val\x18\x07 \x03(\x05\x12\x12\n\nstring_val\x18\x08 \x03(\x0c\x12\x14\n\x0cscomplex_val\x18\t \x03(\x02\x12\x11\n\tint64_val\x18\n \x03(\x03\x12\x10\n\x08\x62ool_val\x18\x0b \x03(\x08\x12\x14\n\x0c\x64\x63omplex_val\x18\x0c \x03(\x01\x12\x12\n\nuint32_val\x18\x10 \x03(\r\x12\x12\n\nuint64_val\x18\x11 \x03(\x04\"I\n\x10NamedTensorProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\'\n\x06tensor\x18\x02 \x01(\x0b\x32\x17.tensorflow.TensorProto\"\x1a\n\tBytesList\x12\r\n\x05value\x18\x01 \x03(\x0c\"\x1a\n\tFloatList\x12\r\n\x05value\x18\x01 \x03(\x02\"\x1a\n\tInt64List\x12\r\n\x05value\x18\x01 \x03(\x03\"\x98\x01\n\x07\x46\x65\x61ture\x12+\n\nbytes_list\x18\x01 \x01(\x0b\x32\x15.tensorflow.BytesListH\x00\x12+\n\nfloat_list\x18\x02 \x01(\x0b\x32\x15.tensorflow.FloatListH\x00\x12+\n\nint64_list\x18\x03 \x01(\x0b\x32\x15.tensorflow.Int64ListH\x00\x42\x06\n\x04kind\"\x83\x01\n\x08\x46\x65\x61tures\x12\x32\n\x07\x66\x65\x61ture\x18\x01 \x03(\x0b\x32!.tensorflow.Features.FeatureEntry\x1a\x43\n\x0c\x46\x65\x61tureEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.tensorflow.Feature:\x02\x38\x01\"1\n\x07\x45xample\x12&\n\x08\x66\x65\x61tures\x18\x01 \x01(\x0b\x32\x14.tensorflow.Features\"\xa0\x02\n\nTensorInfo\x12\x0e\n\x04name\x18\x01 \x01(\tH\x00\x12\x36\n\ncoo_sparse\x18\x04 \x01(\x0b\x32 .tensorflow.TensorInfo.CooSparseH\x00\x12#\n\x05\x64type\x18\x02 \x01(\x0e\x32\x14.tensorflow.DataType\x12\x32\n\x0ctensor_shape\x18\x03 \x01(\x0b\x32\x1c.tensorflow.TensorShapeProto\x1a\x65\n\tCooSparse\x12\x1a\n\x12values_tensor_name\x18\x01 \x01(\t\x12\x1b\n\x13indices_tensor_name\x18\x02 \x01(\t\x12\x1f\n\x17\x64\x65nse_shape_tensor_name\x18\x03 \x01(\tB\n\n\x08\x65ncoding\"\xa0\x02\n\x0cSignatureDef\x12\x34\n\x06inputs\x18\x01 \x03(\x0b\x32$.tensorflow.SignatureDef.InputsEntry\x12\x36\n\x07outputs\x18\x02 \x03(\x0b\x32%.tensorflow.SignatureDef.OutputsEntry\x12\x13\n\x0bmethod_name\x18\x03 \x01(\t\x1a\x45\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.tensorflow.TensorInfo:\x02\x38\x01\x1a\x46\n\x0cOutputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.tensorflow.TensorInfo:\x02\x38\x01*\xf4\x02\n\x08\x44\x61taType\x12\x0e\n\nDT_INVALID\x10\x00\x12\x0c\n\x08\x44T_FLOAT\x10\x01\x12\r\n\tDT_DOUBLE\x10\x02\x12\x0c\n\x08\x44T_INT32\x10\x03\x12\x0c\n\x08\x44T_UINT8\x10\x04\x12\x0c\n\x08\x44T_INT16\x10\x05\x12\x0b\n\x07\x44T_INT8\x10\x06\x12\r\n\tDT_STRING\x10\x07\x12\x10\n\x0c\x44T_COMPLEX64\x10\x08\x12\x0c\n\x08\x44T_INT64\x10\t\x12\x0b\n\x07\x44T_BOOL\x10\n\x12\x0c\n\x08\x44T_QINT8\x10\x0b\x12\r\n\tDT_QUINT8\x10\x0c\x12\r\n\tDT_QINT32\x10\r\x12\x0f\n\x0b\x44T_BFLOAT16\x10\x0e\x12\r\n\tDT_QINT16\x10\x0f\x12\x0e\n\nDT_QUINT16\x10\x10\x12\r\n\tDT_UINT16\x10\x11\x12\x11\n\rDT_COMPLEX128\x10\x12\x12\x0b\n\x07\x44T_HALF\x10\x13\x12\x0f\n\x0b\x44T_RESOURCE\x10\x14\x12\x0e\n\nDT_VARIANT\x10\x15\x12\r\n\tDT_UINT32\x10\x16\x12\r\n\tDT_UINT64\x10\x17\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tfservingcache_tpu.protocol.protos.tf_core_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FEATURES_FEATUREENTRY._options = None
  _FEATURES_FEATUREENTRY._serialized_options = b'8\001'
  _SIGNATUREDEF_INPUTSENTRY._options = None
  _SIGNATUREDEF_INPUTSENTRY._serialized_options = b'8\001'
  _SIGNATUREDEF_OUTPUTSENTRY._options = None
  _SIGNATUREDEF_OUTPUTSENTRY._serialized_options = b'8\001'
  _DATATYPE._serialized_start=1638
  _DATATYPE._serialized_end=2010
  _TENSORSHAPEPROTO._serialized_start=64
  _TENSORSHAPEPROTO._serialized_end=186
  _TENSORSHAPEPROTO_DIM._serialized_start=153
  _TENSORSHAPEPROTO_DIM._serialized_end=186
  _TENSORPROTO._serialized_start=189
  _TENSORPROTO._serialized_end=554
  _NAMEDTENSORPROTO._serialized_start=556
  _NAMEDTENSORPROTO._serialized_end=629
  _BYTESLIST._serialized_start=631
  _BYTESLIST._serialized_end=657
  _FLOATLIST._serialized_start=659
  _FLOATLIST._serialized_end=685
  _INT64LIST._serialized_start=687
  _INT64LIST._serialized_end=713
  _FEATURE._serialized_start=716
  _FEATURE._serialized_end=868
  _FEATURES._serialized_start=871
  _FEATURES._serialized_end=1002
  _FEATURES_FEATUREENTRY._serialized_start=935
  _FEATURES_FEATUREENTRY._serialized_end=1002
  _EXAMPLE._serialized_start=1004
  _EXAMPLE._serialized_end=1053
  _TENSORINFO._serialized_start=1056
  _TENSORINFO._serialized_end=1344
  _TENSORINFO_COOSPARSE._serialized_start=1231
  _TENSORINFO_COOSPARSE._serialized_end=1332
  _SIGNATUREDEF._serialized_start=1347
  _SIGNATUREDEF._serialized_end=1635
  _SIGNATUREDEF_INPUTSENTRY._serialized_start=1494
  _SIGNATUREDEF_INPUTSENTRY._serialized_end=1563
  _SIGNATUREDEF_OUTPUTSENTRY._serialized_start=1565
  _SIGNATUREDEF_OUTPUTSENTRY._serialized_end=1635
# @@protoc_insertion_point(module_scope)
