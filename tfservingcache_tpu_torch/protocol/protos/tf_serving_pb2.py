# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tfservingcache_tpu/protocol/protos/tf_serving.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2
from google.protobuf import wrappers_pb2 as google_dot_protobuf_dot_wrappers__pb2
from tfservingcache_tpu_torch.protocol.protos import tf_core_pb2 as tfservingcache__tpu_dot_protocol_dot_protos_dot_tf__core__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n3tfservingcache_tpu/protocol/protos/tf_serving.proto\x12\x12tensorflow.serving\x1a\x19google/protobuf/any.proto\x1a\x1egoogle/protobuf/wrappers.proto\x1a\x30tfservingcache_tpu/protocol/protos/tf_core.proto\"\x8c\x01\n\tModelSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12.\n\x07version\x18\x02 \x01(\x0b\x32\x1b.google.protobuf.Int64ValueH\x00\x12\x17\n\rversion_label\x18\x04 \x01(\tH\x00\x12\x16\n\x0esignature_name\x18\x03 \x01(\tB\x10\n\x0eversion_choice\"\xe2\x01\n\x0ePredictRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12>\n\x06inputs\x18\x02 \x03(\x0b\x32..tensorflow.serving.PredictRequest.InputsEntry\x12\x15\n\routput_filter\x18\x03 \x03(\t\x1a\x46\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12&\n\x05value\x18\x02 \x01(\x0b\x32\x17.tensorflow.TensorProto:\x02\x38\x01\"\xd0\x01\n\x0fPredictResponse\x12\x31\n\nmodel_spec\x18\x02 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x41\n\x07outputs\x18\x01 \x03(\x0b\x32\x30.tensorflow.serving.PredictResponse.OutputsEntry\x1aG\n\x0cOutputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12&\n\x05value\x18\x02 \x01(\x0b\x32\x17.tensorflow.TensorProto:\x02\x38\x01\"4\n\x0b\x45xampleList\x12%\n\x08\x65xamples\x18\x01 \x03(\x0b\x32\x13.tensorflow.Example\"e\n\x16\x45xampleListWithContext\x12%\n\x08\x65xamples\x18\x01 \x03(\x0b\x32\x13.tensorflow.Example\x12$\n\x07\x63ontext\x18\x02 \x01(\x0b\x32\x13.tensorflow.Example\"\x99\x01\n\x05Input\x12\x37\n\x0c\x65xample_list\x18\x01 \x01(\x0b\x32\x1f.tensorflow.serving.ExampleListH\x00\x12O\n\x19\x65xample_list_with_context\x18\x02 \x01(\x0b\x32*.tensorflow.serving.ExampleListWithContextH\x00\x42\x06\n\x04kind\"%\n\x05\x43lass\x12\r\n\x05label\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\"=\n\x0f\x43lassifications\x12*\n\x07\x63lasses\x18\x01 \x03(\x0b\x32\x19.tensorflow.serving.Class\"T\n\x14\x43lassificationResult\x12<\n\x0f\x63lassifications\x18\x01 \x03(\x0b\x32#.tensorflow.serving.Classifications\"t\n\x15\x43lassificationRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12(\n\x05input\x18\x02 \x01(\x0b\x32\x19.tensorflow.serving.Input\"\x85\x01\n\x16\x43lassificationResponse\x12\x38\n\x06result\x18\x01 \x01(\x0b\x32(.tensorflow.serving.ClassificationResult\x12\x31\n\nmodel_spec\x18\x02 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\"\x1b\n\nRegression\x12\r\n\x05value\x18\x01 \x01(\x02\"G\n\x10RegressionResult\x12\x33\n\x0bregressions\x18\x01 \x03(\x0b\x32\x1e.tensorflow.serving.Regression\"p\n\x11RegressionRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12(\n\x05input\x18\x02 \x01(\x0b\x32\x19.tensorflow.serving.Input\"}\n\x12RegressionResponse\x12\x34\n\x06result\x18\x01 \x01(\x0b\x32$.tensorflow.serving.RegressionResult\x12\x31\n\nmodel_spec\x18\x02 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\"W\n\rInferenceTask\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x13\n\x0bmethod_name\x18\x02 \x01(\t\"\xdc\x01\n\x0fInferenceResult\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12I\n\x15\x63lassification_result\x18\x02 \x01(\x0b\x32(.tensorflow.serving.ClassificationResultH\x00\x12\x41\n\x11regression_result\x18\x03 \x01(\x0b\x32$.tensorflow.serving.RegressionResultH\x00\x42\x08\n\x06result\"s\n\x15MultiInferenceRequest\x12\x30\n\x05tasks\x18\x01 \x03(\x0b\x32!.tensorflow.serving.InferenceTask\x12(\n\x05input\x18\x02 \x01(\x0b\x32\x19.tensorflow.serving.Input\"N\n\x16MultiInferenceResponse\x12\x34\n\x07results\x18\x01 \x03(\x0b\x32#.tensorflow.serving.InferenceResult\"\xae\x01\n\x0fSignatureDefMap\x12L\n\rsignature_def\x18\x01 \x03(\x0b\x32\x35.tensorflow.serving.SignatureDefMap.SignatureDefEntry\x1aM\n\x11SignatureDefEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\'\n\x05value\x18\x02 \x01(\x0b\x32\x18.tensorflow.SignatureDef:\x02\x38\x01\"d\n\x17GetModelMetadataRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x16\n\x0emetadata_field\x18\x02 \x03(\t\"\xe2\x01\n\x18GetModelMetadataResponse\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12L\n\x08metadata\x18\x02 \x03(\x0b\x32:.tensorflow.serving.GetModelMetadataResponse.MetadataEntry\x1a\x45\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.google.protobuf.Any:\x02\x38\x01\"8\n\x0bStatusProto\x12\x12\n\nerror_code\x18\x01 \x01(\x05\x12\x15\n\rerror_message\x18\x02 \x01(\t\"J\n\x15GetModelStatusRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\"\xe8\x01\n\x12ModelVersionStatus\x12\x0f\n\x07version\x18\x01 \x01(\x03\x12;\n\x05state\x18\x02 \x01(\x0e\x32,.tensorflow.serving.ModelVersionStatus.State\x12/\n\x06status\x18\x03 \x01(\x0b\x32\x1f.tensorflow.serving.StatusProto\"S\n\x05State\x12\x0b\n\x07UNKNOWN\x10\x00\x12\t\n\x05START\x10\n\x12\x0b\n\x07LOADING\x10\x14\x12\r\n\tAVAILABLE\x10\x1e\x12\r\n\tUNLOADING\x10(\x12\x07\n\x03\x45ND\x10\x32\"^\n\x16GetModelStatusResponse\x12\x44\n\x14model_version_status\x18\x01 \x03(\x0b\x32&.tensorflow.serving.ModelVersionStatus\"\xb7\x02\n\x15ServableVersionPolicy\x12\x42\n\x06latest\x18\x64 \x01(\x0b\x32\x30.tensorflow.serving.ServableVersionPolicy.LatestH\x00\x12<\n\x03\x61ll\x18\x65 \x01(\x0b\x32-.tensorflow.serving.ServableVersionPolicy.AllH\x00\x12\x46\n\x08specific\x18\x66 \x01(\x0b\x32\x32.tensorflow.serving.ServableVersionPolicy.SpecificH\x00\x1a\x1e\n\x06Latest\x12\x14\n\x0cnum_versions\x18\x01 \x01(\r\x1a\x05\n\x03\x41ll\x1a\x1c\n\x08Specific\x12\x10\n\x08versions\x18\x01 \x03(\x03\x42\x0f\n\rpolicy_choice\"\x8f\x01\n\x0bModelConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tbase_path\x18\x02 \x01(\t\x12\x16\n\x0emodel_platform\x18\x04 \x01(\t\x12G\n\x14model_version_policy\x18\x07 \x01(\x0b\x32).tensorflow.serving.ServableVersionPolicy\"B\n\x0fModelConfigList\x12/\n\x06\x63onfig\x18\x01 \x03(\x0b\x32\x1f.tensorflow.serving.ModelConfig\"\x94\x01\n\x11ModelServerConfig\x12@\n\x11model_config_list\x18\x01 \x01(\x0b\x32#.tensorflow.serving.ModelConfigListH\x00\x12\x33\n\x13\x63ustom_model_config\x18\x02 \x01(\x0b\x32\x14.google.protobuf.AnyH\x00\x42\x08\n\x06\x63onfig\"L\n\x13ReloadConfigRequest\x12\x35\n\x06\x63onfig\x18\x01 \x01(\x0b\x32%.tensorflow.serving.ModelServerConfig\"G\n\x14ReloadConfigResponse\x12/\n\x06status\x18\x01 \x01(\x0b\x32\x1f.tensorflow.serving.StatusProto\"\x91\x01\n\x11SessionRunRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12*\n\x04\x66\x65\x65\x64\x18\x02 \x03(\x0b\x32\x1c.tensorflow.NamedTensorProto\x12\r\n\x05\x66\x65tch\x18\x03 \x03(\t\x12\x0e\n\x06target\x18\x04 \x03(\t\"B\n\x12SessionRunResponse\x12,\n\x06tensor\x18\x01 \x03(\x0b\x32\x1c.tensorflow.NamedTensorProtob\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tfservingcache_tpu.protocol.protos.tf_serving_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PREDICTREQUEST_INPUTSENTRY._options = None
  _PREDICTREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _PREDICTRESPONSE_OUTPUTSENTRY._options = None
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_options = b'8\001'
  _SIGNATUREDEFMAP_SIGNATUREDEFENTRY._options = None
  _SIGNATUREDEFMAP_SIGNATUREDEFENTRY._serialized_options = b'8\001'
  _GETMODELMETADATARESPONSE_METADATAENTRY._options = None
  _GETMODELMETADATARESPONSE_METADATAENTRY._serialized_options = b'8\001'
  _MODELSPEC._serialized_start=185
  _MODELSPEC._serialized_end=325
  _PREDICTREQUEST._serialized_start=328
  _PREDICTREQUEST._serialized_end=554
  _PREDICTREQUEST_INPUTSENTRY._serialized_start=484
  _PREDICTREQUEST_INPUTSENTRY._serialized_end=554
  _PREDICTRESPONSE._serialized_start=557
  _PREDICTRESPONSE._serialized_end=765
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_start=694
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_end=765
  _EXAMPLELIST._serialized_start=767
  _EXAMPLELIST._serialized_end=819
  _EXAMPLELISTWITHCONTEXT._serialized_start=821
  _EXAMPLELISTWITHCONTEXT._serialized_end=922
  _INPUT._serialized_start=925
  _INPUT._serialized_end=1078
  _CLASS._serialized_start=1080
  _CLASS._serialized_end=1117
  _CLASSIFICATIONS._serialized_start=1119
  _CLASSIFICATIONS._serialized_end=1180
  _CLASSIFICATIONRESULT._serialized_start=1182
  _CLASSIFICATIONRESULT._serialized_end=1266
  _CLASSIFICATIONREQUEST._serialized_start=1268
  _CLASSIFICATIONREQUEST._serialized_end=1384
  _CLASSIFICATIONRESPONSE._serialized_start=1387
  _CLASSIFICATIONRESPONSE._serialized_end=1520
  _REGRESSION._serialized_start=1522
  _REGRESSION._serialized_end=1549
  _REGRESSIONRESULT._serialized_start=1551
  _REGRESSIONRESULT._serialized_end=1622
  _REGRESSIONREQUEST._serialized_start=1624
  _REGRESSIONREQUEST._serialized_end=1736
  _REGRESSIONRESPONSE._serialized_start=1738
  _REGRESSIONRESPONSE._serialized_end=1863
  _INFERENCETASK._serialized_start=1865
  _INFERENCETASK._serialized_end=1952
  _INFERENCERESULT._serialized_start=1955
  _INFERENCERESULT._serialized_end=2175
  _MULTIINFERENCEREQUEST._serialized_start=2177
  _MULTIINFERENCEREQUEST._serialized_end=2292
  _MULTIINFERENCERESPONSE._serialized_start=2294
  _MULTIINFERENCERESPONSE._serialized_end=2372
  _SIGNATUREDEFMAP._serialized_start=2375
  _SIGNATUREDEFMAP._serialized_end=2549
  _SIGNATUREDEFMAP_SIGNATUREDEFENTRY._serialized_start=2472
  _SIGNATUREDEFMAP_SIGNATUREDEFENTRY._serialized_end=2549
  _GETMODELMETADATAREQUEST._serialized_start=2551
  _GETMODELMETADATAREQUEST._serialized_end=2651
  _GETMODELMETADATARESPONSE._serialized_start=2654
  _GETMODELMETADATARESPONSE._serialized_end=2880
  _GETMODELMETADATARESPONSE_METADATAENTRY._serialized_start=2811
  _GETMODELMETADATARESPONSE_METADATAENTRY._serialized_end=2880
  _STATUSPROTO._serialized_start=2882
  _STATUSPROTO._serialized_end=2938
  _GETMODELSTATUSREQUEST._serialized_start=2940
  _GETMODELSTATUSREQUEST._serialized_end=3014
  _MODELVERSIONSTATUS._serialized_start=3017
  _MODELVERSIONSTATUS._serialized_end=3249
  _MODELVERSIONSTATUS_STATE._serialized_start=3166
  _MODELVERSIONSTATUS_STATE._serialized_end=3249
  _GETMODELSTATUSRESPONSE._serialized_start=3251
  _GETMODELSTATUSRESPONSE._serialized_end=3345
  _SERVABLEVERSIONPOLICY._serialized_start=3348
  _SERVABLEVERSIONPOLICY._serialized_end=3659
  _SERVABLEVERSIONPOLICY_LATEST._serialized_start=3575
  _SERVABLEVERSIONPOLICY_LATEST._serialized_end=3605
  _SERVABLEVERSIONPOLICY_ALL._serialized_start=3607
  _SERVABLEVERSIONPOLICY_ALL._serialized_end=3612
  _SERVABLEVERSIONPOLICY_SPECIFIC._serialized_start=3614
  _SERVABLEVERSIONPOLICY_SPECIFIC._serialized_end=3642
  _MODELCONFIG._serialized_start=3662
  _MODELCONFIG._serialized_end=3805
  _MODELCONFIGLIST._serialized_start=3807
  _MODELCONFIGLIST._serialized_end=3873
  _MODELSERVERCONFIG._serialized_start=3876
  _MODELSERVERCONFIG._serialized_end=4024
  _RELOADCONFIGREQUEST._serialized_start=4026
  _RELOADCONFIGREQUEST._serialized_end=4102
  _RELOADCONFIGRESPONSE._serialized_start=4104
  _RELOADCONFIGRESPONSE._serialized_end=4175
  _SESSIONRUNREQUEST._serialized_start=4178
  _SESSIONRUNREQUEST._serialized_end=4323
  _SESSIONRUNRESPONSE._serialized_start=4325
  _SESSIONRUNRESPONSE._serialized_end=4391
# @@protoc_insertion_point(module_scope)
