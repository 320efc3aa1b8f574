# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: nhd_stats.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fnhd_stats.proto\x12\x08NhdStats\"\x18\n\x05\x45mpty\x12\x0f\n\x07nothing\x18\x01 \x01(\r\"0\n\x0cNICInfoBrief\x12\x0f\n\x07used_rx\x18\x01 \x01(\r\x12\x0f\n\x07used_tx\x18\x02 \x01(\r\"\xe2\x01\n\x08NodeInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tfree_cpus\x18\x02 \x01(\r\x12\x11\n\tused_cpus\x18\x03 \x01(\r\x12\x11\n\tfree_gpus\x18\x04 \x01(\r\x12\x11\n\tused_gpus\x18\x05 \x01(\r\x12\x16\n\x0e\x66ree_hugepages\x18\x06 \x01(\r\x12\x16\n\x0eused_hugepages\x18\x07 \x01(\r\x12\x12\n\ntotal_pods\x18\x08 \x01(\r\x12(\n\x08nic_info\x18\t \x03(\x0b\x32\x16.NhdStats.NICInfoBrief\x12\x0e\n\x06\x61\x63tive\x18\n \x01(\x08\"R\n\tNodeStats\x12#\n\x06status\x18\x01 \x01(\x0e\x32\x13.NhdStats.NHDStatus\x12 \n\x04info\x18\x02 \x03(\x0b\x32\x12.NhdStats.NodeInfo\"T\n\x0eSchedulerStats\x12#\n\x06status\x18\x01 \x01(\x0e\x32\x13.NhdStats.NHDStatus\x12\x1d\n\x15\x66\x61iled_schedule_count\x18\x02 \x01(\r\"\x9b\x02\n\x07PodInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04node\x18\x02 \x01(\t\x12\x37\n\x0b\x61nnotations\x18\x03 \x03(\x0b\x32\".NhdStats.PodInfo.AnnotationsEntry\x12\x11\n\tnamespace\x18\x04 \x01(\t\x12\x12\n\nmisc_cores\x18\x05 \x03(\r\x12\x12\n\nproc_cores\x18\x06 \x03(\r\x12\x19\n\x11proc_helper_cores\x18\x07 \x03(\r\x12\x0c\n\x04gpus\x18\x08 \x03(\r\x12\x10\n\x08nic_macs\x18\t \x03(\t\x12\x11\n\thugepages\x18\n \x01(\r\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"P\n\x08PodStats\x12#\n\x06status\x18\x01 \x01(\x0e\x32\x13.NhdStats.NHDStatus\x12\x1f\n\x04info\x18\x02 \x03(\x0b\x32\x11.NhdStats.PodInfo\"\x17\n\x07NodeReq\x12\x0c\n\x04name\x18\x01 \x01(\t\"j\n\x11\x44\x65tailedNodeStats\x12#\n\x06status\x18\x01 \x01(\x0e\x32\x13.NhdStats.NHDStatus\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\"\n\x07podinfo\x18\x03 \x03(\x0b\x32\x11.NhdStats.PodInfo*2\n\tNHDStatus\x12\x11\n\rNHD_STATUS_OK\x10\x00\x12\x12\n\x0eNHD_STATUS_ERR\x10\x01\x32\x8b\x02\n\nNHDControl\x12;\n\x11GetBasicNodeStats\x12\x0f.NhdStats.Empty\x1a\x13.NhdStats.NodeStats\"\x00\x12@\n\x11GetSchedulerStats\x12\x0f.NhdStats.Empty\x1a\x18.NhdStats.SchedulerStats\"\x00\x12\x34\n\x0bGetPodStats\x12\x0f.NhdStats.Empty\x1a\x12.NhdStats.PodStats\"\x00\x12H\n\x14GetDetailedNodeStats\x12\x11.NhdStats.NodeReq\x1a\x1b.NhdStats.DetailedNodeStats\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'nhd_stats_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODINFO_ANNOTATIONSENTRY._options = None
  _PODINFO_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _NHDSTATUS._serialized_start=1005
  _NHDSTATUS._serialized_end=1055
  _EMPTY._serialized_start=29
  _EMPTY._serialized_end=53
  _NICINFOBRIEF._serialized_start=55
  _NICINFOBRIEF._serialized_end=103
  _NODEINFO._serialized_start=106
  _NODEINFO._serialized_end=332
  _NODESTATS._serialized_start=334
  _NODESTATS._serialized_end=416
  _SCHEDULERSTATS._serialized_start=418
  _SCHEDULERSTATS._serialized_end=502
  _PODINFO._serialized_start=505
  _PODINFO._serialized_end=788
  _PODINFO_ANNOTATIONSENTRY._serialized_start=738
  _PODINFO_ANNOTATIONSENTRY._serialized_end=788
  _PODSTATS._serialized_start=790
  _PODSTATS._serialized_end=870
  _NODEREQ._serialized_start=872
  _NODEREQ._serialized_end=895
  _DETAILEDNODESTATS._serialized_start=897
  _DETAILEDNODESTATS._serialized_end=1003
  _NHDCONTROL._serialized_start=1058
  _NHDCONTROL._serialized_end=1325
# @@protoc_insertion_point(module_scope)
