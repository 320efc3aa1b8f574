from nhd_tpu_torch.k8s.interface import ClusterBackend, EventType, PodEvent, WatchEvent

__all__ = ["ClusterBackend", "EventType", "PodEvent", "WatchEvent"]
