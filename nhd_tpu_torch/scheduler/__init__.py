from nhd_tpu_torch.scheduler.events import WatchQueue, WatchType
from nhd_tpu_torch.scheduler.core import PodStatus, Scheduler
from nhd_tpu_torch.scheduler.controller import Controller

__all__ = ["Controller", "PodStatus", "Scheduler", "WatchQueue", "WatchType"]
