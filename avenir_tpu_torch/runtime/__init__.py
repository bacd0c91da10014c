"""Runtime: the native CSV encoder and the device feeder."""

from avenir_tpu_torch.runtime.feeder import DeviceFeeder, prefetch_encoded

__all__ = ["DeviceFeeder", "prefetch_encoded"]
