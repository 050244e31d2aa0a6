"""device_idle.train: the profiled sub-window's share with nothing on the device (readers.device_idle)."""
from gpubench.readers import device_idle as read  # noqa: F401
