"""launches.train: device kernels of the profiled sub-window per unit of work (readers.launches)."""
from gpubench.readers import launches as read  # noqa: F401
