"""mfu.swap: model FLOPs of the measured window over its seconds at the bf16 peak (readers.mfu)."""
from gpubench.readers import mfu as read  # noqa: F401
