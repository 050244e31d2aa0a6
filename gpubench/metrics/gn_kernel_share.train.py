"""gn_kernel_share.train: gn_kernel_share.swap's reading of the profiled training step."""
from gpubench.harness import reader

read = reader("gn_kernel_share.swap")
