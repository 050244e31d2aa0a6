"""idle_forward.train: the sub-window's share with the device idle while the host is in the step's forward (stages.idle_in)."""
from gpubench.stages import idle_in


def read(ctx):
    return idle_in(ctx, ("train.forward",))
