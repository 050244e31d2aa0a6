"""idle_update.train: the sub-window's share with the device idle while the host is in AdamW and the EMA (stages.idle_in)."""
from gpubench.stages import idle_in


def read(ctx):
    return idle_in(ctx, ("train.update",))
