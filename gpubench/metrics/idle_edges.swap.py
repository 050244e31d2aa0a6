"""idle_edges.swap: the sub-window's share with the device idle while the host conditions, encodes or decodes the batch (stages.idle_in)."""
from gpubench.stages import idle_in


def read(ctx):
    return idle_in(ctx, ("swap.condition", "swap.encode", "swap.decode"))
