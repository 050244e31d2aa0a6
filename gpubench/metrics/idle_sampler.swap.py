"""idle_sampler.swap: the sub-window's share with the device idle while the host is inside the sampler loop (stages.idle_in)."""
from gpubench.stages import idle_in


def read(ctx):
    return idle_in(ctx, ("swap.sample",))
