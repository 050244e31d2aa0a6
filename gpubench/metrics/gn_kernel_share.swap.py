"""gn_kernel_share.swap: K3's share of the GroupNorm calls made on the card in the profiled
sub-window, in %: K3's launches (`group_norm_silu`) over those plus the plain version's calls
(`group_norm_plain`), summed over the program's span records in the sub-window. None where
neither is counted."""
from gpubench import stages


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    w0, w1 = tr.window
    counts = [r[5] for r in stages.recorded() if r[3] < w1 and r[4] > w0]
    k3 = sum(c.get("group_norm_silu", 0) for c in counts)
    plain = sum(c.get("group_norm_plain", 0) for c in counts)
    return 100.0 * k3 / (k3 + plain) if k3 + plain else None
