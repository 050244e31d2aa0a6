"""attn_roofline.train: attention calls' least time over the attention bucket's device time (readers.roofline_attention)."""
from gpubench.readers import roofline_attention as read  # noqa: F401
