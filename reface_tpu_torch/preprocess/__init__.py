"""The raw-image path's preprocessing (port of reface_tpu/preprocess):
alignment and paste-back warps, face boxes from parsing masks, and the
segmentation vocabularies. The training datasets' TPS mask warp is
data/augment.py's (on the host); tps.py's device TPS feeds the priors of
priors.py (cli.prepare_data make-priors) and random_tps_mask_warp, the JAX
package's device form of that warp."""

from reface_tpu_torch.preprocess.tps import random_tps_mask_warp, tps_mask_warp

__all__ = ["random_tps_mask_warp", "tps_mask_warp"]
