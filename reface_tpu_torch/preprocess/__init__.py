"""The raw-image path's preprocessing (port of reface_tpu/preprocess):
alignment and paste-back warps, face boxes from parsing masks, and the
segmentation vocabularies. The training datasets' TPS mask warp is
data/augment.py's; preprocess/tps.py's jnp TPS feeds the priors, which wait
for ROADMAP A13."""
