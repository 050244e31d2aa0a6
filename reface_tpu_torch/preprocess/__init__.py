"""The raw-image path's preprocessing (port of reface_tpu/preprocess):
alignment and paste-back warps, face boxes from parsing masks, and the
segmentation vocabularies. The TPS mask warp (preprocess/tps.py) feeds
training-time augmentation and is not ported yet (ROADMAP A12c)."""
