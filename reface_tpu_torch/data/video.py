"""Pre-cropped video-frame dataset (port of reface_tpu/data/video.py).

Parity target: ldm/data/video_swap_dataset.py:86-243 — a directory of
aligned frame crops and a directory of (BiSeNet 19-class or seg12) masks,
giving the same swap-ready target-side arrays as the test bench, with the
FFHQ seg-12 class list. The frames are the directory's lowercase `*.png`
then `*.jpg` files, sorted together, as the JAX dataset globs them; the
mask of `name.ext` is `name.png`. The reads are cv2's (imread in colour
and in gray, INTER_LINEAR on uint8 and on float32) through io/images.py.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from reface_tpu_torch.data.augment import to_tensor_pm1
from reface_tpu_torch.io.images import imread, resize_linear
from reface_tpu_torch.preprocess.masks import DEFAULT_PRESERVE_FFHQ_SEG12

__all__ = ["VideoFramesConfig", "VideoFramesDataset"]


@dataclasses.dataclass(frozen=True)
class VideoFramesConfig:
    frames_dir: str
    masks_dir: str
    image_size: int = 512
    remove_classes: tuple = DEFAULT_PRESERVE_FFHQ_SEG12  # seg12 face classes


class VideoFramesDataset:
    """Items {target_image, inpaint_image, inpaint_mask} (HWC float32, the
    images in [-1, 1], the mask 1 = keep) and `index` (int32)."""

    def __init__(self, config: VideoFramesConfig):
        self.cfg = config
        self.frames = sorted(
            glob.glob(os.path.join(config.frames_dir, "*.png"))
            + glob.glob(os.path.join(config.frames_dir, "*.jpg"))
        )

    def __len__(self):
        return len(self.frames)

    def _mask_path(self, frame_path: str) -> str:
        base = os.path.splitext(os.path.basename(frame_path))[0]
        return os.path.join(self.cfg.masks_dir, base + ".png")

    def __getitem__(self, index: int) -> dict:
        cfg = self.cfg
        s = cfg.image_size
        img = imread(self.frames[index])
        mask = imread(self._mask_path(self.frames[index]), gray=True)
        keep = 1.0 - np.isin(mask, cfg.remove_classes).astype(np.float32)
        keep = resize_linear(keep, s, s)
        gt = to_tensor_pm1(resize_linear(img, s, s))
        return {
            "target_image": gt.astype(np.float32),
            "inpaint_image": (gt * keep[..., None]).astype(np.float32),
            "inpaint_mask": keep[..., None].astype(np.float32),
            "index": np.int32(index),
        }
