"""CelebAMask-HQ train/val/test dataset, host-side numpy (port of
reface_tpu/data/celeba.py).

Parity targets (semantics, not code):
  - file layout + 28k/2k/2k split: ldm/data/celebA.py:376-405
    ({dir}/CelebA-HQ-img/{i}.jpg, {dir}/CelebA-HQ-mask/Overall_mask/{i}.png)
  - gray-mask item recipe: celebA.py:412-493 —
      keep-mask  = 1 - isin(mask19, preserve)
      TPS-warp the keep-mask (decow, scale~U(0.5,1))
      inpaint    = GT * keep-mask
      reference  = CLIP-normalized GT masked to the face region, then
                   augmented (resize 224 / flip / rotate / blur / elastic)
  - black-mask item recipe (gray_outer_mask: False, celebA.py:405-409 ->
    495-557): the same keep-mask and reference, but no decow TPS warp of the
    inpaint mask (the mask follows the parsing classes exactly)
  - shipped class lists: configs/train.yaml:108-133

Reads go through io/images.py (cv2's decode, INTER_LINEAR and INTER_NEAREST
resizes), and each item draws from its own np.random.Generator seeded with
SeedSequence([data_seed, index]), as the JAX package's does.

Returns per item (all HWC float32 numpy):
  {GT: (S,S,3) in [-1,1], inpaint_image: (S,S,3), inpaint_mask: (S,S,1),
   ref_imgs: (224,224,3) CLIP-normalized, index: int32}
"""

from __future__ import annotations

import dataclasses
import os.path as osp

import numpy as np

from reface_tpu_torch.data.augment import (
    augment_reference_np,
    clip_normalize_np,
    to_tensor_pm1,
    tps_warp_mask_np,
)
from reface_tpu_torch.io.images import imread, resize_linear, resize_nearest
from reface_tpu_torch.preprocess.masks import DEFAULT_PRESERVE_CELEBA

__all__ = ["CelebAHQConfig", "CelebAHQDataset"]


@dataclasses.dataclass(frozen=True)
class CelebAHQConfig:
    dataset_dir: str
    state: str = "train"  # train | validation | test
    image_size: int = 512
    preserve: tuple = DEFAULT_PRESERVE_CELEBA
    data_seed: int = 0
    tps_scale_range: tuple = (0.5, 1.0)
    train_count: int = 28000
    eval_count: int = 2000
    # True = __getitem_gray__ recipe (shipped default); False = the
    # __getitem_black__ recipe: no decow TPS warp of the inpaint mask
    gray_outer_mask: bool = True


class CelebAHQDataset:
    def __init__(self, config: CelebAHQConfig):
        self.cfg = config
        self.ids = self._ids(config)
        d = config.dataset_dir
        self.imgs = [osp.join(d, "CelebA-HQ-img", f"{i}.jpg") for i in self.ids]
        self.masks = [osp.join(d, "CelebA-HQ-mask", "Overall_mask", f"{i}.png")
                      for i in self.ids]

    @staticmethod
    def _ids(cfg) -> list:
        if cfg.state == "train":
            return list(range(cfg.train_count))
        return list(range(cfg.train_count, cfg.train_count + cfg.eval_count))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.data_seed, index]))
        img = imread(self.imgs[index])  # native 1024 or any size
        mask19 = imread(self.masks[index], gray=True)

        face = np.isin(mask19, cfg.preserve)
        keep = 1.0 - face.astype(np.float32)  # 1 = keep, 0 = inpaint region

        s = cfg.image_size
        gt = to_tensor_pm1(resize_linear(img, s, s))
        keep_s = resize_linear(keep, s, s)
        if cfg.state == "train" and cfg.gray_outer_mask:
            scale = rng.uniform(*cfg.tps_scale_range)
            keep_s = tps_warp_mask_np(keep_s, rng, scale=scale)
        inpaint = gt * keep_s[..., None]

        # reference: face pixels of the full-res image, augmented, CLIP-normed
        img01 = img.astype(np.float32) / 255.0
        n = img.shape[0]
        face_full = resize_nearest(face.astype(np.float32), n, n)
        ref01 = img01 * face_full[..., None]
        if cfg.state == "train":
            ref01 = augment_reference_np(ref01, rng)
        else:
            ref01 = resize_linear(ref01, 224, 224)
        ref = clip_normalize_np(ref01)

        return {
            "GT": gt.astype(np.float32),
            "inpaint_image": inpaint.astype(np.float32),
            "inpaint_mask": keep_s[..., None].astype(np.float32),
            "ref_imgs": ref.astype(np.float32),
            "index": np.int32(self.ids[index]),
        }
