"""The frozen test-bench pair datasets, CelebA-HQ, FFHQ and FF++ style (port
of reface_tpu/data/test_bench.py).

- Pair lists (ldm/data/test_bench_dataset.py): CelebA targets 28000+i with
  sources 29000+i (:179-190), FFHQ 68000+i with 69000+i (:505-512), FF++
  from the `pairs.txt` shipped with the prepared data (:651-701).
- The item recipe (:200-368): on the target side a keep-mask from the
  remove_tar classes and inpaint = GT x keep-mask (no TPS at test time); on
  the reference side the source image times its preserve_src-class mask,
  CLIP-normalized at 224, with no augmentation; an optional prior image
  (load_prior, :357-363).

The reads are cv2's (imread, INTER_LINEAR, INTER_NEAREST), through
io/images.py. Items are swap-ready dicts of HWC float32 arrays:
  {target_image, inpaint_image, inpaint_mask, ref_clip224, target_id,
   source_id[, prior_image]}
"""

from __future__ import annotations

import dataclasses
import os.path as osp

import numpy as np

from reface_tpu_torch.data.augment import clip_normalize_np, to_tensor_pm1
from reface_tpu_torch.io.images import imread, resize_linear, resize_nearest
from reface_tpu_torch.preprocess.masks import (
    DEFAULT_PRESERVE_CELEBA,
    DEFAULT_PRESERVE_CELEBA_SRC_TEST,
)

__all__ = ["TestBenchConfig", "TestBenchDataset"]


@dataclasses.dataclass(frozen=True)
class TestBenchConfig:
    __test__ = False  # not a pytest class

    dataset_dir: str
    dataset: str = "celeba"  # celeba | ffhq | ff
    image_size: int = 512
    num_pairs: int = 1000
    remove_tar: tuple = DEFAULT_PRESERVE_CELEBA
    preserve_src: tuple = DEFAULT_PRESERVE_CELEBA_SRC_TEST
    # a dir of {target_id}.png/.jpg images to q-sample the sampler's start
    # from (load_prior, test_bench_dataset.py:357-363); None = off
    prior_dir: str | None = None

    def pair_ids(self):
        if self.dataset == "celeba":
            t0, s0 = 28000, 29000
        elif self.dataset == "ffhq":
            t0, s0 = 68000, 69000
        elif self.dataset == "ff":
            with open(osp.join(self.dataset_dir, "pairs.txt")) as f:
                pairs = [tuple(map(int, line.split())) for line in f if line.strip()]
            return pairs[: self.num_pairs]
        else:
            raise ValueError(f"unknown test bench dataset {self.dataset!r}")
        return [(t0 + i, s0 + i) for i in range(self.num_pairs)]

    def img_path(self, idx: int) -> str:
        if self.dataset == "celeba":
            return osp.join(self.dataset_dir, "CelebA-HQ-img", f"{idx}.jpg")
        if self.dataset == "ff":
            return osp.join(self.dataset_dir, "images", f"{idx:05d}.png")
        return osp.join(self.dataset_dir, "images512", f"{idx:05d}.png")

    def mask_path(self, idx: int) -> str:
        if self.dataset == "celeba":
            return osp.join(self.dataset_dir, "CelebA-HQ-mask", "Overall_mask", f"{idx}.png")
        if self.dataset == "ff":
            return osp.join(self.dataset_dir, "masks", f"{idx:05d}.png")
        return osp.join(self.dataset_dir, "BiSeNet_mask", f"{idx:05d}.png")


class TestBenchDataset:
    __test__ = False  # not a pytest class

    def __init__(self, config: TestBenchConfig):
        self.cfg = config
        self.pairs = config.pair_ids()

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index: int) -> dict:
        cfg = self.cfg
        tid, sid = self.pairs[index]
        s = cfg.image_size

        timg, tmask = imread(cfg.img_path(tid)), imread(cfg.mask_path(tid), gray=True)
        simg, smask = imread(cfg.img_path(sid)), imread(cfg.mask_path(sid), gray=True)

        keep = 1.0 - np.isin(tmask, cfg.remove_tar).astype(np.float32)
        keep = resize_linear(keep, s, s)
        gt = to_tensor_pm1(resize_linear(timg, s, s))
        inpaint = gt * keep[..., None]

        sface = np.isin(smask, cfg.preserve_src).astype(np.float32)
        simg01 = simg.astype(np.float32) / 255.0
        if sface.shape[:2] != simg01.shape[:2]:
            sface = resize_nearest(sface, *simg01.shape[:2])
        ref = clip_normalize_np(resize_linear(simg01 * sface[..., None], 224, 224))

        item = {
            "target_image": gt.astype(np.float32),
            "inpaint_image": inpaint.astype(np.float32),
            "inpaint_mask": keep[..., None].astype(np.float32),
            "ref_clip224": ref.astype(np.float32),
            "target_id": np.int32(tid),
            "source_id": np.int32(sid),
        }
        if cfg.prior_dir is not None:
            item["prior_image"] = self._load_prior(tid, s)
        return item

    def _load_prior(self, tid: int, s: int) -> np.ndarray:
        """The prior image in [-1, 1] at image_size (test_bench_dataset.py:
        357-360)."""
        for name in (f"{tid}.png", f"{tid}.jpg", f"{tid:05d}.png", f"{str(tid).zfill(12)}.jpg"):
            p = osp.join(self.cfg.prior_dir, name)
            if osp.exists(p):
                return to_tensor_pm1(resize_linear(imread(p), s, s)).astype(np.float32)
        raise FileNotFoundError(f"no prior image for target {tid} in {self.cfg.prior_dir}")
