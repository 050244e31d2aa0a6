"""FFHQ train/val dataset — the CelebA-HQ recipe over the FFHQ layout (port
of reface_tpu/data/ffhq.py).

Parity target: ldm/data/ffhq.py:382-538 — images at {dir}/images512/{i:05d}.png
with BiSeNet 19-class masks at {dir}/BiSeNet_mask/{i:05d}.png, 68k/2k split,
class lists in face-parsing.PyTorch's ordering.
"""

from __future__ import annotations

import dataclasses
import os.path as osp

from reface_tpu_torch.data.celeba import CelebAHQConfig, CelebAHQDataset

__all__ = ["FFHQConfig", "FFHQDataset", "DEFAULT_PRESERVE_FFHQ_19"]

# face-parsing.PyTorch ids of the shipped FFHQ preserve recipe (skin, brows,
# eyes, ears, nose, mouth, lips, neck: project.yaml:205-224's seg12 in the
# 19-class vocabulary)
DEFAULT_PRESERVE_FFHQ_19 = (1, 2, 3, 4, 5, 7, 8, 10, 11, 12, 13, 14)


@dataclasses.dataclass(frozen=True)
class FFHQConfig:
    dataset_dir: str
    state: str = "train"
    image_size: int = 512
    preserve: tuple = DEFAULT_PRESERVE_FFHQ_19
    data_seed: int = 0
    train_count: int = 68000
    eval_count: int = 2000


class FFHQDataset(CelebAHQDataset):
    def __init__(self, config: FFHQConfig):
        self.cfg = CelebAHQConfig(
            dataset_dir=config.dataset_dir, state=config.state,
            image_size=config.image_size, preserve=config.preserve,
            data_seed=config.data_seed, train_count=config.train_count,
            eval_count=config.eval_count)
        self.ids = self._ids(config)
        d = config.dataset_dir
        self.imgs = [osp.join(d, "images512", f"{i:05d}.png") for i in self.ids]
        self.masks = [osp.join(d, "BiSeNet_mask", f"{i:05d}.png") for i in self.ids]
