"""Host-side data of the port (port of reface_tpu/data): the CelebA-HQ and
FFHQ training datasets with their augmentation, the synthetic trees and
landmark faces, the frozen test bench, the pre-cropped video frames and the
prefetching loader. Whole videos are read and written by io/video.py."""

from reface_tpu_torch.data.celeba import CelebAHQConfig, CelebAHQDataset
from reface_tpu_torch.data.ffhq import FFHQConfig, FFHQDataset
from reface_tpu_torch.data.loader import PrefetchLoader, collate
from reface_tpu_torch.data.synthetic import (
    make_landmark_faces,
    make_synthetic_celeba,
    make_synthetic_ffhq,
)
from reface_tpu_torch.data.test_bench import TestBenchConfig, TestBenchDataset
from reface_tpu_torch.data.video import VideoFramesConfig, VideoFramesDataset

__all__ = ["CelebAHQConfig", "CelebAHQDataset", "FFHQConfig", "FFHQDataset",
           "PrefetchLoader", "collate", "make_synthetic_celeba", "make_synthetic_ffhq",
           "make_landmark_faces",
           "TestBenchConfig", "TestBenchDataset", "VideoFramesConfig", "VideoFramesDataset"]
