"""Host-side data of the port (port of reface_tpu/data): the frozen test
bench and the prefetching loader. The training datasets (CelebA-HQ, FFHQ,
the synthetic trees) and their augmentation are not ported yet (ROADMAP
A12c)."""

from reface_tpu_torch.data.test_bench import TestBenchConfig, TestBenchDataset
from reface_tpu_torch.data.loader import PrefetchLoader, collate

__all__ = ["TestBenchConfig", "TestBenchDataset", "PrefetchLoader", "collate"]
