"""reface_tpu_torch: the PyTorch/CUDA port of reface_tpu for NVIDIA Hopper.

It mirrors reface_tpu's layout (core, ops, nn, diffusion, parallel,
pipelines, ckpt) and never imports JAX or reface_tpu. Each Pallas kernel of
the JAX package on the ported path is a hand-written CUDA kernel under
csrc/, built with nvcc on first use (ops/kernels.py). Entry points run on
CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
