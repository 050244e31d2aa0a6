"""The benchmark of reface_tpu_torch on an NVIDIA H100 (README.md)."""
