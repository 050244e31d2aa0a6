"""The port's command-line drivers (port of reface_tpu/cli/)."""
