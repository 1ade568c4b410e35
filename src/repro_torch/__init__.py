"""PyTorch/CUDA port of the PrfaaS serving path (one NVIDIA H100).

A second package beside the JAX reference ``repro``: same module names, same
cache pytrees, same routing control plane, with the reference's Pallas
kernels replaced by hand-written Hopper kernels under ``csrc/``.  It imports
``torch`` and never ``jax`` or ``repro``.
"""
