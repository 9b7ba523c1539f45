"""LVD-GS on PyTorch and CUDA: Gaussian-splatting SLAM for an NVIDIA H100.

The port of ``lvdgs_tpu`` (the JAX/TPU reference package, kept beside it).
Module paths mirror the reference one to one. The tile blend runs in
hand-written CUDA kernels (``lvdgs_torch/csrc``), built with nvcc at first
use; on CPU tensors their plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
