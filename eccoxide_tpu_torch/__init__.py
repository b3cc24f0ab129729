"""eccoxide_tpu_torch: the elliptic-curve library on PyTorch, with its
group kernels written in CUDA for Hopper. Importing the package imports
nothing else; its modules import torch."""

__version__ = "0.1.0"
