"""s1s2_torch — the PyTorch/CUDA port of the s1s2 diffusion super-resolution
package, for one NVIDIA H100.

The layout mirrors the JAX package (``core/``, ``ops/``, ``models/``,
``sampling/``, ``eval/``, ``data/``, ``train/``, ``cli/``). Public functions keep its
NHWC activations and HWIO weights. The hot ops are hand-written CUDA kernels
(``ops/csrc/``), built with ``nvcc`` at first use and loaded with ``ctypes``;
each has a plain PyTorch version beside it that runs when the tensor lies on
the CPU. Entry points default to ``device="cuda"``.

This package imports torch, numpy and the standard library only.
"""
