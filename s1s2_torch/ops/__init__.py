"""Hot ops: hand-written CUDA kernels (``csrc/``) with plain PyTorch
versions beside them, and the pixel-shuffle reshapes."""
