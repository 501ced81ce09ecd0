"""Small-matrix linear algebra and the hand-written CUDA kernels."""
