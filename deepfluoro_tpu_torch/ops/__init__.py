"""Tensor primitives and the one hand-written kernel (``ops/warp.py``).
Importing this package builds nothing: the CUDA kernel is compiled at its
first launch."""
