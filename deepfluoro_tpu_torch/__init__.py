"""DeepFluoro on PyTorch and CUDA: the port of ``deepfluoro_tpu`` to one
NVIDIA H100.

The JAX package ``deepfluoro_tpu`` stays the reference; each module here
names its JAX counterpart and is held against it by
``tests/test_torch_port_*.py``. This package imports ``torch`` and numpy and
never JAX. The one TPU kernel of the JAX package, the Pallas affine warp,
is a CUDA C++ kernel here (``csrc/affine_warp.cu``, bound by
``ops/warp.py``).

Layout at public functions follows the JAX package: images ``(B, H, W)``,
landmarks ``(B, 2, L)``. The U-Net and the tensors fed to it are NCHW, the
layout of the reference's ``.pt`` checkpoints.
"""

__version__ = "0.1.0"
