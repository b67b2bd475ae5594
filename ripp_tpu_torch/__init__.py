"""ripp_tpu_torch: the PyTorch/CUDA port of ripp_tpu.

Same sub-package layout as the JAX package (host/ ops/ models/ native/
utils/).
Plain tensor code is PyTorch; the kernels the JAX package wrote in Pallas
are CUDA C++ under csrc/, built with nvcc at first use and bound with
ctypes (utils/build.py). Imports torch and numpy only; never jax and
nothing of ripp_tpu.
"""

__version__ = "0.1.0"
