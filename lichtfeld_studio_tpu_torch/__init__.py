"""LichtFeld-Studio on PyTorch and CUDA: the port of the JAX package
`lichtfeld_studio_tpu` to one NVIDIA H100.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on a
ported path becomes a CUDA C++ kernel for sm_90a (`csrc/`), built with nvcc
at first use and bound with ctypes (`kernels/_build.py`). Each kernel
wrapper runs its plain PyTorch version for CPU tensors only.

This module imports nothing heavy: `import lichtfeld_studio_tpu_torch` loads
neither torch nor the kernels.
"""

__version__ = "0.1.0"
