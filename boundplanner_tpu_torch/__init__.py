"""PyTorch + CUDA port of ``boundplanner_tpu`` (closed-loop fleet MPC slice).

Module paths and function names mirror the JAX package so each function's
counterpart is easy to find. The JAX package stays the reference; this
package imports ``torch`` and, of the JAX package, only the numpy-only
``boundplanner_tpu.config``.

The two Pallas TPU kernels of the main path are hand-written CUDA kernels
for Hopper (``csrc/``), built with ``nvcc`` at first use and loaded with
``ctypes`` (``ops/_build.py``):

- ``ops.linalg.kkt_inverse``        -> ``csrc/chol_inverse.cu``
- ``ops.cuda_proj.line_polytope_projection`` -> ``csrc/line_polytope.cu``
"""

import torch

# The reference's f32 products are full f32: never let cuBLAS/cuDNN drop to
# TF32 (about three decimal digits) behind the solver's back.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
