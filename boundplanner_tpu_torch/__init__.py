"""PyTorch + CUDA port of ``boundplanner_tpu``: the closed-loop fleet MPC,
the fleet planner and the single-arm runtime (``mpc.MPCNode``).

Module paths and function names mirror the JAX package so each function's
counterpart is easy to find. The JAX package stays the reference; this
package imports ``torch`` and nothing of JAX or of the JAX package: it
keeps its own copies of what it needs (``config``, ``native_geom``).
Its entry points run on the card unless the caller passes
``device="cpu"``.

The two Pallas TPU kernels of the port's paths are hand-written CUDA kernels
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
