"""ddpca_admm_tpu_torch — the PyTorch/CUDA port of ``ddpca_admm_tpu``.

3-D linear-elastic multibody frictional contact solved by an ADMM domain
decomposition with batched multigrid-preconditioned Krylov subdomain solves,
written for one NVIDIA H100.  The host setup (meshing, contact search,
assembly) is NumPy/SciPy, copied from the JAX package so that this package
never imports it or JAX.  The solve is plain PyTorch on tensors, except the
PlaneDia SpMV and the Block-ELL SpMV, which are hand-written CUDA kernels
(``csrc/plane_dia.cu``, ``csrc/block_ell.cu``).

Sub-packages carry the JAX package's names, so each module's counterpart is
found at the same path.

Precision: float64 is explicit wherever it is used (there is no global
default-dtype switch).  TF32 is off, the counterpart of the JAX package's
``jax_default_matmul_precision="highest"``: the coarse inverse applies and
the solver algebra need full-precision products.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
