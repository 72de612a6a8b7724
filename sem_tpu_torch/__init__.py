"""sem_tpu_torch — the PyTorch / CUDA port of ``sem_tpu`` for one NVIDIA H100.

The steady coupled Boussinesq solve of ``sem_tpu`` (GLL spectral elements,
matrix-free operators, fast-diagonalization preconditioners, f32 Krylov
chunks inside f64 iterative refinement, CD and NS solvers, the GS/NJ/JNK
coupling engine) on torch tensors, with the two TPU kernels of the solve path
rewritten by hand in CUDA C++ for Hopper (``sem_tpu_torch/csrc``).  The JAX
package stays the reference the port is tested against; this package never
imports JAX.

Every solver and state takes an explicit ``device`` and every tensor an
explicit dtype: the solvers run in float64, as ``sem_tpu`` does with x64
enabled, with float32 only inside the Krylov chunks.  TF32 is switched off
for matmuls and cuDNN: reduced-precision f32 products stall GMRES and pollute
converged solutions (see ``sem_tpu.operators.mm_precision``).  Nothing on the
solve path needs autograd; the solvers run under ``torch.no_grad()``.  The
implicit adjoints (:mod:`sem_tpu_torch.coupling.implicit`) use autograd off
that path: they record graphs of the coupled residual and of the f64
preconditioner's linear apply only, and launch no CUDA kernel.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from sem_tpu_torch import gll  # noqa: E402
from sem_tpu_torch.mesh import Grid2D  # noqa: E402
from sem_tpu_torch import operators  # noqa: E402
from sem_tpu_torch.krylov import cg, gmres  # noqa: E402
from sem_tpu_torch.fdm import FDM2D  # noqa: E402
from sem_tpu_torch.models.convection_diffusion import (  # noqa: E402
    ConvectionDiffusionSolver)
from sem_tpu_torch.models.navier_stokes import NavierStokesSolver  # noqa: E402

__version__ = "0.1.0"

__all__ = ["gll", "Grid2D", "operators", "gmres", "cg", "FDM2D",
           "ConvectionDiffusionSolver", "NavierStokesSolver"]
