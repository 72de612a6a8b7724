"""PDE discipline solvers (convection-diffusion, Navier-Stokes)."""
from sem_tpu_torch.models.convection_diffusion import ConvectionDiffusionSolver
from sem_tpu_torch.models.navier_stokes import NavierStokesSolver

__all__ = ["ConvectionDiffusionSolver", "NavierStokesSolver"]
