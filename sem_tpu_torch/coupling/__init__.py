"""Multidisciplinary coupling layer: components, the GS/NJ/JNK MDA engine,
and the Boussinesq drivers."""
from sem_tpu_torch.coupling.components import (ConvectionDiffusionComponent,
                                               NavierStokesComponent)
from sem_tpu_torch.coupling.mda import BoussinesqMDA, CoupledState, MDAStats
from sem_tpu_torch.coupling.boussinesq import run, build_coupled

__all__ = ["ConvectionDiffusionComponent", "NavierStokesComponent",
           "BoussinesqMDA", "CoupledState", "MDAStats", "run",
           "build_coupled"]
