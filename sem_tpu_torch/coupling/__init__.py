"""Multidisciplinary coupling layer: components, the GS/NJ/JNK MDA engine,
and the Boussinesq drivers."""
from sem_tpu_torch.coupling.components import (ConvectionDiffusionComponent,
                                               NavierStokesComponent)
from sem_tpu_torch.coupling.mda import BoussinesqMDA, CoupledState, MDAStats
from sem_tpu_torch.coupling.boussinesq import (build_coupled, run,
                                               run_parallel)

__all__ = ["ConvectionDiffusionComponent", "NavierStokesComponent",
           "BoussinesqMDA", "CoupledState", "MDAStats", "run",
           "run_parallel", "build_coupled"]
