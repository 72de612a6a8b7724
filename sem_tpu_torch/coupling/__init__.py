"""Multidisciplinary coupling layer: components, the GS/NJ/JNK/PTC MDA
engine, and the Boussinesq entry points."""
from sem_tpu_torch.coupling.components import (ConvectionDiffusionComponent,
                                               NavierStokesComponent)
from sem_tpu_torch.coupling.mda import BoussinesqMDA, CoupledState, MDAStats
from sem_tpu_torch.coupling.boussinesq import (build_coupled, run,
                                               run_parallel, solve_continued,
                                               solve_ra_continued)

__all__ = ["ConvectionDiffusionComponent", "NavierStokesComponent",
           "BoussinesqMDA", "CoupledState", "MDAStats", "run",
           "run_parallel", "build_coupled", "solve_continued",
           "solve_ra_continued"]
