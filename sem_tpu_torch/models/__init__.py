"""PDE discipline solvers (convection-diffusion, Navier-Stokes)."""
