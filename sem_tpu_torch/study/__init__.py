"""Study scripts of the port, run as ``python -m sem_tpu_torch.study.<name>``
(``--device cpu`` / ``-device cpu`` for the CPU; the card by default):
``boussinesq_run`` (the parameter-sweep CLI, with checkpoints), ``summarize``
(the iteration-count table of its output directories), ``adjoint_hi`` (the
implicit adjoint at a checkpointed state), ``centerline`` (de Vahl Davis
centerline anchors of a field ``.npz``), ``north_star`` (the p-continuation
ladder to the p16 64×64 solve), ``krylov_econ`` (NS inner iterations, DGKS
resweeps and a phase split), ``ns_scale`` (standalone NS solves across
resolutions), ``ptc_band_probe`` (the coupled FGMRES inside a PTC Δt band,
from a checkpoint), and the host-only SciPy studies ``schur_spectrum`` and
``coupled_pc_diag`` (Schur-block and coupled-preconditioner candidates)."""
