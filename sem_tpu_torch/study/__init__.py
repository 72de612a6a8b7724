"""Study scripts of the port, run as ``python -m sem_tpu_torch.study.<name>``:
``boussinesq_run`` (the parameter-sweep CLI, with checkpoints), ``summarize``
(the iteration-count table of its output directories) and ``adjoint_hi`` (the
implicit adjoint at a checkpointed state)."""
