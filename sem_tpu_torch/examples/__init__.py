"""The port's examples, run as ``python -m sem_tpu_torch.examples.<name>``:
counterparts of the JAX package's ``examples/`` with the same flags,
configurations, printed lines and ``--check`` assertions, plus ``--device``
(``cuda`` by default; the CPU only with ``--device cpu``).

* ``convection_diffusion``: circular flow in a box, Pe=40, P=4 16×16
  (kernel B1 on the card);
* ``navier_stokes``: lid-driven cavity against the Ghia, Ghia & Shin (1982)
  table, Re=400 16×16 or ``--quick`` Re=100 8×8 (kernel B2);
* ``boussinesq_sequential``: the coupled heated cavity against de Vahl Davis
  (1983), ``--mode GS|NJ|JNK``, 8×8 or ``--quick`` 4×4 (B1 and B2);
* ``boussinesq_parallel``: the same over ``--ranks N`` processes of
  ``run_parallel`` (the row-strip kernels B3 and B4).
"""
