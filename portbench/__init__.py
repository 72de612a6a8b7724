"""Benchmark harness of ``sem_tpu_torch`` on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Configurations (``configs/*.json``), traffic mixes (``traffic/*.json``) and
the laws of their values (``laws/*.py``), entries (``entries/*.py``),
per-layer metric readers (``metrics/*.py``) and the plain references
(``reference/*.py``) are found by the names that ``BENCHMARK.json``, the
configuration files and the mixes give them.
"""
