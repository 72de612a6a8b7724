"""Hand-written CUDA kernels (``csrc/``), their plain versions, dispatchers."""
from sem_tpu_torch.ops.kernels import (LAUNCHES,
                                       apply_coupled_system_best,
                                       apply_coupled_system_kernel,
                                       apply_coupled_system_plain,
                                       apply_system_best,
                                       apply_system_kernel,
                                       apply_system_plain)

__all__ = ["LAUNCHES", "apply_system_best", "apply_system_kernel",
           "apply_system_plain", "apply_coupled_system_best",
           "apply_coupled_system_kernel", "apply_coupled_system_plain"]
