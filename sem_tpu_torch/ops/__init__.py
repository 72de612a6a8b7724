"""Hand-written CUDA kernels (``csrc/``), their plain versions, dispatchers,
and the row-strip helpers of the decomposed solves."""
from sem_tpu_torch.ops.kernels import (LAUNCHES,
                                       apply_coupled_system_best,
                                       apply_coupled_system_kernel,
                                       apply_coupled_system_plain,
                                       apply_system_best,
                                       apply_system_kernel,
                                       apply_system_plain)
from sem_tpu_torch.ops.sharded import (COLLECTIVES, RowStrips,
                                       apply_coupled_system_sharded,
                                       apply_coupled_system_sharded_plain,
                                       apply_system_sharded,
                                       apply_system_sharded_plain,
                                       strip_with_halo)

__all__ = ["LAUNCHES", "apply_system_best", "apply_system_kernel",
           "apply_system_plain", "apply_coupled_system_best",
           "apply_coupled_system_kernel", "apply_coupled_system_plain",
           "COLLECTIVES", "RowStrips", "strip_with_halo",
           "apply_system_sharded", "apply_system_sharded_plain",
           "apply_coupled_system_sharded",
           "apply_coupled_system_sharded_plain"]
