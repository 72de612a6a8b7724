"""Multi-process row-strip decomposition over ``torch.distributed``."""
from sem_tpu_torch.parallel.distributed import (assert_replicated,
                                                choose_backend, gather_global,
                                                init_distributed)
from sem_tpu_torch.parallel.sharding import (Group, active_group, make_group,
                                             row_strips, use_group)

__all__ = ["init_distributed", "choose_backend", "gather_global",
           "assert_replicated", "Group", "make_group", "use_group",
           "active_group", "row_strips"]
