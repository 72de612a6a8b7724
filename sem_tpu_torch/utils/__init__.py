"""Host-side helpers: checkpoint/resume, tracing/profiling, the disk cache of
solver constants, device constants."""
from sem_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sem_tpu_torch.utils.profiling import PhaseTimer, trace

__all__ = ["save_checkpoint", "load_checkpoint", "PhaseTimer", "trace"]
