"""Host-side helpers: checkpoint/resume, tracing/profiling, the disk cache of
solver constants, device constants and the drivers' device check."""
from sem_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sem_tpu_torch.utils.profiling import PhaseTimer, trace
from sem_tpu_torch.utils.tensors import cli_device, sync

__all__ = ["save_checkpoint", "load_checkpoint", "PhaseTimer", "trace",
           "cli_device", "sync"]
