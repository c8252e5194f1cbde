"""Training loop, masked loss, checkpoints and timing."""

from .checkpoint import restore_checkpoint, save_checkpoint
from .profiling import edges_per_second, time_fn, trace
from .scan_trainer import masked_nll
from .trainer import TrainState, Trainer, train_full_batch

__all__ = ["TrainState", "Trainer", "edges_per_second", "masked_nll",
           "restore_checkpoint", "save_checkpoint", "time_fn", "trace",
           "train_full_batch"]
