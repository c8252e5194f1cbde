"""Training loop, masked loss, checkpoints and timing."""

from .checkpoint import restore_checkpoint, save_checkpoint
from .profiling import edges_per_second, time_fn, trace
from .optim import adam
from .scan_trainer import SplitRun, masked_nll, scan_node_training
from .trainer import TrainState, Trainer, train_full_batch

__all__ = ["SplitRun", "TrainState", "Trainer", "adam", "edges_per_second",
           "masked_nll", "restore_checkpoint", "save_checkpoint",
           "scan_node_training", "time_fn", "trace", "train_full_batch"]
