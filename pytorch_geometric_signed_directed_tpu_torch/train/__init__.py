"""Training loop."""

from .trainer import TrainState, Trainer, train_full_batch

__all__ = ["TrainState", "Trainer", "train_full_batch"]
