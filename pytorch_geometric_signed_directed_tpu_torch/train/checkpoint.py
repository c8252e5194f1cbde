"""Checkpoint / resume for training state.

Counterpart of ``pytorch_geometric_signed_directed_tpu/train/
checkpoint.py`` (orbax there): the module's and the optimizer's
``state_dict`` and the step, saved with ``torch.save`` under
``<path>/step_<n>/``.
"""
import os
from typing import Optional

import torch

from .trainer import TrainState

_FILE = "state.pt"


def save_checkpoint(path: str, state: TrainState,
                    step: Optional[int] = None) -> str:
    """Save ``state`` (its module, optimizer and step) as
    ``<path>/step_<step>``; returns that directory."""
    path = os.path.abspath(path)
    step = state.step if step is None else step
    target = os.path.join(path, f"step_{step}")
    os.makedirs(target, exist_ok=True)
    torch.save({"params": state.params.state_dict(),
                "opt_state": state.opt_state.state_dict(),
                "step": int(step)}, os.path.join(target, _FILE))
    return target


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a ``step_<n>`` directory, or the latest one under ``path``,
    into ``state``'s module and optimizer; returns a TrainState over them
    at the saved step."""
    path = os.path.abspath(path)
    if os.path.basename(path).startswith("step_"):
        target = path
    else:
        steps = sorted(
            (d for d in os.listdir(path) if d.startswith("step_")),
            key=lambda d: int(d.split("_")[1]))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        target = os.path.join(path, steps[-1])
    device = next(state.params.parameters()).device
    payload = torch.load(os.path.join(target, _FILE), map_location=device)
    state.params.load_state_dict(payload["params"])
    state.opt_state.load_state_dict(payload["opt_state"])
    return TrainState(params=state.params, opt_state=state.opt_state,
                      step=int(payload["step"]))
