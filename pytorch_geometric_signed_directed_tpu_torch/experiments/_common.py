"""Pieces shared by the experiments: the device flag and the host-stage
and step clocks."""
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (the default) raises where "
                    "there is no CUDA, pass 'cpu' to run on the CPU")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageClock:
    """Host seconds by stage; ``mark(name)`` closes the stage that began
    at the previous mark (after the card has finished its work)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        _sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now


def run_steps(trainer, state, batch, epochs: int,
              after_step: Optional[Callable[[int], None]] = None) -> dict:
    """``epochs`` steps of ``trainer`` on ``state`` with ``batch`` (a tuple,
    or ``batch(epoch)`` giving each step's), ``after_step(epoch)`` after
    each.  Returns the losses, the milliseconds of each step (a
    pair of CUDA events on the card, so the loop makes no host sync; the
    host clock on the CPU) and the seconds of the whole loop."""
    cuda = trainer.device.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    losses, spans = [], []
    t0 = time.perf_counter()
    for epoch in range(epochs):
        a = mark()
        losses.append(trainer.step_async(
            state, *(batch(epoch) if callable(batch) else batch)))
        spans.append((a, mark()))
        if after_step is not None:
            after_step(epoch)
    _sync(trainer.device)
    seconds = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3
               for a, b in spans]
    return {"losses": [float(v) for v in losses], "step_ms": step_ms,
            "seconds": seconds, "steps": epochs}


def accuracy(pred: np.ndarray, y: np.ndarray) -> float:
    return (pred == y).mean()


def result(inputs, runs) -> dict:
    """What ``main`` returns: per-split test accuracy and training seconds,
    host seconds by stage (summed over splits), the runs and the inputs."""
    host = dict(inputs.seconds)
    for r in runs:
        for k, v in r.get("host_seconds", {}).items():
            host[k] = host.get(k, 0.0) + v
    return {"accs": [r["acc"] for r in runs],
            "seconds": [r["seconds"] for r in runs],
            "host_seconds": host, "runs": runs, "inputs": inputs}
