"""Full-batch trainer.

Counterpart of ``pytorch_geometric_signed_directed_tpu/train/trainer.py``.
The JAX trainer carries a parameter pytree and an optax state; here the
state holds the ``nn.Module`` (updated in place) and its optimizer.
"""
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .optim import OptimizerFactory

@dataclass
class TrainState:
    params: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0
    best_metric: float = -np.inf
    best_params: Any = None
    history: Dict[str, list] = field(default_factory=dict)


class Trainer:
    """Full-batch training harness.

    Args:
        loss_fn: ``(model, *batch) -> scalar loss tensor``; with ``rng``
            set it is called as ``loss_fn(model, generator, *batch)``.
        lr / weight_decay: Adam settings.  ``weight_decay`` is coupled L2,
            as ``torch.optim.Adam(weight_decay=...)``: the decay joins the
            gradient before the moments (optax's ``add_decayed_weights``
            before ``adam``).
        optimizer: a factory from the model's parameters to a
            ``torch.optim.Optimizer`` (the form ``train.optim.adam`` gives),
            which replaces the Adam of ``lr`` and ``weight_decay``, as the
            JAX trainer's optax transformation does; None keeps that Adam.
        rng: seed of the ``torch.Generator`` handed to ``loss_fn`` (for
            dropout), on ``device``.
        device: where the generator lives; None means "cuda".
        decoupled: take AdamW's decoupled decay instead (optax's
            ``adamw``); only without ``optimizer``.
    """

    def __init__(self, loss_fn: Callable, lr: float = 1e-3,
                 weight_decay: float = 0.0,
                 optimizer: Optional[OptimizerFactory] = None,
                 rng: Optional[int] = None, *, device: DeviceLike = None,
                 decoupled: bool = False):
        if optimizer is not None and decoupled:
            raise ValueError("decoupled selects the default optimizer; "
                             "with optimizer= the factory sets the decay")
        self.loss_fn = loss_fn
        self.lr, self.weight_decay = lr, weight_decay
        self.optimizer = optimizer
        self.decoupled = decoupled
        self.device = resolve_device(device)
        self.generator = None
        if rng is not None:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(rng)

    def init(self, model: torch.nn.Module) -> TrainState:
        if self.optimizer is not None:
            return TrainState(params=model,
                              opt_state=self.optimizer(model.parameters()))
        opt = torch.optim.AdamW if self.decoupled else torch.optim.Adam
        return TrainState(params=model, opt_state=opt(
            model.parameters(), lr=self.lr, weight_decay=self.weight_decay))

    def step_async(self, state: TrainState, *batch) -> torch.Tensor:
        """One step; returns the loss as a detached device tensor without
        a host sync."""
        state.opt_state.zero_grad(set_to_none=True)
        if self.generator is None:
            loss = self.loss_fn(state.params, *batch)
        else:
            loss = self.loss_fn(state.params, self.generator, *batch)
        loss.backward()
        state.opt_state.step()
        state.step += 1
        return loss.detach()

    def step(self, state: TrainState, *batch) -> float:
        return float(self.step_async(state, *batch))

    def fit(self, state: TrainState, batch_fn: Callable[[], tuple],
            epochs: int, eval_fn: Optional[Callable] = None,
            eval_every: int = 10, patience: Optional[int] = None,
            verbose: bool = False, best_on_host: bool = True
            ) -> TrainState:
        """batch_fn() -> loss args per step; eval_fn(model) -> float metric
        (higher is better).  The best-metric snapshot is a copy of the
        state_dict: on the CPU with ``best_on_host``, else on the model's
        device (no copy to the host at each improvement, one more set of
        parameters in device memory)."""
        bad = 0
        t0 = time.perf_counter()
        raw_losses = []
        for epoch in range(epochs):
            loss = self.step_async(state, *batch_fn())
            raw_losses.append(loss)
            if eval_fn is not None and (epoch + 1) % eval_every == 0:
                with torch.no_grad():
                    metric = float(eval_fn(state.params))
                state.history.setdefault("metric", []).append(metric)
                if metric > state.best_metric:
                    state.best_metric = metric
                    state.best_params = {
                        k: (v.detach().cpu() if best_on_host
                            else v.detach()).clone()
                        for k, v in state.params.state_dict().items()}
                    bad = 0
                else:
                    bad += 1
                if verbose:
                    print(f"epoch {epoch + 1}: loss {float(loss):.4f} "
                          f"metric {metric:.4f}")
                if patience is not None and bad >= patience:
                    break
        state.history.setdefault("loss", []).extend(
            float(l) for l in raw_losses)
        state.history["seconds"] = time.perf_counter() - t0
        return state


def train_full_batch(loss_fn, model, batch_fn, epochs, lr=1e-3,
                     weight_decay=0.0, eval_fn=None, eval_every=10,
                     patience=None, verbose=False,
                     device: DeviceLike = None) -> TrainState:
    trainer = Trainer(loss_fn, lr, weight_decay, device=device)
    state = trainer.init(model)
    return trainer.fit(state, batch_fn, epochs, eval_fn, eval_every,
                       patience, verbose)
