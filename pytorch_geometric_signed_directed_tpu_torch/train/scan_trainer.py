"""The whole training of every split as device work: ``scan_node_training``.

Counterpart of ``pytorch_geometric_signed_directed_tpu/train/
scan_trainer.py``.  There the training is one XLA program, a ``vmap``
over splits of a ``lax.scan`` over epochs, with the best-validation
selection folded into the carry.  Here a split's epoch (step and on-device
evaluation) writes its results into device tensors in place, and on a
CUDA device it is captured once as a CUDA graph and replayed for every
later epoch, so the host only launches one graph an epoch and reads the
results once at the end.  Splits are a loop.
"""
from time import perf_counter
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..instrument import capture_table, layer
from ..ops.cuda import launch_counts
from .optim import OptimizerFactory


@layer("loss.masked_nll")
def masked_nll(logp: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over ``mask`` (float [N])."""
    per_node = -logp[torch.arange(logp.shape[0], device=logp.device),
                     y] * mask
    return per_node.sum() / torch.clamp_min(mask.sum(), 1.0)


def _masked_acc(pred, y, mask):
    return ((pred == y).float() * mask).sum() / torch.clamp_min(mask.sum(),
                                                                1.0)


def _count_delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()
            if v != before.get(k, 0)}


class SplitRun:
    """One split's training: the model, its optimizer and the device
    tensors each epoch updates in place (``best_val`` from -1,
    ``best_test``, ``final_test`` and ``losses``, one a epoch).

    ``epoch()`` is one epoch: zero the gradients, the training forward
    (``apply_fn(model, True, generator)``), the masked NLL, backward, the
    optimizer step, then under ``no_grad`` the evaluation forward
    (``apply_fn(model, False, None)``), its argmax, the masked validation
    and test accuracies and the selection ``better = vacc > best_val``
    kept with ``torch.where``.  It makes no host sync.

    ``run(captured=True)`` runs the first epoch eagerly on a side
    stream (it makes the optimizer's state, lets a kernel opt in to its
    shared memory and settles the allocator, as capture needs), captures
    the next epoch as a CUDA graph and replays it ``epochs - 1`` times:
    ``epochs`` epochs in all.  The launch counters of ``ops.cuda`` count
    each wrapper call where it is made: ``launches`` holds the calls of
    the eager epochs (all of them, or the first before a capture) and
    ``launches_per_replay`` those of the capture.  The graph
    and its memory pool (which holds the kernels' scratch) live as long as
    this object.

    With the port's spans on (``instrument.set_tracing``), ``capture()``
    also keeps ``span_table``, the capture's ``instrument.SpanTable``,
    which maps a replay's device operations onto the spans recorded while
    it was captured; else it is None."""

    def __init__(self, apply_fn: Callable, model: torch.nn.Module,
                 tx: OptimizerFactory, y: torch.Tensor, mask_tr: torch.Tensor,
                 mask_val: torch.Tensor, mask_te: torch.Tensor, epochs: int,
                 generator: Optional[torch.Generator] = None):
        if epochs < 1:
            raise ValueError(f"epochs={epochs}: at least one epoch")
        self.apply_fn, self.model, self.generator = apply_fn, model, \
            generator
        self.opt = tx(model.parameters())
        self.y, self.mask_tr, self.mask_val, self.mask_te = \
            y, mask_tr, mask_val, mask_te
        self.epochs = epochs
        dev = y.device
        self.best_val = torch.full((), -1.0, device=dev)
        self.best_test = torch.zeros((), device=dev)
        self.final_test = torch.zeros((), device=dev)
        self.losses = torch.zeros(epochs, device=dev)
        self._epoch = torch.zeros(1, dtype=torch.long, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.launches_per_replay: Dict[str, int] = {}
        self.capture_seconds = 0.0
        self.span_table = None

    def epoch(self) -> None:
        self.opt.zero_grad(set_to_none=True)
        logp = self.apply_fn(self.model, True, self.generator)
        loss = masked_nll(logp, self.y, self.mask_tr)
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            pred = self.apply_fn(self.model, False, None).argmax(1)
            vacc = _masked_acc(pred, self.y, self.mask_val)
            tacc = _masked_acc(pred, self.y, self.mask_te)
            better = vacc > self.best_val
            self.best_val.copy_(torch.where(better, vacc, self.best_val))
            self.best_test.copy_(torch.where(better, tacc, self.best_test))
            self.final_test.copy_(tacc)
            self.losses.index_copy_(0, self._epoch, loss.detach().view(1))
            self._epoch += 1

    def capture(self) -> None:
        """Run the first epoch eagerly, then capture the next as
        ``self.graph``; raises if the capture fails."""
        dev = self.y.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = launch_counts()
        with torch.cuda.stream(side):
            self.epoch()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.launches = _count_delta(before)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            # each replay then advances the dropout generator's offset
            graph.register_generator_state(self.generator)
        before = launch_counts()
        t0 = perf_counter()
        try:
            with torch.cuda.graph(graph):
                with capture_table() as table:
                    self.epoch()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the training epoch as a CUDA graph failed "
                f"(scan_node_training has no eager path on the card): {e}"
            ) from e
        self.capture_seconds = perf_counter() - t0
        self.launches_per_replay = _count_delta(before)
        self.span_table = table
        self.graph = graph

    def run(self, captured: bool) -> "SplitRun":
        """All ``epochs`` epochs: captured and replayed, or eagerly (the
        plain version, and the reference a captured run is held to)."""
        if not captured:
            before = launch_counts()
            for _ in range(self.epochs):
                self.epoch()
            self.launches = _count_delta(before)
            return self
        self.capture()
        for _ in range(self.epochs - 1):
            self.graph.replay()
        return self

    def results(self) -> torch.Tensor:
        """``[best_val, best_test, final_test, final_loss]`` on the device."""
        return torch.stack([self.best_val, self.best_test, self.final_test,
                            self.losses[-1]])


def split_generator(seed: int, split: int, device) -> torch.Generator:
    """The dropout generator of one split, seeded from ``(seed, split)``
    (JAX's ``split(PRNGKey(seed), S)`` keys cannot be drawn here)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, split]).generate_state(
        1, np.uint64)[0]))
    return g


def scan_node_training(
    apply_fn: Callable,
    init_fn: Callable[[int], torch.nn.Module],
    y,
    train_masks,
    val_masks,
    test_masks,
    epochs: int,
    tx: OptimizerFactory,
    seed: int = 0,
    stochastic: bool = False,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Train one model per split, entirely on the device.

    Args:
        apply_fn: ``(model, training, generator) -> logp [N, C]``;
            ``generator`` is None unless ``stochastic`` (dropout).
        init_fn: ``(split) -> nn.Module`` on ``device``, in place of JAX's
            ``init_fn(key)`` over ``split(PRNGKey(seed), S)``.
        y: [N] int labels.
        train_masks/val_masks/test_masks: [S, N] float split masks.
        epochs: epochs a split (JAX's scan length).
        tx: an optimizer factory in place of the optax transformation,
            e.g. ``train.optim.adam(lr, weight_decay)`` for JAX's
            ``optax.chain(add_decayed_weights(wd), adam(lr))``.
        seed: seeds each split's dropout generator with ``(seed, split)``.
        stochastic: pass the split's generator to the training forward.
            JAX's ``fold_in(key, epoch)`` bits cannot be matched: the same
            seed gives the same results twice.
        device: None means "cuda".  On a CUDA device every split captures
            its epoch as a CUDA graph (``SplitRun``) and replays it; a
            failed capture raises.  On the CPU the same epochs run
            eagerly.

    Each split is captured anew: ``init_fn`` makes a new module a split,
    and a graph replays fixed addresses, so re-seeding one captured
    split's parameters and optimizer state in place would have to know
    every model's and optimizer's tensors; a capture costs about one
    epoch's time.  A split's graph is freed before the next is captured.

    Returns a dict of numpy float32 arrays, one entry a split:
    ``best_val``, ``best_test`` (the test accuracy of the best-validation
    epoch), ``final_test`` (the last epoch's) and ``final_loss``.  The
    device is read once, at the end.
    """
    device = resolve_device(device)
    y = torch.as_tensor(np.asarray(y), dtype=torch.long, device=device)
    masks = [torch.as_tensor(np.asarray(m, np.float32), device=device)
             for m in (train_masks, val_masks, test_masks)]
    results = []
    for s in range(masks[0].shape[0]):
        gen = split_generator(seed, s, device) if stochastic else None
        run = SplitRun(apply_fn, init_fn(s), tx, y, masks[0][s],
                       masks[1][s], masks[2][s], epochs, gen)
        results.append(run.run(captured=device.type == "cuda").results())
        del run
    out = torch.stack(results).cpu().numpy() if results else \
        np.zeros((0, 4), np.float32)
    return dict(zip(("best_val", "best_test", "final_test", "final_loss"),
                    (np.ascontiguousarray(out[:, k]) for k in range(4))))
