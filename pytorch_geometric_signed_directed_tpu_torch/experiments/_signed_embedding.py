"""The embedding models of the link-sign experiments (SGCN, SNEA, SiGAT,
SDGNN): their inputs, each step's samples and their training on their own
loss.  ``run_link_sign_prediction`` and ``run_link_sign_direction_tasks``
share it."""
from types import SimpleNamespace

import numpy as np
import torch

from ..nn import SDGNN, SGCN, SNEA, SiGAT
from ..nn.signed.sdgnn import prepare_sdgnn_inputs
from ..nn.signed.sgcn import prepare_sgcn_inputs
from ..nn.signed.sigat import prepare_sigat_inputs
from ..nn.signed.snea import prepare_snea_inputs
from ..train import Trainer
from ..utils import negative_sampling, structured_negative_sampling
from ..utils.signed.link_sign_loss import plan_edges
from ._common import run_steps

EMBEDDING_METHODS = ("sgcn", "snea", "sigat", "sdgnn")


def embedding_model(method: str, n: int, edge_index_s, in_dim: int,
                    out_dim: int, seed: int, device, lamb=None
                    ) -> SimpleNamespace:
    """The model of ``method`` on the signed edges ``edge_index_s`` [E, 3]
    (its spectral input embedding of width ``in_dim``), the arguments of
    its forward, and ``samples()``: the arguments of its loss, drawn
    afresh for SGCN and SNEA (non-edges and triplets from one generator
    seeded ``seed``).  ``lamb``: SGCN's and SNEA's structure weight (their
    defaults when None)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    extra = {} if lamb is None else {"lamb": lamb}
    if method in ("sgcn", "snea"):
        if method == "sgcn":
            pos, neg, emb, Pp, Pn = prepare_sgcn_inputs(
                n, edge_index_s, in_dim, device=device)
            model = SGCN(node_num=n, in_dim=in_dim, out_dim=out_dim,
                         init_emb=emb, device=device, generator=gen, **extra)
            fwd = (Pp, Pn)
        else:
            pos, neg, emb, graphs = prepare_snea_inputs(
                n, edge_index_s, in_dim, device=device)
            model = SNEA(node_num=n, in_dim=in_dim, out_dim=out_dim,
                         init_emb=emb, device=device, generator=gen, **extra)
            fwd = (graphs,)
        both = np.concatenate([pos, neg], axis=1)

        def samples():
            return fwd + (pos, neg, negative_sampling(both, n, rng=rng),
                          structured_negative_sampling(pos, n, rng=rng),
                          structured_negative_sampling(neg, n, rng=rng))
    elif method == "sigat":
        pos, neg, emb, graphs = prepare_sigat_inputs(n, edge_index_s, in_dim,
                                                     device=device)
        model = SiGAT(node_num=n, in_dim=in_dim, out_dim=out_dim,
                      init_emb=emb, device=device, generator=gen)
        fwd = (graphs,)

        def samples():
            return (graphs, pos, neg)
    else:
        # the motif stack, and the edge lists planned once on the device
        pos, neg, emb, graphs, w_pos, w_neg = prepare_sdgnn_inputs(
            n, edge_index_s, in_dim, fused=True, device=device)
        model = SDGNN(node_num=n, in_dim=in_dim, out_dim=out_dim,
                      init_emb=emb, fused=True, device=device, generator=gen)
        fwd = (graphs,)
        args = (graphs, plan_edges(pos, n, device),
                plan_edges(neg, n, device),
                torch.as_tensor(w_pos, device=device),
                torch.as_tensor(w_neg, device=device))

        def samples():
            return args
    return SimpleNamespace(model=model, fwd=fwd, samples=samples)


def train_embedding(emb: SimpleNamespace, epochs: int, lr: float,
                    weight_decay: float, device) -> dict:
    """``epochs`` AdamW steps (decoupled decay, optax's ``adamw``) on the
    model's own loss, each on fresh samples; then the embedding from one
    forward (``z``, numpy).  One sample set is drawn and dropped first:
    the JAX experiments draw one for their model's init, so the steps
    here see the same draws as theirs."""
    emb.samples()
    trainer = Trainer(lambda m, *a: m.loss(*a), lr=lr,
                      weight_decay=weight_decay, device=device,
                      decoupled=True)
    run = run_steps(trainer, trainer.init(emb.model),
                    lambda epoch: emb.samples(), epochs)
    with torch.no_grad():
        z = emb.model(*emb.fwd).cpu().numpy()
    return dict(run, z=z)
