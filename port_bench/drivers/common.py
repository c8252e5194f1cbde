"""What the drivers share: the port's precision settings, its degree
features, the generator of its dropout masks, and the readings of an
optimizer's state."""
import numpy as np
import torch

from pytorch_geometric_signed_directed_tpu_torch.graph import in_out_degree
from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
    launch_counts)


def set_precision(config: dict) -> None:
    """The configuration's message type and matmul precision, process-wide
    (the port keeps both as module settings)."""
    spmm.set_matmul_precision(config["matmul_precision"])
    spmm.set_message_dtype(config["message_dtype"])


def features(graph: dict, device) -> torch.Tensor:
    """The port's in/out-degree features over their largest."""
    x = in_out_degree(graph["edge_index"], graph["num_nodes"],
                      edge_weight=graph["edge_weight"])
    x = x / max(x.max(), 1.0)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def dropout_generator(inputs: dict, device) -> torch.Generator:
    """The generator the port draws its dropout masks from, seeded with
    the harness's dropout seed (the plain reference seeds its own alike)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(inputs["dropout_seed"]))
    return gen


def first_gradient(model: torch.nn.Module, opt: torch.optim.Optimizer):
    """Each parameter's gradient as Adam got it on its first step (decay
    included), from its state after that step: exp_avg / (1 - beta1).
    A parameter the optimizer never stepped reads zeros."""
    out = {}
    for group in opt.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = opt.state.get(p, {})
            out[id(p)] = (st["exp_avg"] / (1.0 - b1) if "exp_avg" in st
                          else torch.zeros_like(p)).detach().clone()
    return {name: out[id(p)] for name, p in model.named_parameters()}


def counters() -> dict:
    """The port's kernel wrapper calls by name since its last reset."""
    return dict(launch_counts())
