"""Runnable experiments, each a module with ``main(argv)``.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/``,
dispatched by ``python -m pytorch_geometric_signed_directed_tpu_torch
<experiment> [options]`` (see ``__main__.py``).  ``EXPERIMENTS`` maps each
name of the JAX package's registry to the same module name.  The joint
sign and direction tasks of ``run_link_sign_direction_tasks`` are a module
of their own, run as ``python -m pytorch_geometric_signed_directed_tpu_
torch.experiments.run_link_sign_direction_tasks``, as in the JAX package;
the registry name ``link_sign_direction_tasks`` runs ``msgnn_link``.
"""
import importlib

EXPERIMENTS = {
    "magnet_node": ("magnet_node", "MagNet node classification"),
    "magnet_link": ("magnet_link", "MagNet link/direction prediction"),
    "dgcn_node": ("dgcn_node", "DGCN 3-stream node classification"),
    "dgcn_link": ("dgcn_link", "DGCN link/direction prediction"),
    "digcn_node": ("digcn_node", "DiGCN (appr adjacency) node classification"),
    "digcn_link": ("digcn_link", "DiGCN link/direction prediction"),
    "digcn_inception_node": ("digcn_inception_node",
                             "DiGCN inception-block node classification"),
    "digcn_inception_link": ("digcn_inception_link",
                             "DiGCN inception-block link prediction"),
    "digcl_node": ("digcl_node", "DiGCL contrastive node embedding"),
    "digcl_link": ("digcl_link", "DiGCL contrastive link prediction"),
    "digrac": ("digrac", "DIGRAC directed flow clustering"),
    "msgnn_node": ("msgnn_node", "MSGNN signed-directed node classification"),
    "msgnn_link": ("msgnn_link", "MSGNN signed-directed link tasks"),
    "sssnet": ("sssnet", "SSSNET semi-supervised signed clustering"),
    "link_sign_prediction": ("run_link_sign_prediction",
                             "SGCN/SNEA/SiGAT/SDGNN link-sign prediction"),
    # as in the JAX registry: MSGNN's 4/5-class sign+direction tasks
    "link_sign_direction_tasks": ("msgnn_link",
                                  "MSGNN 4/5-class sign+direction tasks"),
}


def run(name, argv=None):
    if name not in EXPERIMENTS:
        raise SystemExit(
            f"unknown experiment '{name}'; available: "
            + ", ".join(sorted(EXPERIMENTS)))
    mod = importlib.import_module(f"{__name__}.{EXPERIMENTS[name][0]}")
    return mod.main(argv)
