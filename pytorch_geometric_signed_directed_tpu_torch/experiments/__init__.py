"""Runnable experiments, each a module with ``main(argv)``.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/``,
dispatched by ``python -m pytorch_geometric_signed_directed_tpu_torch
<experiment> [options]`` (see ``__main__.py``).  ``EXPERIMENTS`` holds the
ported ones; ``NOT_PORTED`` names the JAX package's others, which end with
a message saying so.
"""
import importlib

EXPERIMENTS = {
    "magnet_node": ("magnet_node", "MagNet node classification"),
    "magnet_link": ("magnet_link", "MagNet link/direction prediction"),
    "msgnn_node": ("msgnn_node", "MSGNN signed-directed node classification"),
    "msgnn_link": ("msgnn_link", "MSGNN signed-directed link tasks"),
    "digrac": ("digrac", "DIGRAC directed flow clustering"),
    "dgcn_link": ("dgcn_link", "DGCN link/direction prediction"),
    "digcn_link": ("digcn_link", "DiGCN link/direction prediction"),
    "digcn_inception_link": ("digcn_inception_link",
                             "DiGCN inception-block link prediction"),
    "sssnet": ("sssnet", "SSSNET semi-supervised signed clustering"),
}

NOT_PORTED = ("dgcn_node", "digcn_node", "digcn_inception_node",
              "digcl_node", "digcl_link", "link_sign_prediction",
              "link_sign_direction_tasks")


def run(name, argv=None):
    if name in NOT_PORTED:
        raise SystemExit(
            f"experiment '{name}' is not ported to the PyTorch package yet "
            f"(ROADMAP.md queue A); ported: " + ", ".join(sorted(EXPERIMENTS)))
    if name not in EXPERIMENTS:
        raise SystemExit(
            f"unknown experiment '{name}'; available: "
            + ", ".join(sorted(EXPERIMENTS)))
    mod = importlib.import_module(f"{__name__}.{EXPERIMENTS[name][0]}")
    return mod.main(argv)
