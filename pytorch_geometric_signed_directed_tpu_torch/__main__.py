"""CLI: ``python -m pytorch_geometric_signed_directed_tpu_torch <experiment>``.

``--list`` prints the registry; everything after the experiment name is
forwarded to that experiment's own argparse (try ``<experiment> --help``).
Experiments run on the card unless given ``--device cpu``.
"""
import sys

from .experiments import EXPERIMENTS, run


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "--list"):
        print("usage: python -m pytorch_geometric_signed_directed_tpu_torch "
              "<experiment> [options]\n\nexperiments:")
        for name, (_, desc) in sorted(EXPERIMENTS.items()):
            print(f"  {name:24s} {desc}")
        return None
    return run(argv[0], argv[1:])


if __name__ == "__main__":
    main()
