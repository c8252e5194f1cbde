from .link_split import link_class_split, undirected_label2directed_label
from .metrics import adjusted_rand_score
from .node_split import (
    get_train_val_test_seed_split,
    node_class_split,
    sample_per_class,
)

__all__ = ["adjusted_rand_score", "get_train_val_test_seed_split",
           "link_class_split", "node_class_split", "sample_per_class",
           "undirected_label2directed_label"]
