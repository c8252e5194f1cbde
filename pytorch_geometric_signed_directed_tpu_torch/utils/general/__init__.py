from .extract_network import extract_network
from .link_split import link_class_split, undirected_label2directed_label
from .metrics import adjusted_rand_score
from .node_split import (
    get_train_val_test_seed_split,
    node_class_split,
    sample_per_class,
)
from .triplet_loss import (Triplet_Loss_InnerProduct, sample_triplets,
                           triplet_loss_inner_product,
                           triplet_loss_node_classification)

__all__ = ["Triplet_Loss_InnerProduct", "adjusted_rand_score",
           "extract_network", "get_train_val_test_seed_split",
           "link_class_split", "node_class_split", "sample_per_class",
           "sample_triplets", "triplet_loss_inner_product",
           "triplet_loss_node_classification",
           "undirected_label2directed_label"]
