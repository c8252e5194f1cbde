from .evaluation import (link_sign_direction_prediction_logistic_function,
                         link_sign_prediction_logistic_function)
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
from ...graph import in_out_degree
from ...ops.coo import coo_from_scipy as scipy_sparse_to_torch_coo
from ...spectral import (
    magnetic_signed_laplacian as get_magnetic_signed_Laplacian)

# the reference's converter to a torch sparse tensor; here scipy -> the
# port's COO on a device
scipy_sparse_to_torch_sparse = scipy_sparse_to_torch_coo

__all__ = ["Triplet_Loss_InnerProduct", "adjusted_rand_score",
           "extract_network", "get_magnetic_signed_Laplacian",
           "get_train_val_test_seed_split", "in_out_degree",
           "link_class_split",
           "link_sign_direction_prediction_logistic_function",
           "link_sign_prediction_logistic_function", "node_class_split",
           "sample_per_class", "sample_triplets",
           "scipy_sparse_to_torch_coo", "scipy_sparse_to_torch_sparse",
           "triplet_loss_inner_product", "triplet_loss_node_classification",
           "undirected_label2directed_label"]
