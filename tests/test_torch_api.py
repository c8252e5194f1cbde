"""Every public name of the original library has a counterpart in the
port's namespaces: the JAX package's completeness check
(tests/test_api_parity.py) on the port, with its renamed converter, and
the dense tier's ``dense_dtype``."""
import importlib

import numpy as np
import pytest
import torch

from test_torch_worker_memory import release_memory  # noqa: F401

PORT = "pytorch_geometric_signed_directed_tpu_torch"

REFERENCE_API = {
    "nn": [
        "DGCNConv", "DGCN_link_prediction", "DGCN_node_classification",
        "DIGRAC_node_clustering", "DIMPA", "DiGCL", "DiGCNConv",
        "DiGCN_Inception_Block_link_prediction",
        "DiGCN_Inception_Block_node_classification",
        "DiGCN_link_prediction", "DiGCN_node_classification", "MagNetConv",
        "MagNet_link_prediction", "MagNet_node_classification",
        "complex_relu_layer",
        "SDGNN", "SGCN", "SGCNConv", "SIMPA", "SNEA", "SNEAConv",
        "SSSNET_link_prediction", "SSSNET_node_clustering", "SiGAT",
        "Conv_Base", "MSConv", "MSGNN_link_prediction",
        "MSGNN_node_classification",
    ],
    "utils": [
        "Prob_Imbalance_Loss", "cal_fast_appr", "directed_features_in_out",
        "drop_feature", "fast_appr_power", "get_appr_directed_adj",
        "get_magnetic_Laplacian", "get_second_directed_adj",
        "meta_graph_generation", "pred_digcl_link", "pred_digcl_node",
        "Link_Sign_Entropy_Loss", "Link_Sign_Product_Loss",
        "Prob_Balanced_Normalized_Loss", "Prob_Balanced_Ratio_Loss",
        "Sign_Direction_Loss", "Sign_Product_Entropy_Loss",
        "Sign_Structure_Loss", "Sign_Triangle_Loss", "Unhappy_Ratio",
        "create_spectral_features", "link_sign_prediction_logistic_function",
        "extract_network", "get_magnetic_signed_Laplacian", "in_out_degree",
        "link_class_split", "link_sign_direction_prediction_logistic_function",
        "node_class_split", "triplet_loss_node_classification",
    ],
    "data": [
        "Citeseer", "Cora_ml", "DIGRAC_real_data", "DSBM", "DirectedData",
        "Telegram", "WikiCS", "WikipediaNetwork", "load_directed_real_data",
        "MSGNN_real_data", "SSSNET_real_data", "SignedData",
        "load_signed_real_data", "polarized_SSBM", "SDSBM",
        "SDGNN_real_data",
    ],
}

# the reference's torch-sparse converter: here scipy -> the port's COO
RENAMED = {"scipy_sparse_to_torch_sparse": ("utils.general",
                                            "scipy_sparse_to_torch_coo")}

SUBS = ("directed", "signed", "general")


def _module(name):
    try:
        return importlib.import_module(f"{PORT}.{name}")
    except ImportError:
        return None


@pytest.mark.parametrize("namespace", sorted(REFERENCE_API))
def test_namespace_complete(namespace):
    mods = [_module(namespace)] + [_module(f"{namespace}.{s}") for s in SUBS]
    missing = [s for s in REFERENCE_API[namespace]
               if not any(m is not None and hasattr(m, s) for m in mods)]
    assert not missing, f"{namespace} missing: {missing}"


@pytest.mark.parametrize("namespace", sorted(REFERENCE_API))
def test_namespace_names_are_at_the_top(namespace):
    """The port's top namespaces export every name themselves, and list
    it in ``__all__``."""
    mod = _module(namespace)
    missing = [s for s in REFERENCE_API[namespace]
               if not hasattr(mod, s) or s not in mod.__all__]
    assert not missing, f"{namespace} missing: {missing}"


def test_renamed_equivalents():
    for old, (mod_name, new) in RENAMED.items():
        mod = _module(mod_name)
        assert hasattr(mod, new)
        assert hasattr(mod, old)  # the original name kept too
        assert getattr(mod, old) is getattr(mod, new)


def test_renamed_converter_builds_a_coo():
    import scipy.sparse as sp
    from pytorch_geometric_signed_directed_tpu_torch.utils.general import (
        scipy_sparse_to_torch_coo)

    A = sp.random(6, 5, density=0.4, random_state=0, format="csr")
    coo = scipy_sparse_to_torch_coo(A, device="cpu")
    np.testing.assert_allclose(coo.to_dense().numpy(), A.toarray(),
                               rtol=1e-6)


def test_propagator_from_coo_dense_dtype():
    """``dense_dtype`` stores the dense operator in bf16; a float32 input
    gives the JAX package's bf16 dense tier: bf16 operands, their product
    taken and returned in float32."""
    import jax.numpy as jnp

    from pytorch_geometric_signed_directed_tpu.ops.coo import (
        build_coo as jx_build_coo)
    from pytorch_geometric_signed_directed_tpu.ops.spmm import (
        propagator_from_coo as jx_propagator_from_coo)
    from pytorch_geometric_signed_directed_tpu_torch.ops import build_coo
    from pytorch_geometric_signed_directed_tpu_torch.ops.spmm import (
        propagator_from_coo)

    rng = np.random.default_rng(0)
    row, col = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    val = rng.random(200)
    A = build_coo(row, col, val, 40, device="cpu")
    Pb = propagator_from_coo(A, mode="dense", dense_dtype=torch.bfloat16)
    assert Pb.mode == "dense" and Pb.dense.dtype == torch.bfloat16
    x = rng.standard_normal((40, 3)).astype(np.float32)
    got = Pb(torch.from_numpy(x))
    assert got.dtype == torch.float32
    Pj = jx_propagator_from_coo(jx_build_coo(row, col, val, 40),
                                mode="dense", dense_dtype=jnp.bfloat16)
    want = np.asarray(Pj(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a float32 operator keeps refusing another input type
    with pytest.raises(RuntimeError):
        propagator_from_coo(A, mode="dense")(
            torch.from_numpy(x.astype(np.float64)))
    # other tiers ignore it
    assert propagator_from_coo(A, mode="segment",
                               dense_dtype=torch.bfloat16).mode == "segment"
