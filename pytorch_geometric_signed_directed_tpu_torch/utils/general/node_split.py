"""Node-level train/val/test/seed splitting.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/general/
node_split.py``: the same ``RandomState`` draws in the same order, so
the same seeds give the same masks.  Masks are [num_nodes, n_splits] bool
numpy arrays on the data object.
"""
from typing import List, Optional, Union

import numpy as np


def sample_per_class(random_state: np.random.RandomState, labels: np.ndarray,
                     num_examples_per_class: Union[int, float],
                     forbidden_indices=None, force_indices=None):
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    candidates = {}
    for c in range(num_classes):
        idx = np.nonzero(labels == c)[0]
        if forbidden_indices is not None:
            idx = idx[~np.isin(idx, np.asarray(forbidden_indices))]
        if force_indices is not None:
            idx = idx[np.isin(idx, np.asarray(force_indices))]
        candidates[c] = idx

    if isinstance(num_examples_per_class, int):
        return np.concatenate([
            random_state.choice(candidates[c], num_examples_per_class,
                                replace=False)
            for c in range(num_classes)
        ])
    if isinstance(num_examples_per_class, float):
        selection = []
        base = (labels if force_indices is None
                else labels[np.asarray(force_indices)])
        values, counts = np.unique(base, return_counts=True)
        for c, count in zip(values, counts):
            size = int(num_examples_per_class * count)
            selection.extend(random_state.choice(candidates[int(c)], size,
                                                 replace=False))
        return np.asarray(selection, dtype=int)
    raise TypeError("Please input a float or int number for the parameter "
                    "num_examples_per_class.")


def _choice_sized(random_state, pool, size: Union[int, float], what: str):
    pool = np.asarray(pool)
    if isinstance(size, int):
        return random_state.choice(pool, size, replace=False)
    if isinstance(size, float):
        return random_state.choice(pool, int(size * len(pool)), replace=False)
    raise TypeError(f"Please input a float or int number for the parameter "
                    f"{what}.")


def _distinct(a: np.ndarray) -> bool:
    return len(np.unique(a)) == len(a)


def get_train_val_test_seed_split(
    random_state: np.random.RandomState,
    labels: np.ndarray,
    train_size_per_class=None, val_size_per_class=None,
    test_size_per_class=None, seed_size_per_class=None,
    train_size=None, val_size=None, test_size=None, seed_size=None,
):
    labels = np.asarray(labels)
    num_samples = labels.shape[0]
    remaining = np.arange(num_samples)

    if train_size is None and train_size_per_class is None:
        raise ValueError(
            "Please input the values of train_size or train_size_per_class!")

    if train_size_per_class is not None:
        train_indices = sample_per_class(random_state, labels,
                                         train_size_per_class)
    else:
        train_indices = _choice_sized(random_state, remaining, train_size,
                                      "train_size")

    if seed_size_per_class is not None:
        seed_indices = sample_per_class(random_state, labels,
                                        seed_size_per_class,
                                        force_indices=train_indices)
    elif seed_size is not None:
        seed_indices = _choice_sized(random_state, train_indices, seed_size,
                                     "seed_size")
    else:
        seed_indices = np.array([], dtype=int)

    val_indices = np.array([], dtype=int)
    if val_size_per_class is not None:
        val_indices = sample_per_class(random_state, labels,
                                       val_size_per_class,
                                       forbidden_indices=train_indices)
        forbidden = np.concatenate((train_indices, val_indices))
    elif val_size is not None:
        remaining = np.setdiff1d(remaining, train_indices)
        val_indices = _choice_sized(random_state, remaining, val_size,
                                    "val_size")
        forbidden = np.concatenate((train_indices, val_indices))
    else:
        forbidden = train_indices

    if test_size_per_class is not None:
        test_indices = sample_per_class(random_state, labels,
                                        test_size_per_class,
                                        forbidden_indices=forbidden)
    elif test_size is not None:
        remaining = np.setdiff1d(remaining, forbidden)
        test_indices = _choice_sized(random_state, remaining, test_size,
                                     "test_size")
    else:
        test_indices = np.setdiff1d(np.arange(num_samples), forbidden)

    # the JAX package's consistency checks
    assert _distinct(train_indices) and _distinct(val_indices) \
        and _distinct(test_indices)
    assert not len(np.intersect1d(train_indices, val_indices))
    assert not len(np.intersect1d(train_indices, test_indices))
    assert not len(np.intersect1d(val_indices, test_indices))
    if test_size is None and test_size_per_class is None:
        assert (len(train_indices) + len(val_indices)
                + len(test_indices)) == num_samples
    return train_indices, val_indices, test_indices, seed_indices


def node_class_split(data,
                     train_size=None, val_size=None, test_size=None,
                     seed_size=None,
                     train_size_per_class=None, val_size_per_class=None,
                     test_size_per_class=None, seed_size_per_class=None,
                     seed: Optional[List[int]] = None, data_split: int = 10):
    """Attach train/val/test/seed masks [N, data_split] to ``data``.

    ``data`` is any object with a ``y`` attribute (labels); the masks are
    stored as numpy bool arrays."""
    if train_size is None and train_size_per_class is None:
        raise ValueError(
            "Please input the values of train_size or train_size_per_class!")
    if not seed:
        seed = list(range(data_split))
    if len(seed) != data_split:
        raise ValueError("Please input the random seed list with the same "
                         f"length of {data_split}!")

    labels = np.asarray(data.y)
    n = labels.shape[0]
    masks = {k: np.zeros((n, data_split), dtype=bool)
             for k in ("train", "val", "test", "seed")}
    for i in range(data_split):
        rs = np.random.RandomState(seed[i])
        tr, va, te, se = get_train_val_test_seed_split(
            rs, labels, train_size_per_class, val_size_per_class,
            test_size_per_class, seed_size_per_class,
            train_size, val_size, test_size, seed_size)
        masks["train"][tr, i] = True
        masks["val"][va, i] = True
        masks["test"][te, i] = True
        if len(se):
            masks["seed"][se, i] = True

    data.train_mask = masks["train"]
    data.val_mask = masks["val"]
    data.test_mask = masks["test"]
    data.seed_mask = masks["seed"]
    return data
