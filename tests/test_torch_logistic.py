"""The port's numpy logistic probes and metrics against scikit-learn, which
the tests may import and the port may not: the lbfgs fit (binary and
multinomial, with and without ``class_weight="balanced"``), liblinear's
penalized-intercept fit, the one-vs-rest grid's folds, chosen C and
predictions, DiGCL's two probes and both link-sign evaluation functions,
on the JAX package's functions where it has them.

scikit-learn stops its solvers at a gradient of 1e-4 while the port
solves to 1e-10, so predictions and the chosen C are held equal on data
with clear margins, coefficients to a relative 1e-3 (against scikit-learn
at its default tolerance) and to 1e-6 (against scikit-learn solved as
tightly), and metrics of the same predictions to 1e-12."""
import warnings

import numpy as np
import pytest
from sklearn import metrics
from sklearn.linear_model import LogisticRegression as SkLR
from sklearn.model_selection import GridSearchCV, KFold
from sklearn.multiclass import OneVsRestClassifier

from pytorch_geometric_signed_directed_tpu.utils.directed import (
    digcl_utils as jx_digcl_utils)
from pytorch_geometric_signed_directed_tpu.utils.general import (
    evaluation as jx_evaluation)

from pytorch_geometric_signed_directed_tpu_torch.utils.directed import (
    digcl_utils)
from pytorch_geometric_signed_directed_tpu_torch.utils.general import (
    evaluation, logistic)

from test_torch_worker_memory import release_memory  # noqa: F401

METRIC_TOL = dict(rtol=1e-12, atol=1e-12)


def separable(n, d, k, seed, margin=0.5):
    """Points whose class is the argmax of a random linear score, kept
    only where the best score leads the next by ``margin``."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, k)) * 2.0
    X = rng.normal(size=(4 * n, d))
    S = X @ W
    top = np.sort(S, axis=1)
    keep = np.nonzero(top[:, -1] - top[:, -2] > margin)[0][:n]
    return X[keep], S[keep].argmax(1)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_lbfgs_fit_matches(k, class_weight):
    X, y = separable(300, 6, k, seed=k)
    # unbalance the classes so that "balanced" weights differ from 1
    keep = np.r_[np.nonzero(y != 0)[0], np.nonzero(y == 0)[0][:20]]
    X, y = X[keep], y[keep]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = SkLR(solver="lbfgs", max_iter=1000,
                  class_weight=class_weight).fit(X, y)
        tight = SkLR(solver="lbfgs", max_iter=100000, tol=1e-12,
                     class_weight=class_weight).fit(X, y)
    me = logistic.LogisticRegression(class_weight=class_weight).fit(X, y)
    np.testing.assert_array_equal(me.predict(X), sk.predict(X))
    np.testing.assert_array_equal(me.classes_, sk.classes_)
    scale = np.abs(tight.coef_).max()
    np.testing.assert_allclose(me.coef_, sk.coef_, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(me.coef_, tight.coef_, rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(me.predict_proba(X), tight.predict_proba(X),
                               rtol=0, atol=1e-6)


def test_class_weight_dict():
    X, y = separable(200, 5, 2, seed=7)
    cw = {0: 3.0, 1: 0.5}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tight = SkLR(solver="lbfgs", max_iter=100000, tol=1e-12,
                     class_weight=cw).fit(X, y)
    me = logistic.LogisticRegression(class_weight=cw).fit(X, y)
    np.testing.assert_allclose(me.coef_, tight.coef_, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(me.intercept_, tight.intercept_, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("C", [2.0 ** -4, 1.0, 2.0 ** 5])
def test_liblinear_fit_penalizes_the_intercept(C):
    X, y = separable(250, 5, 2, seed=3)
    X = X + 1.5  # an offset the intercept must carry
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = SkLR(solver="liblinear", C=C).fit(X, y)
        tight = SkLR(solver="liblinear", C=C, tol=1e-12,
                     max_iter=100000).fit(X, y)
    w = logistic.liblinear_fit(X, y, C)
    want = np.r_[tight.coef_.ravel(), tight.intercept_]
    np.testing.assert_allclose(w, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    loose = np.r_[sk.coef_.ravel(), sk.intercept_]
    np.testing.assert_allclose(w, loose, rtol=0,
                               atol=1e-3 * np.abs(want).max())
    np.testing.assert_array_equal((X @ w[:-1] + w[-1] > 0).astype(int),
                                  sk.predict(X))


@pytest.mark.parametrize("n", [10, 23, 137])
def test_kfold_is_sklearns(n):
    mine = logistic.kfold(n, 5)
    theirs = list(KFold(5).split(np.zeros(n)))
    assert len(mine) == len(theirs) == 5
    for (a, b), (c, d) in zip(mine, theirs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def sk_grid(X, Y):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GridSearchCV(OneVsRestClassifier(SkLR(solver="liblinear")),
                            dict(estimator__C=2.0 ** np.arange(-10, 10)),
                            cv=5).fit(X, Y)


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_search_ovr_chooses_sklearns_c(seed):
    X, y = separable(160, 8, 4, seed=seed, margin=1.0)
    X = X / np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.eye(4, dtype=bool)[y]
    sk = sk_grid(X, Y)
    me = logistic.grid_search_ovr(X, Y)
    assert me.best_C_ == sk.best_params_["estimator__C"]
    np.testing.assert_allclose(me.cv_scores_,
                               sk.cv_results_["mean_test_score"], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(me.predict(X), sk.predict(X))
    for e, (kind, w) in zip(sk.best_estimator_.estimators_,
                            me.estimators_):
        assert kind == "logistic"
        got = np.r_[e.coef_.ravel(), e.intercept_]
        np.testing.assert_allclose(w, got, rtol=0,
                                   atol=1e-3 * np.abs(w).max())


def test_one_vs_rest_constant_columns():
    """A column with one value is that constant; a constant first column
    moves every threshold to 0.5, as in scikit-learn."""
    X, y = separable(120, 4, 2, seed=5)
    Y = np.stack([np.zeros(len(y), bool), y == 1, y == 0, np.ones(len(y),
                                                                bool)], 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = OneVsRestClassifier(SkLR(solver="liblinear", C=0.01)).fit(X, Y)
    me = logistic.OneVsRest(0.01).fit(X, Y)
    assert [k for k, _ in me.estimators_] == [
        "constant", "logistic", "logistic", "constant"]
    np.testing.assert_array_equal(me.predict(X), sk.predict(X))
    # the threshold moved: some rows below 0.5 but above 0 are negatives
    _, w = me.estimators_[1]
    score = X @ w[:-1] + w[-1]
    assert np.any((score > 0) & (score <= 0.5))


def embedding_classes(n, d, k, seed):
    """Embeddings whose rows lie near one of k class directions."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d))
    y = rng.permutation(np.arange(n) % k)
    z = centres[y] * 3 + rng.normal(size=(n, d))
    return z.astype(np.float32), y


def test_pred_digcl_node_matches_the_jax_package():
    z, y = embedding_classes(150, 6, 3, seed=11)
    train, test = np.arange(0, 150, 2), np.arange(1, 150, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jx_digcl_utils.pred_digcl_node(z, y, train, test)
        want_all = jx_digcl_utils.pred_digcl_node(z, y, train)
    np.testing.assert_array_equal(
        digcl_utils.pred_digcl_node(z, y, train, test), want)
    np.testing.assert_array_equal(digcl_utils.pred_digcl_node(z, y, train),
                                  want_all)


def test_pred_digcl_link_matches_the_jax_package():
    z, group = embedding_classes(80, 5, 2, seed=12)
    rng = np.random.default_rng(13)
    pairs = rng.integers(0, 80, (400, 2))
    # the source's group: linear in the concatenated ends
    label = group[pairs[:, 0]].astype(np.int64)
    tr, te = pairs[:300], pairs[300:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jx_digcl_utils.pred_digcl_link(z, label[:300], tr, te)
    got = digcl_utils.pred_digcl_link(z, label[:300], tr, te)
    np.testing.assert_array_equal(got, want)
    assert (got == label[300:]).mean() > 0.9


def test_l2_rows_and_onehot_are_sklearns():
    from sklearn.preprocessing import OneHotEncoder, normalize

    z, _ = embedding_classes(20, 4, 2, seed=1)
    z[3] = 0.0
    np.testing.assert_array_equal(digcl_utils.l2_normalize_rows(z),
                                  normalize(z, norm="l2"))
    y = np.array([5, 2, 2, 9, 5])
    want = OneHotEncoder(categories="auto").fit(y[:, None]).transform(
        y[:, None]).toarray().astype(bool)
    np.testing.assert_array_equal(digcl_utils._onehot(y), want)


def link_task(k, seed):
    z, group = embedding_classes(120, 6, 3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    pairs = rng.integers(0, 120, (700, 2))
    if k == 2:
        label = (group[pairs[:, 0]] == group[pairs[:, 1]]).astype(np.int64)
    else:
        label = (group[pairs[:, 0]] + group[pairs[:, 1]]) % k
    return z, pairs[:500], label[:500], pairs[500:], label[500:]


@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_link_sign_prediction_logistic_function(class_weight):
    z, tr, tr_y, te, te_y = link_task(2, seed=21)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jx_evaluation.link_sign_prediction_logistic_function(
            z, tr, tr_y, te, te_y, class_weight=class_weight)
    got = evaluation.link_sign_prediction_logistic_function(
        z, tr, tr_y, te, te_y, class_weight=class_weight)
    # the predictions agree, so accuracy and the F1s are the same numbers;
    # the AUC ranks probabilities of two optima a solver tolerance apart
    np.testing.assert_allclose(got[:4], want[:4], **METRIC_TOL)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-3)


@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_link_sign_direction_prediction_logistic_function(class_weight):
    z, tr, tr_y, te, te_y = link_task(4, seed=31)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jx_evaluation.link_sign_direction_prediction_logistic_function(
            z, tr, tr_y, te, te_y, class_weight=class_weight)
    got = evaluation.link_sign_direction_prediction_logistic_function(
        z, tr, tr_y, te, te_y, class_weight=class_weight)
    np.testing.assert_allclose(got, want, **METRIC_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_of_the_same_predictions(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 300)
    pred = np.where(rng.random(300) < 0.8, y, 1 - y)
    # rounded scores: many ties
    score = np.round(0.6 * y + 0.7 * rng.random(300), 1)
    assert logistic.accuracy_score(y, pred) == pytest.approx(
        metrics.accuracy_score(y, pred), abs=1e-12)
    for avg in ("binary", "macro", "micro"):
        np.testing.assert_allclose(
            logistic.f1_score(y, pred, average=avg),
            metrics.f1_score(y, pred, average=avg), **METRIC_TOL)
    np.testing.assert_allclose(logistic.roc_auc_score(y, score),
                               metrics.roc_auc_score(y, score), **METRIC_TOL)
    y4 = rng.integers(0, 4, 300)
    p4 = np.where(rng.random(300) < 0.6, y4, rng.integers(0, 5, 300))
    for avg in ("macro", "micro"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = metrics.f1_score(y4, p4, average=avg)
        np.testing.assert_allclose(logistic.f1_score(y4, p4, average=avg),
                                   want, **METRIC_TOL)


def test_f1_of_a_class_never_predicted_is_zero():
    y = np.array([0, 0, 1, 1, 2])
    pred = np.array([0, 0, 1, 1, 1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = metrics.f1_score(y, pred, average="macro")
    assert logistic.f1_score(y, pred, average="macro") == pytest.approx(
        want, abs=1e-12)
    assert logistic.f1_score(np.zeros(4, int), np.zeros(4, int)) == 0.0
