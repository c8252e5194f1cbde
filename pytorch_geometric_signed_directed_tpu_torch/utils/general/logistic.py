"""Logistic regression probes and classification metrics in numpy/scipy.

The JAX package evaluates frozen embeddings with scikit-learn, which the
card's machine does not have.  This module gives the same results from
the same objectives:

* ``LogisticRegression`` — scikit-learn's ``LogisticRegression(solver=
  "lbfgs")``: a single logistic for two classes, a multinomial one
  otherwise, an L2 penalty ``1/(2C)`` on the coefficients and none on the
  intercept, sample weights from ``class_weight`` (None, ``"balanced"``
  or a dict).
* ``liblinear_fit`` / ``OneVsRest`` — ``OneVsRestClassifier(
  LogisticRegression(solver="liblinear"))`` on a 0/1 indicator matrix:
  liblinear appends a constant 1 column (``intercept_scaling=1``), so its
  intercept *is* penalized.  A column with one value is predicted as that
  constant, and, as scikit-learn does, a constant first column moves
  every column's decision threshold from 0 to 0.5.
* ``grid_search_ovr`` — ``GridSearchCV(OneVsRest, C=2**arange(-10, 10),
  cv=5)`` for an indicator target: ``KFold(5)`` without shuffling,
  subset accuracy, the first (smallest) C among ties, refit on all rows.
* ``accuracy_score``, ``f1_score`` (binary, macro, micro) and
  ``roc_auc_score`` (tied scores as scikit-learn's ROC curve takes them).

Both objectives are strictly convex (with the multinomial intercepts
fixed up to their common shift), so the optimum is one point; scipy's
trust-region Newton method with the exact Hessian solves each to a much
tighter tolerance than scikit-learn's (``gtol`` 1e-4), and the
predictions agree wherever a margin is wider than scikit-learn's own
stopping error.
"""
from typing import Optional, Sequence, Union

import numpy as np
from scipy import optimize
from scipy.special import expit, log_expit

GRID_C = 2.0 ** np.arange(-10, 10)
_GTOL = 1e-10


def _logsumexp(Z: np.ndarray) -> np.ndarray:
    """log sum exp over the rows' entries, shifted by the row maximum."""
    m = Z.max(axis=1, keepdims=True)
    return (m + np.log(np.exp(Z - m).sum(axis=1, keepdims=True)))[:, 0]


def _with_ones(X: np.ndarray) -> np.ndarray:
    return np.hstack([X, np.ones((X.shape[0], 1))])


def _sample_weights(y_enc: np.ndarray, classes: np.ndarray,
                    class_weight: Union[dict, str, None]) -> np.ndarray:
    """Per-sample weights from ``class_weight`` (scikit-learn's
    ``compute_class_weight``): ``"balanced"`` gives n / (K * count)."""
    if class_weight is None:
        return np.ones(len(y_enc))
    if class_weight == "balanced":
        counts = np.bincount(y_enc, minlength=len(classes))
        per_class = len(y_enc) / (len(classes) * counts.astype(np.float64))
    else:
        per_class = np.array([float(class_weight.get(c, 1.0))
                              for c in classes.tolist()])
    return per_class[y_enc]


def _newton(fun, jac, hess, w0: np.ndarray) -> np.ndarray:
    """The minimizer of a smooth strictly convex objective by scipy's
    trust-region Newton method with the exact Hessian, to a gradient of
    ``_GTOL``: a few tens of iterations where L-BFGS takes hundreds."""
    return optimize.minimize(fun, w0, jac=jac, hess=hess,
                             method="trust-exact",
                             options={"gtol": _GTOL, "maxiter": 1000}).x


class LogisticRegression:
    """L2-penalized logistic regression (scikit-learn's ``solver="lbfgs"``
    objective, solved here by Newton's method); ``coef_`` [1 or K, d] and
    ``intercept_``.  The objective is scikit-learn's: the weighted mean
    loss plus ``|coef|^2 / (2 C sum(weights))``."""

    def __init__(self, C: float = 1.0,
                 class_weight: Union[dict, str, None] = None):
        self.C = C
        self.class_weight = class_weight

    def fit(self, X, y) -> "LogisticRegression":
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        k = len(self.classes_)
        if k < 2:
            raise ValueError("This solver needs samples of at least 2 "
                             f"classes in the data, but the data contains "
                             f"only one class: {self.classes_[0]!r}")
        weights = _sample_weights(y_enc, self.classes_, self.class_weight)
        s, reg = weights / weights.sum(), 1.0 / (self.C * weights.sum())
        Xb = _with_ones(X)
        d = X.shape[1]
        if k == 2:
            w = _newton(*_binary_objective(Xb, y_enc == 1, s, reg, d),
                        np.zeros(d + 1))
            self.coef_, self.intercept_ = w[None, :d], w[d:]
            return self
        # the loss does not change when every intercept moves by the same
        # amount, and the penalty leaves them out: fix the last at 0
        W = _newton(*_multinomial_objective(Xb, y_enc, k, s, reg, d),
                    np.zeros(k * (d + 1) - 1))
        W = np.append(W, 0.0).reshape(k, d + 1)
        self.coef_, self.intercept_ = W[:, :d], W[:, d] - W[:, d].mean()
        return self

    def decision_function(self, X) -> np.ndarray:
        scores = np.asarray(X, np.float64) @ self.coef_.T + self.intercept_
        return scores[:, 0] if len(self.classes_) == 2 else scores

    def predict_proba(self, X) -> np.ndarray:
        scores = self.decision_function(X)
        if len(self.classes_) == 2:
            p = expit(scores)
            return np.stack([1.0 - p, p], axis=1)
        return np.exp(scores - _logsumexp(scores)[:, None])

    def predict(self, X) -> np.ndarray:
        scores = self.decision_function(X)
        if len(self.classes_) == 2:
            return self.classes_[(scores > 0).astype(int)]
        return self.classes_[scores.argmax(axis=1)]


def _penalty(d: int, size: int, reg: float) -> np.ndarray:
    """reg on each coefficient of a [rows, d + 1] parameter block (not on
    the intercept column), flattened row by row and cut to ``size``."""
    per_row = np.r_[np.full(d, reg), 0.0]
    return np.tile(per_row, size // (d + 1) + 1)[:size]


def _binary_objective(Xb, pos, s, reg, d):
    """(value, gradient, Hessian) of the weighted mean of
    log(1 + e^z) - t z over z = Xb w, plus reg |w[:d]|^2 / 2."""
    t = pos.astype(np.float64)
    pen = _penalty(d, d + 1, reg)

    def fun(w):
        z = Xb @ w
        return s @ (np.logaddexp(0.0, z) - t * z) + 0.5 * (pen * w) @ w

    def jac(w):
        return Xb.T @ (s * (expit(Xb @ w) - t)) + pen * w

    def hess(w):
        p = expit(Xb @ w)
        return (Xb * (s * p * (1.0 - p))[:, None]).T @ Xb + np.diag(pen)

    return fun, jac, hess


def _multinomial_objective(Xb, y_enc, k, s, reg, d):
    """(value, gradient, Hessian) of the weighted mean of
    logsumexp(z) - z[y] over Z = Xb W^T, plus reg |W[:, :d]|^2 / 2, with
    W [k, d + 1] flattened by row and its last intercept fixed at 0 (left
    out of the parameters)."""
    onehot = np.eye(k)[y_enc]
    size = k * (d + 1) - 1
    pen = _penalty(d, size, reg)

    def probs(w):
        Z = Xb @ np.append(w, 0.0).reshape(k, d + 1).T
        lse = _logsumexp(Z)
        return Z, lse, np.exp(Z - lse[:, None])

    def fun(w):
        Z, lse, _ = probs(w)
        return s @ (lse - Z[np.arange(len(Z)), y_enc]) + 0.5 * (pen * w) @ w

    def jac(w):
        _, _, P = probs(w)
        G = ((P - onehot) * s[:, None]).T @ Xb
        return G.ravel()[:size] + pen * w

    def hess(w):
        _, _, P = probs(w)
        H = np.empty((k, d + 1, k, d + 1))
        for a in range(k):
            for b in range(a, k):
                c = s * P[:, a] * ((a == b) - P[:, b])
                H[a, :, b, :] = (Xb * c[:, None]).T @ Xb
                H[b, :, a, :] = H[a, :, b, :].T
        H = H.reshape(k * (d + 1), k * (d + 1))[:size, :size]
        return H + np.diag(pen)

    return fun, jac, hess


def liblinear_fit(X: np.ndarray, t: np.ndarray, C: float,
                  w0: Optional[np.ndarray] = None) -> np.ndarray:
    """liblinear's L2-regularized logistic regression on labels t in
    {0, 1}: the minimizer of 0.5 |w|^2 + C sum log(1 + exp(-s_i w.x_i))
    over [x, 1] (s = +-1), the intercept penalized with the rest.
    Returns w [d + 1], the intercept last.  The objective is solved
    divided by C n, by a trust-region Newton method with the exact
    Hessian (as liblinear's own TRON), to a gradient of ``_GTOL``."""
    Xb = _with_ones(np.asarray(X, np.float64))
    n = Xb.shape[0]
    sgn = np.where(np.asarray(t) > 0, 1.0, -1.0)
    lam = 1.0 / (C * n)

    def fun(w):
        m = sgn * (Xb @ w)
        return -log_expit(m).mean() + 0.5 * lam * (w @ w)

    def jac(w):
        m = sgn * (Xb @ w)
        return Xb.T @ (-sgn * expit(-m)) / n + lam * w

    def hess(w):
        p = expit(Xb @ w)
        return (Xb * (p * (1.0 - p) / n)[:, None]).T @ Xb \
            + lam * np.eye(len(w))

    return _newton(fun, jac, hess,
                   np.zeros(Xb.shape[1]) if w0 is None else w0)


class OneVsRest:
    """``OneVsRestClassifier(LogisticRegression(solver="liblinear", C))``
    on a [n, K] 0/1 indicator target: one liblinear fit a column, or that
    column's one value where it has only one."""

    def __init__(self, C: float = 1.0):
        self.C = C

    def fit(self, X, Y, w0: Optional[Sequence] = None) -> "OneVsRest":
        """``w0``: start points of the column fits (the optimum is one
        point, so a start changes only the time to reach it)."""
        X = np.asarray(X, np.float64)
        Y = np.asarray(Y).astype(np.int64)
        self.estimators_ = []
        for j in range(Y.shape[1]):
            col = Y[:, j]
            if np.unique(col).size == 1:
                self.estimators_.append(("constant", float(col[0])))
            else:
                start = None if w0 is None else w0[j]
                self.estimators_.append(
                    ("logistic", liblinear_fit(X, col, self.C, start)))
        return self

    def warm_starts(self) -> list:
        return [w if kind == "logistic" else None
                for kind, w in self.estimators_]

    def predict(self, X) -> np.ndarray:
        X = np.asarray(X, np.float64)
        # scikit-learn takes the threshold from the first estimator: a
        # constant one has no classifier's decision function
        thresh = 0.5 if self.estimators_[0][0] == "constant" else 0.0
        cols = []
        for kind, w in self.estimators_:
            score = (np.full(len(X), w) if kind == "constant"
                     else X @ w[:-1] + w[-1])
            cols.append(score > thresh)
        return np.stack(cols, axis=1).astype(np.int64)


def kfold(n: int, n_splits: int = 5):
    """scikit-learn's ``KFold(n_splits)`` without shuffling: (train, test)
    index pairs, the first ``n % n_splits`` test blocks one longer."""
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits="
                         f"{n_splits} greater than the number of samples: "
                         f"n_samples={n}.")
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    idx = np.arange(n)
    out, start = [], 0
    for size in sizes:
        test = idx[start:start + size]
        out.append((np.concatenate([idx[:start], idx[start + size:]]), test))
        start += size
    return out


def subset_accuracy(Y_true: np.ndarray, Y_pred: np.ndarray) -> float:
    return float(np.mean(np.all(np.asarray(Y_true) == np.asarray(Y_pred),
                                axis=1)))


def grid_search_ovr(X, Y, Cs=GRID_C, cv: int = 5) -> OneVsRest:
    """The one-vs-rest probe at the C of the best mean subset accuracy
    over ``KFold(cv)`` (the smallest C among ties), refit on every row.
    ``best_C_`` and ``cv_scores_`` [len(Cs)] are set on the result."""
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y).astype(np.int64)
    scores = np.zeros((len(Cs), cv))
    for f, (tr, te) in enumerate(kfold(len(X), cv)):
        w0 = None
        for i, C in enumerate(Cs):
            clf = OneVsRest(C).fit(X[tr], Y[tr], w0)
            w0 = clf.warm_starts()
            scores[i, f] = subset_accuracy(Y[te], clf.predict(X[te]))
    means = np.average(scores, axis=1)
    best = int(np.argmax(means))
    clf = OneVsRest(float(Cs[best])).fit(X, Y)
    clf.best_C_, clf.cv_scores_ = float(Cs[best]), means
    return clf


# ---------------------------------------------------------------------------
# metrics


def accuracy_score(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def _f1(tp, true_sum, pred_sum):
    denom = true_sum + pred_sum
    return np.where(denom > 0, 2.0 * tp / np.where(denom > 0, denom, 1), 0.0)


def f1_score(y_true, y_pred, average: str = "binary",
             pos_label=1) -> float:
    """scikit-learn's ``f1_score`` with ``average`` "binary" (of
    ``pos_label``), "macro" (the unweighted mean over the labels of
    either array) or "micro"; 0 where precision and recall are 0/0."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if average == "binary":
        labels = np.asarray([pos_label])
    else:
        labels = np.unique(np.concatenate([y_true, y_pred]))
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels],
                  np.float64)
    true_sum = np.array([np.sum(y_true == c) for c in labels], np.float64)
    pred_sum = np.array([np.sum(y_pred == c) for c in labels], np.float64)
    if average == "micro":
        return float(_f1(tp.sum(), true_sum.sum(), pred_sum.sum()))
    f = _f1(tp, true_sum, pred_sum)
    return float(f[0] if average == "binary" else np.average(f))


def roc_auc_score(y_true, y_score) -> float:
    """Binary ROC AUC by the trapezoid rule over scikit-learn's ROC curve:
    one point per distinct score (ties as one diagonal step), collinear
    points dropped, the origin prepended."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    classes = np.unique(y_true)
    if len(classes) != 2:
        raise ValueError("Only one class is present in y_true. ROC AUC "
                         "score is not defined in that case.")
    pos = (y_true == classes[1]).astype(np.float64)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, pos = y_score[order], pos[order]
    distinct = np.where(np.diff(y_score))[0]
    thresholds = np.r_[distinct, pos.size - 1]
    tps = np.cumsum(pos, dtype=np.float64)[thresholds]
    fps = 1 + thresholds - tps
    if fps.size > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.r_[0, fps], np.r_[0, tps]
    return float(np.trapezoid(tps / tps[-1], fps / fps[-1]))
