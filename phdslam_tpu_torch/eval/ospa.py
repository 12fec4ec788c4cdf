"""OSPA set-to-set error metric and the map estimate it scores (a copy of
``phdslam_tpu/eval/ospa.py::ospa_distance`` and ``extract_map_estimate``,
with the optimal assignment from ``scipy.optimize.linear_sum_assignment``
only).

The port keeps its own copy because ``phdslam_tpu/__init__.py`` imports jax;
``tests/test_torch_mixed.py`` holds it equal to the original. Pure numpy.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def ospa_distance(X, Y, p: float = 1.0, c: float = 10.0):
    """OSPA(p, c) between point sets X [m, d] and Y [n, d].

    Returns (ospa, localization, cardinality):
      err_loc = (sum min(d, c)^p / n)^(1/p) over the optimal assignment
      err_cn  = (c^p (n - m) / n)^(1/p)
      ospa    = ((sum + (n - m) c^p) / n)^(1/p)
    with (m, n) ordered so n >= m.
    """
    X = np.atleast_2d(np.asarray(X, dtype=float))
    Y = np.atleast_2d(np.asarray(Y, dtype=float))
    if X.size == 0 and Y.size == 0:
        return (0.0, 0.0, 0.0)
    if X.size == 0 or Y.size == 0:
        return (float(c), 0.0, float(c))

    m, n = len(X), len(Y)
    if m > n:
        X, Y = Y, X
        m, n = n, m

    diff = X[:, None, :] - Y[None, :, :]
    dists = np.minimum(np.sqrt(np.sum(diff ** 2, axis=-1)), c)
    rows, cols = linear_sum_assignment(dists)
    total_loc = float(np.sum(dists[rows, cols] ** p))

    err_cn = (float(c ** p * (n - m)) / n) ** (1.0 / p)
    err_loc = (total_loc / n) ** (1.0 / p)
    ospa = ((total_loc + (n - m) * c ** p) / n) ** (1.0 / p)
    return (ospa, err_loc, err_cn)


def extract_map_estimate(weights, means):
    """The scored map estimate: the round(sum w) heaviest live features."""
    weights = np.asarray(weights)
    means = np.asarray(means)
    live = weights > 0
    weights, means = weights[live], means[live]
    if weights.size == 0:
        return np.zeros((0, means.shape[-1] if means.ndim > 1 else 2))
    w_sum = int(round(float(np.sum(weights))))
    order = np.argsort(weights)[::-1]
    return means[order[:w_sum]]
