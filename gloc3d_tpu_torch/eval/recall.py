"""Place-recognition recall@N: the port's copy of the JAX package's
``eval/recall.py``.

Reference semantics: main.py:322-351 / global_localization.cpp:221-268 —
a query counts for recall@n if any of its first n predictions is a GT
positive; queries with no GT positives are skipped; denominator is the
number of valid queries.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def ground_truth_positives(
    utm_db: np.ndarray, utm_q: np.ndarray, radius: float
) -> np.ndarray:
    """(numQ, numDb) bool: db entries within ``radius`` of each query.

    Vectorized replacement for sklearn NearestNeighbors radius queries
    (i2i_util.py:192-214); positions are (N, 2) planar coordinates.
    """
    d2 = (
        np.sum(utm_q**2, 1)[:, None]
        - 2.0 * utm_q @ utm_db.T
        + np.sum(utm_db**2, 1)[None, :]
    )
    return d2 <= radius * radius


def recall_at_n(
    predictions: np.ndarray,
    positives: np.ndarray,
    n_values: Sequence[int] = (1, 5, 10, 20),
) -> Dict[int, float]:
    """recall@n over queries that have at least one positive.

    Args:
      predictions: (Q, k) ranked db indices per query.
      positives: (Q, numDb) bool ground-truth mask.
    """
    predictions = np.asarray(predictions)
    positives = np.asarray(positives)
    valid = positives.any(axis=1)
    nq = int(valid.sum())
    out = {}
    hit = np.take_along_axis(positives, predictions, axis=1)  # (Q, k)
    for n in n_values:
        any_hit = hit[:, :n].any(axis=1) & valid
        out[n] = float(any_hit.sum()) / max(nq, 1)
    return out
