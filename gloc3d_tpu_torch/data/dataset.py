"""Dataset container for training and evaluation: the port's copy of the
JAX package's ``data/dataset.py``.

The reference's dbStruct (i2i_util.py:93-129) is a .mat-file namedtuple of db
and query scan lists with UTM positions and poses. Here it is a typed
in-memory container of arrays. Model inputs are generic: (N, H, W, C) images
for i2i or (N, P, F) padded clouds + (N, P) masks for s2s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TripletDataset:
    """db + query sets with positions; the unit the trainer/eval consume.

    positives/negatives geometry mirrors i2i_util.py:217-268:
      nontrivial positives: db within ``nontriv_pos_dist`` of a query (10 m)
      potential negatives:  db farther than ``neg_dist_thr`` (20 m)
      eval positives:       db within ``pos_dist_thr`` (20 m)
    """

    db_inputs: np.ndarray            # (Ndb, ...) model inputs
    q_inputs: np.ndarray             # (Nq, ...)
    utm_db: np.ndarray               # (Ndb, 2)
    utm_q: np.ndarray                # (Nq, 2)
    db_masks: Optional[np.ndarray] = None   # (Ndb, P) for s2s
    q_masks: Optional[np.ndarray] = None
    db_poses: Optional[np.ndarray] = None   # (Ndb, 4, 4) lidar poses
    q_poses: Optional[np.ndarray] = None
    db_origins: Optional[np.ndarray] = None  # (Ndb, 2) BEV-image origins (i2i)
    q_origins: Optional[np.ndarray] = None

    @property
    def num_db(self) -> int:
        return len(self.db_inputs)

    @property
    def num_q(self) -> int:
        return len(self.q_inputs)

    def _dist2(self) -> np.ndarray:
        d = (
            np.sum(self.utm_q**2, 1)[:, None]
            - 2.0 * self.utm_q @ self.utm_db.T
            + np.sum(self.utm_db**2, 1)[None, :]
        )
        return np.maximum(d, 0.0)

    def nontrivial_positives(self, radius: float = 10.0) -> np.ndarray:
        """(Nq, Ndb) bool — hard-positive candidates (i2i_util.py:233-238)."""
        return self._dist2() <= radius * radius

    def potential_negatives(self, radius: float = 20.0) -> np.ndarray:
        """(Nq, Ndb) bool — guaranteed negatives (i2i_util.py:247-256)."""
        return self._dist2() > radius * radius

    def eval_positives(self, radius: float = 20.0) -> np.ndarray:
        """(Nq, Ndb) bool — GT for recall@N (i2i_util.py:192-214)."""
        return self._dist2() <= radius * radius
