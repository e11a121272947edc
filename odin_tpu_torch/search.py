"""Diagonal alignment of correlation matrices (the port's copy of
``odin_tpu/search``'s ``diagonal_linear_assignment``, on scipy's Hungarian
solver): reorder the rows of a latent-factor matrix so that its diagonal
is as large as possible, for the Gym's correlation plot."""
from __future__ import annotations

import numpy as np

__all__ = ["diagonal_linear_assignment"]


def diagonal_linear_assignment(matrix) -> np.ndarray:
  """Row order (int64) placing each column's best row on the diagonal;
  for an (n_rows >= n_cols) matrix the unassigned rows follow, largest
  row maximum first."""
  from scipy.optimize import linear_sum_assignment
  m = np.asarray(matrix, dtype=np.float64)
  n_rows, _ = m.shape
  rows, cols = linear_sum_assignment(m.T, maximize=True)
  order = list(cols[np.argsort(rows)])
  assigned = set(order)
  leftover = sorted((i for i in range(n_rows) if i not in assigned),
                    key=lambda i: -m[i].max())
  return np.asarray(order + leftover, dtype=np.int64)
