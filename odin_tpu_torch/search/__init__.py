"""Diagonal alignment search and path search (PyTorch port of
``odin_tpu/search``).

The diagonal searches reorder the rows of a latent-factor correlation
matrix so that its diagonal is as large as possible (the Gym's correlation
plot): Hungarian assignment (scipy), beam, brute-force, greedy and
hill-climbing searches, all on the host in NumPy, as in the JAX package.
``beam_search``, ``greedy_search`` and ``beam_search_decode`` are in
``search.beam_search``.
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["search_assignment", "diagonal_linear_assignment",
           "diagonal_beam_search"]


def search_assignment(matrix, maximize: bool = True) -> np.ndarray:
  """Hungarian assignment of rows to columns: the column of each row."""
  from scipy.optimize import linear_sum_assignment
  rows, cols = linear_sum_assignment(np.asarray(matrix), maximize=maximize)
  return cols


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


def diagonal_beam_search(matrix, beam_size: int = 8) -> np.ndarray:
  """Beam search over row orderings maximising the diagonal sum; the rows
  the diagonal does not take follow in their order."""
  m = np.asarray(matrix, dtype=np.float64)
  n_rows, n_cols = m.shape
  beams: List = [((), 0.0)]
  for col in range(min(n_cols, n_rows)):
    candidates = []
    for used, score in beams:
      used_set = set(used)
      for r in range(n_rows):
        if r not in used_set:
          candidates.append((used + (r,), score + m[r, col]))
    candidates.sort(key=lambda t: -t[1])
    beams = candidates[:beam_size]
  best = list(beams[0][0])
  leftover = [i for i in range(n_rows) if i not in set(best)]
  return np.asarray(best + leftover, dtype=np.int64)


def diagonal_bruteforce_search(matrix) -> np.ndarray:
  """Exact diagonal maximisation over every row permutation (Heap's
  algorithm; n! of them, so n <= 10)."""
  m = np.asarray(matrix, dtype=np.float64)
  n_rows, n_cols = m.shape
  n = n_rows
  assert n <= 10, f"bruteforce over {n}! permutations is infeasible"
  min_dim = min(n_rows, n_cols)
  A = list(range(n))
  best_perm = list(A)
  best_diag = sum(m[r, c] for c, r in enumerate(A[:min_dim]))
  c_state = [0] * n
  i = 0
  while i < n:
    if c_state[i] < i:
      if i % 2 == 0:
        A[0], A[i] = A[i], A[0]
      else:
        A[c_state[i]], A[i] = A[i], A[c_state[i]]
      diag = sum(m[r, c] for c, r in enumerate(A[:min_dim]))
      if diag > best_diag:
        best_diag = diag
        best_perm = list(A)
      c_state[i] += 1
      i = 0
    else:
      c_state[i] = 0
      i += 1
  return np.asarray(best_perm, dtype=np.int64)


def diagonal_greedy_search(matrix) -> np.ndarray:
  """Greedy diagonal maximisation: take the largest remaining (row,
  column) pair and pin that row to that column, until the diagonal is
  full; the other rows follow in their order."""
  m = np.asarray(matrix, dtype=np.float64).copy()
  n_rows, n_cols = m.shape
  order = np.arange(n_rows)
  m[:, min(n_rows, n_cols):] = -np.inf  # only these columns are diagonal
  for _ in range(min(n_rows, n_cols)):
    r, c = np.unravel_index(np.argmax(m), m.shape)
    order[c] = r
    m[r, :] = -np.inf
    m[:, c] = -np.inf
  placed = set(order[:min(n_rows, n_cols)])
  leftover = [i for i in range(n_rows) if i not in placed]
  return np.asarray(list(order[:min(n_rows, n_cols)]) + leftover,
                    dtype=np.int64)


def diagonal_hillclimb_search(matrix) -> np.ndarray:
  """``diagonal_beam_search`` with a beam of 1."""
  return diagonal_beam_search(matrix, beam_size=1)


__all__ += ["diagonal_bruteforce_search", "diagonal_greedy_search",
            "diagonal_hillclimb_search"]


from odin_tpu_torch.search.beam_search import (beam_search,  # noqa: E402
                                               beam_search_decode,
                                               greedy_search)

__all__ += ["beam_search", "greedy_search", "beam_search_decode"]
