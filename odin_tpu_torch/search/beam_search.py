"""Beam and greedy path search (PyTorch port of
``odin_tpu/search/beam_search.py``).

* Matrix paths (``beam_search``, ``greedy_search``): the n best symbol
  paths through a (T, V) matrix of log-scores, optionally coupled by a
  (V, V) transition matrix.  Host NumPy, as in the JAX package: T and V are
  small there.
* Autoregressive decoding (``beam_search_decode``): beam decoding of a
  sequence model on the device of its carry, one ``torch.topk`` over the
  K·V continuations of each example a step, and the backtrace of the beams'
  parents at the end; nothing goes back to the host until the result.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from odin_tpu_torch.training.core import _tree_map

__all__ = ["beam_search", "greedy_search", "beam_search_decode"]


def beam_search(matrix, beam_size: int = 2, n_best: int = 4,
                transition: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
  """The `n_best` symbol paths through a (T, V) log-score matrix.

  Without `transition` the steps are independent and the search is exact
  whenever ``beam_size >= n_best``.  With a (V, V) `transition`
  (``transition[i, j]``: the log-score of symbol j after i) the beam keeps
  ``max(beam_size, n_best)`` hypotheses a step.

  Returns ``(paths, scores)``: int64 (n_best, T) and float64 (n_best,),
  best first."""
  m = np.asarray(matrix, dtype=np.float64)
  if m.ndim != 2:
    raise ValueError(f"matrix must be (T, V), got {m.shape}")
  T, V = m.shape
  beam_size = max(int(beam_size), 1)
  n_best = max(int(n_best), 1)
  width = max(beam_size, n_best)
  if transition is not None:
    transition = np.asarray(transition, dtype=np.float64)
    if transition.shape != (V, V):
      raise ValueError(f"transition must be {(V, V)}, got {transition.shape}")
  order = np.argsort(-m[0])[:width]
  hyps = [(s,) for s in order]
  scores = [m[0, s] for s in order]
  for t in range(1, T):
    cand = []
    for h, sc in zip(hyps, scores):
      step = m[t] if transition is None else m[t] + transition[h[-1]]
      top = np.argsort(-step)[:width]
      cand.extend((h + (int(s),), sc + step[s]) for s in top)
    cand.sort(key=lambda p: -p[1])
    cand = cand[:width]
    hyps = [c[0] for c in cand]
    scores = [c[1] for c in cand]
  paths = np.asarray(hyps[:n_best], dtype=np.int64)
  return paths, np.asarray(scores[:n_best], dtype=np.float64)


def greedy_search(matrix) -> Tuple[np.ndarray, float]:
  """The per-step argmax path through a (T, V) log-score matrix (the beam
  of 1): ``(path (T,), score)``."""
  m = np.asarray(matrix, dtype=np.float64)
  path = np.argmax(m, axis=-1)
  return path.astype(np.int64), float(m[np.arange(m.shape[0]), path].sum())


def beam_search_decode(step_fn: Callable, init_carry, start_tokens,
                       length: int, beam_size: int = 4, n_best: int = 1):
  """Batched beam decoding on the device of `start_tokens`.

  ``step_fn(carry, tokens) -> (carry, logits)`` is the autoregressive cell
  applied to a batch: `tokens` int64 (N,), `logits` (N, V), `carry` a
  tensor or a tree (dicts, lists, tuples) of tensors with N rows.  It is
  called once a step on the B·K rows of every example's beams (the JAX
  package vmaps the same cell over those rows).  At t = 0 only beam 0 is
  live (the others score -inf), so the beam does not fill with copies of
  one hypothesis; each step keeps the `beam_size` best of an example's
  K·V continuations of its log-softmax scores, and the tokens are read back
  along the beams' parents at the end.

  Returns ``(tokens (B, n_best, length) int64, scores (B, n_best)
  float32)``, best first."""
  start_tokens = torch.as_tensor(start_tokens)
  device = start_tokens.device
  start_tokens = start_tokens.to(torch.int64)
  B = start_tokens.shape[0]
  K = int(beam_size)
  carry = _tree_map(lambda x: x.unsqueeze(1).expand(
      (B, K) + tuple(x.shape[1:])), init_carry)
  tok = start_tokens[:, None].expand(B, K)
  live = torch.arange(K, device=device)[None, :] == 0
  sc = torch.where(live, 0.0, -torch.inf).expand(B, K).to(torch.float32)
  flat = lambda x: x.reshape((B * K,) + tuple(x.shape[2:]))
  toks, parents = [], []
  for _ in range(int(length)):
    carry_f, logits = step_fn(_tree_map(flat, carry), flat(tok))
    logp = torch.log_softmax(logits.reshape(B, K, -1).to(torch.float32), -1)
    V = logp.shape[-1]
    total = sc[..., None] + logp                      # (B, K, V)
    sc, top_ix = torch.topk(total.reshape(B, K * V), K, dim=-1)
    beam_ix = top_ix // V                             # the parent beam
    tok = top_ix % V                                  # the symbol
    carry = _tree_map(lambda c: torch.take_along_dim(
        c.reshape((B, K) + tuple(c.shape[1:])),
        beam_ix.reshape((B, K) + (1,) * (c.ndim - 1)), dim=1), carry_f)
    toks.append(tok)
    parents.append(beam_ix)
  ix = torch.arange(K, device=device)[None, :].expand(B, K)
  out = []
  for tok_t, par_t in zip(reversed(toks), reversed(parents)):
    out.append(torch.take_along_dim(tok_t, ix, dim=1))
    ix = torch.take_along_dim(par_t, ix, dim=1)
  tokens = torch.stack(out[::-1], dim=-1) if out else torch.zeros(
      (B, K, 0), dtype=torch.int64, device=device)
  return tokens[:, :n_best], sc[:, :n_best]
