"""The port's ``search`` package (``odin_tpu_torch/search``) against the JAX
package's ``odin_tpu/search`` on the CPU: the diagonal searches and the
matrix path searches give the same orders and paths (exactly: they are the
same NumPy code), and ``beam_search_decode`` the same tokens with scores
within 1e-5 (float32 log-softmax sums over 7 steps), and
tests/test_beam_search.py's cases hold for the port.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.search as jax_search
import odin_tpu_torch.search as search
from odin_tpu_torch.search import (beam_search, beam_search_decode,
                                   greedy_search)

SCORE_TOL = 1e-5


def test_search_all_equals_jax():
  assert search.__all__ == jax_search.__all__
  import importlib
  module = importlib.import_module("odin_tpu_torch.search.beam_search")
  jax_module = importlib.import_module("odin_tpu.search.beam_search")
  assert module.__all__ == jax_module.__all__


@pytest.mark.parametrize("name", ["diagonal_linear_assignment",
                                  "diagonal_beam_search",
                                  "diagonal_bruteforce_search",
                                  "diagonal_greedy_search",
                                  "diagonal_hillclimb_search"])
@pytest.mark.parametrize("shape", [(5, 5), (7, 4)])
def test_diagonal_searches_match_jax(name, shape):
  m = np.random.RandomState(sum(shape)).randn(*shape)
  got = getattr(search, name)(m)
  want = getattr(jax_search, name)(m)
  assert got.dtype == np.int64
  np.testing.assert_array_equal(got, want)
  assert sorted(got) == list(range(shape[0]))


def test_search_assignment_matches_jax():
  m = np.random.RandomState(0).rand(6, 6)
  for maximize in (True, False):
    np.testing.assert_array_equal(
        search.search_assignment(m, maximize),
        jax_search.search_assignment(m, maximize))


def test_greedy_is_beam1():
  rng = np.random.RandomState(0)
  m = rng.randn(6, 5)
  path, score = greedy_search(m)
  paths, scores = beam_search(m, beam_size=1, n_best=1)
  np.testing.assert_array_equal(path, paths[0])
  assert score == pytest.approx(scores[0])
  assert score == pytest.approx(m.max(axis=1).sum())
  jpath, jscore = jax_search.greedy_search(m)
  np.testing.assert_array_equal(path, jpath)
  assert score == jscore


def test_beam_search_exact_without_transition():
  rng = np.random.RandomState(1)
  m = rng.randn(4, 3)
  paths, scores = beam_search(m, beam_size=4, n_best=4)
  brute = sorted(
      ((sum(m[t, s] for t, s in enumerate(p)), p)
       for p in itertools.product(range(3), repeat=4)),
      key=lambda x: -x[0])[:4]
  for (bs, bp), p, s in zip(brute, paths, scores):
    assert s == pytest.approx(bs)
    assert tuple(p) == bp


def test_beam_search_with_transition_matches_viterbi_and_jax():
  rng = np.random.RandomState(2)
  T, V = 5, 4
  m, trans = rng.randn(T, V), rng.randn(V, V)
  paths, scores = beam_search(m, beam_size=V * V, n_best=1,
                              transition=trans)
  best = max(
      (m[0, p[0]] + sum(m[t, p[t]] + trans[p[t - 1], p[t]]
                        for t in range(1, T)), p)
      for p in itertools.product(range(V), repeat=T))
  assert scores[0] == pytest.approx(best[0])
  assert tuple(paths[0]) == best[1]
  for beam in (1, 2, 3):
    got = beam_search(m, beam, 3, trans)
    want = jax_search.beam_search(m, beam, 3, trans)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_beam_search_validates_shapes():
  with pytest.raises(ValueError):
    beam_search(np.zeros((3,)))
  with pytest.raises(ValueError):
    beam_search(np.zeros((3, 4)), transition=np.zeros((2, 2)))


def _toy_steps(W):
  """The linear cell of tests/test_beam_search.py: JAX's on one example
  (vmapped by the decoder), the port's on a batch of rows."""
  jW = jnp.asarray(W)
  tW = torch.from_numpy(W)

  def jax_step(carry, token):
    carry = jnp.tanh(carry + jW[token])
    return carry, carry @ jW.T

  def port_step(carry, tokens):
    carry = torch.tanh(carry + tW[tokens])
    return carry, carry @ tW.T

  return jax_step, port_step


def test_beam_decode_full_width_is_exhaustive():
  """beam_size = V^T: the best path and score are those of exhaustive
  enumeration, as in tests/test_beam_search.py."""
  rng = np.random.RandomState(3)
  V, H, T = 3, 4, 3
  W = rng.randn(V, H).astype(np.float32)
  _, step = _toy_steps(W)
  start = torch.zeros(2, dtype=torch.int64)
  carry0 = torch.zeros(2, H)
  toks, scores = beam_search_decode(step, carry0, start, length=T,
                                    beam_size=V ** T, n_best=1)

  def path_score(b, path):
    carry, tok, total = torch.zeros(1, H), start[b:b + 1], 0.0
    for p in path:
      carry, logits = step(carry, tok)
      total += float(torch.log_softmax(logits, -1)[0, p])
      tok = torch.tensor([p])
    return total

  for b in range(2):
    best = max((path_score(b, p), p)
               for p in itertools.product(range(V), repeat=T))
    assert float(scores[b, 0]) == pytest.approx(best[0], abs=1e-4)
    assert tuple(toks[b, 0].tolist()) == best[1]


def test_beam_decode_narrow_beam_le_exact():
  rng = np.random.RandomState(4)
  V, H, T, B = 5, 6, 7, 3
  W = rng.randn(V, H).astype(np.float32)
  _, step = _toy_steps(W)
  start = torch.from_numpy(rng.randint(0, V, B))
  carry0 = torch.from_numpy(rng.randn(B, H).astype(np.float32))
  toks2, sc2 = beam_search_decode(step, carry0, start, length=T,
                                  beam_size=2, n_best=2)
  toksW, scW = beam_search_decode(step, carry0, start, length=T,
                                  beam_size=32, n_best=2)
  assert toks2.shape == (B, 2, T) and toks2.dtype == torch.int64
  assert torch.all(sc2[:, 0] >= sc2[:, 1] - 1e-6)
  assert torch.all(scW[:, 0] >= sc2[:, 0] - 1e-6)


@pytest.mark.parametrize("beam,n_best", [(1, 1), (4, 2), (8, 4)])
def test_beam_decode_matches_jax(beam, n_best):
  """The same cell and start in both packages: the same tokens, scores
  within 1e-5, for a carry that is a tree (a tuple) too."""
  rng = np.random.RandomState(5 + beam)
  V, H, T, B = 6, 8, 7, 3
  W = rng.randn(V, H).astype(np.float32)
  jax_step, port_step = _toy_steps(W)
  start = rng.randint(0, V, B)
  carry0 = rng.randn(B, H).astype(np.float32)
  jt, js = beam_search_decode(port_step, torch.from_numpy(carry0),
                              torch.from_numpy(start), T, beam, n_best)
  wt, ws = jax_search.beam_search_decode(jax_step, jnp.asarray(carry0),
                                         jnp.asarray(start), T, beam, n_best)
  np.testing.assert_array_equal(jt.numpy(), np.asarray(wt))
  np.testing.assert_allclose(js.numpy(), np.asarray(ws), atol=SCORE_TOL)

  # a tuple carry: (h, step count); the decoder keeps the tree
  def tree_step(carry, tokens):
    h, n = carry
    h, logits = port_step(h, tokens)
    return (h, n + 1), logits

  tt, ts = beam_search_decode(tree_step, (torch.from_numpy(carry0),
                                          torch.zeros(B)),
                              torch.from_numpy(start), T, beam, n_best)
  np.testing.assert_array_equal(tt.numpy(), np.asarray(wt))
  np.testing.assert_allclose(ts.numpy(), np.asarray(ws), atol=SCORE_TOL)


def test_beam_decode_with_the_ports_gru_cell():
  """The port's GRUCell as the step and a projection to V symbols, the
  shape of the chip check (a small width here), against the JAX decoder
  on flax's GRU formula with the same weights."""
  from odin_tpu_torch.networks.base import GRUCell
  H, V, B, T, K = 16, 12, 4, 6, 3
  cell = GRUCell(H)
  cell.build((H,), torch.Generator().manual_seed(0))
  gen = torch.Generator().manual_seed(1)
  emb = torch.randn(V, H, generator=gen) * 0.5
  proj = torch.randn(H, V, generator=gen) * 0.5

  def step(h, tokens):
    h = cell(h, emb[tokens])
    return h, h @ proj

  w_ih, w_hh, b_ih, b_hh = (jnp.asarray(t.detach().numpy())
                            for t in cell.weights())
  e, p = jnp.asarray(emb.numpy()), jnp.asarray(proj.numpy())

  def jax_step(h, token):
    x = e[token]
    gi, gh = w_ih @ x + b_ih, w_hh @ h + b_hh
    r = jax.nn.sigmoid(gi[:H] + gh[:H])
    z = jax.nn.sigmoid(gi[H:2 * H] + gh[H:2 * H])
    n = jnp.tanh(gi[2 * H:] + r * gh[2 * H:])
    h = (1 - z) * n + z * h
    return h, h @ p

  start = np.arange(B) % V
  h0 = np.zeros((B, H), np.float32)
  with torch.no_grad():
    got_t, got_s = beam_search_decode(step, torch.from_numpy(h0),
                                      torch.from_numpy(start), T, K, K)
  want_t, want_s = jax_search.beam_search_decode(
      jax_step, jnp.asarray(h0), jnp.asarray(start), T, K, K)
  np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                             atol=SCORE_TOL)
  np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
