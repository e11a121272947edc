"""The port's structured dropout (``odin_tpu_torch/networks/dropout.py``)
against the JAX package's (``odin_tpu/networks/dropout.py``).

Where JAX's draws can be reproduced the outputs are held exactly: the
module is applied with ``jax.random.bernoulli`` and ``jax.random.binomial``
wrapped to record the uniforms a Bernoulli draw compares with its
probability and the Binomial's counts, and the port replays them through
``Noise(eps=...)`` (outputs within 1e-6 of their largest magnitude, the
masks equal).  The port's own samplers are held by their moments: the
dropped share of 200,000 entries within 5 binomial standard errors of its
rate, and the changed counts' mean within 5 standard errors of the
Binomial(count, 1 - corrupt_rate) mean given that it is below the count.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.networks.dropout as J
import odin_tpu_torch.networks.dropout as P
from odin_tpu_torch.networks.base import collecting_updates
from odin_tpu_torch.training.core import Noise
from torch_layer_common import close

SIGMAS = 5.0


def _jax_with_draws(monkeypatch, module, x, seed=0):
  """``module`` applied in training mode, and the uniforms behind its
  Bernoulli draws and its Binomial draws, in order."""
  draws = []
  bernoulli, binomial = jax.random.bernoulli, jax.random.binomial

  def rec_bernoulli(key, p=0.5, shape=None, **kw):
    draws.append(np.asarray(jax.random.uniform(key, shape, jnp.float32)))
    return bernoulli(key, p, shape, **kw)

  def rec_binomial(key, n, p, *args, **kw):
    out = binomial(key, n, p, *args, **kw)
    draws.append(np.asarray(out, np.float32))
    return out

  monkeypatch.setattr(jax.random, "bernoulli", rec_bernoulli)
  monkeypatch.setattr(jax.random, "binomial", rec_binomial)
  y = module.apply({}, jnp.asarray(x), training=True,
                   rngs={"dropout": jax.random.PRNGKey(seed)})
  return np.asarray(y), draws


def _counts(shape, seed=0):
  return np.random.RandomState(seed).poisson(4.0, shape).astype(np.float32)


@pytest.mark.parametrize("noise_shape", [None, (1, 12)])
def test_discrete_dropout_matches_jax_draws(monkeypatch, noise_shape):
  x = _counts((6, 12)) + np.float32(0.3)  # rounded to counts inside
  kw = dict(dropout_rate=0.4, corrupt_rate=0.3, noise_shape=noise_shape)
  want, draws = _jax_with_draws(monkeypatch, J.DiscreteDropout(**kw), x)
  assert len(draws) == 2
  m = P.DiscreteDropout(**kw).train()
  got = m(torch.from_numpy(x), rng=Noise(eps=[torch.from_numpy(d.copy())
                                              for d in draws]))
  close(got.numpy(), want, 1e-6)
  dropped = np.broadcast_to(draws[0] < 0.4, x.shape)
  assert np.array_equal(got.numpy() != x, dropped & (draws[1] != x))


@pytest.mark.parametrize("blocksize,shape", [(3, (2, 9, 8, 3)),
                                             (4, (2, 8, 10, 2)),
                                             (7, (1, 5, 6, 2))])
def test_dropblock_matches_jax_draws(monkeypatch, blocksize, shape):
  """Odd and even blocks (XLA's SAME window puts the extra row and column
  at the end), and a block larger than the map (cut to its size)."""
  x = np.random.RandomState(1).randn(*shape).astype(np.float32)
  want, draws = _jax_with_draws(monkeypatch, J.DropBlock(0.3, blocksize), x)
  assert len(draws) == 1
  m = P.DropBlock(0.3, blocksize).train()
  got = m(torch.from_numpy(x),
          rng=Noise(eps=[torch.from_numpy(draws[0].copy())]))
  close(got.numpy(), want, 1e-6)
  assert np.array_equal(got.numpy() == 0, want == 0)


def test_eval_and_rate_zero_are_the_identity():
  x = torch.from_numpy(_counts((4, 5)))
  img = torch.randn(1, 4, 4, 2)
  assert torch.equal(P.DiscreteDropout().eval()(x), x)
  assert torch.equal(P.DiscreteDropout(0.0).train()(x), x)
  assert torch.equal(P.DropBlock(0.5).eval()(img), img)
  assert torch.equal(P.DropBlock(0.0).train()(img), img)
  with pytest.raises(RuntimeError, match="rng="):
    P.DropBlock(0.5).train()(img)
  with pytest.raises(ValueError, match="NHWC"):
    P.DropBlock(0.5).train()(torch.ones(2, 3), rng=torch.Generator())


def test_discrete_dropout_moments():
  """The port's own draws: the dropped share at its rate, the thinned
  counts at ``count · (1 - corrupt_rate)``, from a generator and from the
  step's noise alike."""
  rate, corrupt, c = 0.3, 0.25, 6.0
  x = torch.full((400, 500), c)
  m = P.DiscreteDropout(rate, corrupt).train()
  y = m(x, rng=torch.Generator().manual_seed(0))
  changed = y != x
  n = x.numel()
  # an entry is dropped with p = rate; a dropped count of 6 keeps all its
  # units with (1 - corrupt)^6, so the changed share is rate·(1 - that)
  p_change = rate * (1 - (1 - corrupt) ** c)
  share = float(changed.float().mean())
  assert abs(share - p_change) <= SIGMAS * np.sqrt(p_change * (1 - p_change)
                                                    / n)
  thinned = y[changed]
  mean_want = (c * (1 - corrupt) - c * (1 - corrupt) ** c) / \
      (1 - (1 - corrupt) ** c)  # a Binomial's mean given it is below c
  assert float(thinned.max()) < c and float(thinned.min()) >= 0
  var_t = float(thinned.var())
  assert abs(float(thinned.mean()) - mean_want) <= SIGMAS * np.sqrt(
      var_t / thinned.numel())
  with collecting_updates(Noise(torch.Generator().manual_seed(1))):
    y2 = m(x)
  assert abs(float((y2 != x).float().mean()) - p_change) <= SIGMAS * np.sqrt(
      p_change * (1 - p_change) / n)


def test_dropblock_keeps_its_rate_and_rescales():
  """Blocks of 3 at rate 0.1 on 64 x 64 maps: the dropped share near the
  rate (the seeds fall only where a block fits; overlaps make it a little
  less), the kept values rescaled by the realised keep fraction, and whole
  3 x 3 blocks dropped together."""
  rate = 0.1
  m = P.DropBlock(rate, 3).train()
  x = torch.ones(8, 64, 64, 4)
  y = m(x, rng=torch.Generator().manual_seed(0))
  dropped = (y == 0).float()
  share = float(dropped.mean())
  assert 0.8 * rate <= share <= 1.05 * rate
  kept = y[y != 0]
  torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - share)))
  # every dropped pixel lies in a fully dropped 3 x 3 square: the
  # morphological opening of the dropped map is the map itself
  pool = torch.nn.functional.max_pool2d
  pad = torch.nn.functional.pad
  d = dropped.permute(0, 3, 1, 2)
  eroded = -pool(-pad(d, (1, 1, 1, 1), value=1.0), 3, stride=1)
  assert torch.equal(pool(pad(eroded, (1, 1, 1, 1)), 3, stride=1), d)
