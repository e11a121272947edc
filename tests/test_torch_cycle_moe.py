"""The port's CycleConsistentVAE and MoeVAE against the JAX package on
the CPU, on the 8x8 networks of tests/test_zoo_execution.py (and, for the
mixture of experts' second modality, a 5-vector on a Dense(16) MLP with a
Gaussian head), JAX's draws replayed.  The ELBO terms within rtol 1e-5,
three Adam steps, the flax trees against the JAX inits, the pair and
unpaired paths of the cycle VAE, and ``cross_generate``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu.bay.random_variable import RVconf as JaxRVconf
from odin_tpu.networks.base import Dense as JaxDense
from odin_tpu.networks.base import SequentialNetwork as JaxSequential
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.networks import Dense, SequentialNetwork
from odin_tpu_torch.training.core import Noise
from torch_zoo_common import (B, assert_tree_matches_jax_init, binary_images,
                              elbo_matches_jax, jax_state_of, make_pair,
                              steps_match_jax, tiny_networks)

torch.set_num_threads(2)

SDIM = 3


@pytest.fixture(scope="module")
def cycle():
  return make_pair("CycleConsistentVAE", sdim=SDIM, cycle_weight=2.0)


def pair_batch(seed, stacked=False):
  x1, x2 = binary_images(B, seed), binary_images(B, seed + 1)
  return np.stack([x1, x2], 1) if stacked else (x1, x2)


@pytest.mark.parametrize("form", ["pair", "stacked", "unpaired"])
def test_cycle_elbo_terms_match_jax(cycle, form):
  batch = {"pair": pair_batch(1), "stacked": pair_batch(1, stacked=True),
           "unpaired": binary_images(B, 1)}[form]
  elbo_matches_jax(cycle, batch, steps=(0,))


def test_cycle_three_adam_steps_match_jax(cycle):
  steps_match_jax(cycle, [pair_batch(10 + 2 * i) for i in range(3)])


def test_cycle_flax_tree_matches_jax_init(cycle):
  assert_tree_matches_jax_init(*cycle, jnp.zeros((1, 8, 8, 1)))


def test_cycle_terms_and_decode():
  _, vae = make_pair("CycleConsistentVAE", sdim=SDIM)
  x1, x2 = (torch.from_numpy(a) for a in pair_batch(3))
  llk, kl, aux = vae.elbo_components(
      vae.state.params, (x1, x2), Noise(torch.Generator().manual_seed(0)), 0)
  assert set(kl) == {"kl_latents", "cycle_consistency"}
  assert bool(torch.isfinite(kl["cycle_consistency"]).all())
  assert aux["s"].shape == (B, SDIM) and aux["z"].shape == (B, 4)
  # a second member of another shape is no pair: the plain ELBO
  llk, kl, _ = vae.elbo_components(
      vae.state.params, (x1, x2[:, :4]), Noise(torch.Generator()), 0)
  assert set(kl) == {"kl_latents"}
  px = vae.decode(torch.zeros(2, 4))
  assert px.mean().shape == (2, 8, 8, 1)


def moe_parts(package):
  if package == "jax":
    rv, dense = JaxRVconf, JaxDense
    seq = lambda layers, name: JaxSequential(tuple(layers), name=name)
  else:
    rv, dense = RVconf, Dense
    seq = lambda layers, name: SequentialNetwork(layers)
  nets = tiny_networks(package)
  return dict(
      encoders=[nets["encoder"], seq([dense(16, "relu")], "encoder1")],
      decoders=[nets["decoder"], seq([dense(16, "relu")], "decoder1")],
      observations=[nets["observation"],
                    rv((5,), "gaussian", projection=True, name="factors")],
      latents=rv((4,), "mvndiag", projection=True, name="latents"),
      input_shapes=[(8, 8, 1), (5,)])


@pytest.fixture(scope="module")
def moe():
  vae = port_vi.MoeVAE(**moe_parts("torch")).build(seed=1, device="cpu")
  jvae = jax_vi.MoeVAE(**moe_parts("jax"))
  jvae.input_shape = vae.input_shape
  jvae.state = jax_state_of(vae)
  return jvae, vae


def moe_batch(seed, n=B):
  return (binary_images(n, seed),
          np.random.RandomState(seed).randn(n, 5).astype(np.float32))


def test_moe_elbo_terms_match_jax(moe):
  elbo_matches_jax(moe, moe_batch(1), steps=(0,))


def test_moe_three_adam_steps_match_jax(moe):
  steps_match_jax(moe, [moe_batch(10 + i) for i in range(3)])


def test_moe_flax_tree_matches_jax_init(moe):
  jvae, vae = moe
  assert_tree_matches_jax_init(jvae, vae, (jnp.zeros((1, 8, 8, 1)),
                                           jnp.zeros((1, 5))))


@pytest.mark.parametrize("route", [(0, 1), (1, 0), (1, 1)])
def test_moe_cross_generate_matches_jax(moe, route):
  jvae, vae = moe
  x = moe_batch(4)[route[0]]
  got = vae.cross_generate(x, from_mod=route[0], to_mod=route[1])
  want = jvae.cross_generate(x, from_mod=route[0], to_mod=route[1])
  np.testing.assert_allclose(got.mean().numpy(), np.asarray(want.mean()),
                             rtol=1e-5, atol=1e-6)
  assert vae.input_shape == (8, 8, 1)
