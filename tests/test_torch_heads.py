"""Heads built from an ``RVconf`` and the weights' digest, against the JAX
package on the CPU.

  * A head given as an ``RVconf`` is named by its role ('latents',
    'observation'), whatever the RVconf's own name, so the ELBO's metric
    keys are JAX's; a ``DistributionDense`` given as a head keeps its name.
  * ``RVconf`` has JAX's fields in JAX's order, so a positional call binds
    the same fields, ``autoregressive`` and ``dropout`` among them.
  * ``md5_checksum`` hashes the params as the JAX package does (flax's
    leaves, layouts and order), so the same weights give the same digest.
The ELBO terms are held at the limit of tests/test_torch_elbo.py (rtol
1e-4); digests and keys exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu.bay.random_variable import RVconf as JaxRVconf
from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu.training.core import TrainState as JaxTrainState
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.weights import from_jax_state, to_jax_params
from torch_training_common import binary_images, make_pair

torch.set_num_threads(2)

RTOL = 1e-4
B = 4


def _pair_with_latents(port_latents, jax_latents):
  nets = dict(get_networks("dsprites", zdim=10), latents=port_latents)
  vae = port_vi.BetaVAE(**nets).build(seed=1, device="cpu")
  jnets = dict(jax_get_networks("dsprites", zdim=10), latents=jax_latents)
  jvae = jax_vi.BetaVAE(**jnets)
  jvae.input_shape = (64, 64, 1)
  jvae.state = JaxTrainState(
      params={"vae": to_jax_params(vae.core)}, opt_states={},
      step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(2), mutables={})
  return jvae, vae


def test_rvconf_head_named_otherwise_gives_jax_metric_keys():
  jvae, vae = _pair_with_latents(RVconf((10,), "mvndiag", name="z"),
                                 JaxRVconf((10,), "mvndiag", name="z"))
  assert vae.core.latents.name == jvae.latents_head.name == "latents"
  x = binary_images(B, 11)
  key = jax.random.PRNGKey(7)
  eps = np.array(jax.random.normal(jax.random.split(key)[1], (B, 10)))
  jllk, jkl = jax.jit(lambda p: jvae.elbo_components(p, x, key, 0)[:2])(
      jvae.state.params)
  llk, kl, _ = vae.elbo_components(vae.state.params, torch.from_numpy(x),
                                   torch.from_numpy(eps), 0)
  assert set(llk) == set(jllk) == {"llk_image"}
  assert set(kl) == set(jkl) == {"kl_latents"}
  for got, want in ((llk, jllk), (kl, jkl)):
    for k in want:
      np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                 rtol=RTOL)
  # the training step's metrics carry the same keys
  step = vae.make_step_fn(learning_rate=1e-3)
  _, metrics = step(vae.state, x, eps=torch.from_numpy(eps))
  assert "kl_latents" in metrics and "kl_z" not in metrics


def test_observation_rvconf_is_named_observation():
  nets = dict(get_networks("dsprites", zdim=10))
  nets["observation"] = RVconf((64, 64, 1), "bernoulli", projection=False,
                               name="pixels")
  vae = port_vi.BetaVAE(**nets)
  jnets = dict(jax_get_networks("dsprites", zdim=10))
  jnets["observation"] = JaxRVconf((64, 64, 1), "bernoulli",
                                   projection=False, name="pixels")
  assert vae.core.observation.name == \
      jax_vi.BetaVAE(**jnets).observation_head.name == "observation"
  # a DistributionDense given as the head keeps its own name, in both
  assert port_vi.BetaVAE(**get_networks("dsprites", zdim=10)).core \
      .observation.name == "image"


@pytest.mark.parametrize("args", [
    ((10,), "mvndiag", True, False, 0.0, "z"),
    (4, "normal", False),
    ((3, 2), "bernoulli", True, False, 0.0, "obs", None)])
def test_positional_rvconf_binds_the_same_fields(args):
  port, jax_conf = RVconf(*args), JaxRVconf(*args)
  fields = [f.name for f in dataclasses.fields(RVconf)]
  assert fields == [f.name for f in dataclasses.fields(JaxRVconf)]
  for name in fields:
    assert getattr(port, name) == getattr(jax_conf, name), name
  assert port.create_posterior().name == jax_conf.create_posterior().name
  assert port.create_posterior("role").name == "role"


@pytest.mark.parametrize("kw", [dict(autoregressive=True),
                                dict(dropout=0.1)])
def test_autoregressive_and_dropout_raise(kw):
  """Both fields are ported: given by keyword or by position, the RVconf
  and the head it makes carry them as JAX's do (the heads' numbers are
  held in tests/test_torch_dist_layers.py)."""
  for port, jconf in ((RVconf((10,), "mvndiag", **kw),
                       JaxRVconf((10,), "mvndiag", **kw)),
                      (RVconf((10,), "mvndiag", True,
                              kw.get("autoregressive", False),
                              kw.get("dropout", 0.0)),
                       JaxRVconf((10,), "mvndiag", True,
                                 kw.get("autoregressive", False),
                                 kw.get("dropout", 0.0)))):
    assert (port.autoregressive, port.dropout) == \
        (jconf.autoregressive, jconf.dropout)
    head, jhead = port.create_posterior(), jconf.create_posterior()
    assert (head.autoregressive, head.dropout, head.params_size) == \
        (jhead.autoregressive, jhead.dropout, jhead.params_size)


def test_md5_checksum_equals_jax_digest_of_the_same_state():
  jvae, vae = make_pair(beta=1.0)
  other = port_vi.BetaVAE(**get_networks("dsprites", zdim=10)).build(
      seed=5, device="cpu")
  assert other.md5_checksum() != jvae.md5_checksum()
  other.state = from_jax_state(jax.device_get(jvae.state), device="cpu")
  assert other.md5_checksum() == jvae.md5_checksum()
  # the model whose params JAX's state was made from hashes the same
  assert vae.md5_checksum() == jvae.md5_checksum()
