"""The gene-expression VAEs at their published widths against the JAX
package on the CPU: the cortex ``VariationalAutoencoder`` (558 genes,
``LogNorm``, two Dense(128) each way, a 'zinbd' observation, 'mvndiag'
latents of zdim 10) and the pbmc ``M2VAE`` (1000 genes, 4 cell types),
on the same weights (carried with ``to_jax_params``), the same
``SyntheticGenes`` counts (30 % zeroed) and JAX's draws replayed.

  * the ELBO terms within 1e-4 of each term's largest magnitude over the
    batch: the ZINB log-likelihood sums ``lgamma(x + θ) - lgamma(θ) -
    lgamma(x + 1)`` over the genes, which cancel to a term of about -2e3
    whose float32 rounding differs between the two packages' lgamma;
  * the gradient of the loss, each tensor within 1e-4 of its largest
    element;
  * three Adam steps at the gene sets' learning rate (1e-4,
    ``get_optimizer_info``), the metrics of each and the params after them
    by ``torch_training_common.assert_params_close``;
  * pbmc's batches are those ``chip_smoke.py`` phase 20 trains on: 10 % of
    the cells labelled (``gene_ssl_arrays``), through ``DataPipeline``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.training.core import Noise
from torch_zoo_common import (assert_terms_close, jit_with_draws, make_pair,
                              steps_match_jax, to_torch)

TOL = 1e-4
B = 16
LR = 1e-4  # get_optimizer_info's first rate for cortex and pbmc


def gene_batch(n_genes, n_types, seed, n=B, labelled=False):
  """`n` cells of ``SyntheticGenes`` counts (float32); with `labelled`, a
  batch of 64 (x, one-hot y, mask) rows as ``chip_smoke.py`` phase 20
  feeds pbmc's M2VAE: ``gene_ssl_arrays`` (10 % of the cells labelled)
  through the port's ``DataPipeline``."""
  from odin_tpu_torch.fuel import DataPipeline, SyntheticGenes
  ds = SyntheticGenes(n_cells=8 * max(n, 64), n_genes=n_genes,
                      n_types=n_types, seed=seed)
  x, y = ds.numpy("train")
  if not labelled:
    return x[:n].astype(np.float32)
  import chip_smoke
  arrays = chip_smoke.gene_ssl_arrays(np, x, y, n_types, seed=seed)
  batch = next(iter(DataPipeline(arrays, batch_size=64, shuffle=True,
                                 epochs=1, drop_remainder=True, seed=seed,
                                 prefetch=0)))
  return tuple(np.asarray(b.numpy() if hasattr(b, "numpy") else b)
               for b in batch)


def cortex_pair(**kwargs):
  return make_pair("VariationalAutoencoder",
                   networks=get_networks("cortex", **kwargs),
                   jax_networks=jax_get_networks("cortex", **kwargs))


def pbmc_pair():
  return make_pair("M2VAE",
                   networks=get_networks("pbmc", is_semi_supervised=True),
                   jax_networks=jax_get_networks("pbmc",
                                                 is_semi_supervised=True))


def _torch_batch(batch):
  return tuple(torch.from_numpy(b) for b in batch) if isinstance(
      batch, tuple) else torch.from_numpy(batch)


def terms_and_grads_match(pair, batch, key=3):
  """The ELBO terms and the loss's gradient of both packages, JAX's draws
  injected, in training mode (the loss the step differentiates)."""
  jvae, vae = pair

  def jloss(p, b, k):
    llk, kl = jvae.elbo_components(p, b, k, jnp.int32(0), training=True,
                                   mutables=jvae.state.mutables)[:2]
    return -jnp.mean(jvae.elbo(llk, kl)), (llk, kl)

  fn = jit_with_draws(jax.value_and_grad(jloss, has_aux=True))
  ((jl, (jllk, jkl)), jgrad), draws = fn(jvae.state.params, batch,
                                         jax.random.PRNGKey(key))
  params = {part: {k: v.detach().clone().requires_grad_(True)
                   for k, v in tree.items()}
            for part, tree in vae.state.params.items()}
  llk, kl, _ = vae.elbo_components(params, _torch_batch(batch),
                                   Noise(eps=to_torch(draws)),
                                   torch.tensor(0, dtype=torch.int32),
                                   training=True,
                                   mutables=dict(vae.state.mutables))
  loss = -vae.elbo(llk, kl).mean()
  loss.backward()
  assert_terms_close({**llk, **kl}, {**jllk, **jkl}, rtol=TOL)
  np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
  from odin_tpu_torch.weights import from_jax_params
  for part, tree in jgrad.items():
    want = from_jax_params(jax.device_get(tree))
    for name, w in want.items():
      g = params[part][name].grad.numpy()
      w = w.numpy()
      np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max(),
                                 err_msg=f"{part}/{name}")


def test_cortex_networks_match_jax():
  pair = cortex_pair()
  jvae, vae = pair
  assert vae.core.observation.posterior == "zinbd"
  assert vae.core.observation.event_shape == (558,)
  assert vae.core.latents.posterior == "mvndiag"
  assert vae.core.latents.event_shape == (10,)
  x = gene_batch(558, 7, seed=1)
  assert (x == 0).mean() > 0.3
  terms_and_grads_match(pair, x)


def test_cortex_three_adam_steps_match_jax():
  pair = cortex_pair()
  steps_match_jax(pair, [gene_batch(558, 7, seed=s) for s in (4, 5, 6)],
                  lr=LR)


def test_pbmc_m2vae_matches_jax():
  pair = pbmc_pair()
  terms_and_grads_match(pair, gene_batch(1000, 4, seed=2, labelled=True))


def steps_along_jax(pair, batches, lr=LR):
  """len(batches) Adam steps of both packages, the port restarted at each
  step from JAX's state (``from_jax_state``: params, Adam's moments and
  counts): the metrics of each step within rtol 1e-5 (atol 1e-6) and the
  params after it by ``assert_params_close`` for one step.  Both models'
  states are left as they were."""
  from odin_tpu_torch.weights import from_jax_state
  from torch_training_common import assert_params_close, jax_adam
  from torch_zoo_common import np_tree, port_tree
  jvae, vae = pair
  start = (jvae.state, vae.state)
  jstep = jit_with_draws(jvae.make_step_fn(learning_rate=lr, jit=False))
  step = vae.make_step_fn(learning_rate=lr)
  js = jvae.state
  for i, batch in enumerate(batches):
    s0 = vae.state if i == 0 else from_jax_state(js, device="cpu")
    (js, jm), draws = jstep(js, batch)
    s, m = step(s0, tuple(torch.from_numpy(b) for b in batch),
                eps=to_torch(draws))
    js, jm = jax.device_get(js), jax.device_get(jm)
    assert set(m) == set(jm)
    for k in jm:
      np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                 atol=1e-6, err_msg=f"{k} at step {i}")
    got, want = np_tree(s.params), port_tree(js.params)
    for part in want:
      assert_params_close(got[part], want[part], 1, lr=lr)
    for name, opt in js.opt_states.items():
      assert int(s.opt_states[name]["count"]) == int(jax_adam(opt).count) \
          == i + 1
    assert int(s.step) == int(js.step) == i + 1
  jvae.state, vae.state = start


def test_pbmc_m2vae_three_adam_steps_match_jax():
  """Three Adam steps of the pbmc M2VAE, each from JAX's state.  An
  unbroken port run drifts from JAX's: after its first step 30 of the
  4,863,184 params stand 2·lr apart (Adam's first update is about
  lr·sign(g), and these gradients are sums over the 1000 log-normalised
  genes that cancel to float32 rounding, whose sign the two packages
  round apart), 10,605 after the second; the held-out terms then move
  apart by 1e-4 of their size."""
  pair = pbmc_pair()
  steps_along_jax(pair, [gene_batch(1000, 4, seed=s, labelled=True)
                         for s in (7, 8, 9)])

VARIANTS = {
    "zinb": dict(distribution="zinb"),
    "nb": dict(distribution="nb"),
    "nbd": dict(distribution="nbd"),
    "poisson": dict(distribution="poisson"),
    "zipoisson": dict(distribution="zipoisson"),
    "mixzinb": dict(distribution="mixzinb", obs_kwargs={"n_components": 3}),
    "mvntril": dict(qz="mvntril"),
    "autoregressive": dict(latents=dict(autoregressive=True)),
    "dropout": dict(observation=dict(dropout=0.1)),
}


def _variant_networks(get, variant):
  kw = dict(VARIANTS[variant])
  obs_kwargs = kw.pop("obs_kwargs", None)
  latents = kw.pop("latents", None)
  observation = kw.pop("observation", None)
  nets = get("cortex", **kw)
  if obs_kwargs:
    nets["observation"] = nets["observation"].copy(kwargs=obs_kwargs)
  if latents:
    nets["latents"] = nets["latents"].copy(**latents)
  if observation:
    nets["observation"] = nets["observation"].copy(**observation)
  return nets


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cortex_variants_match_jax(variant):
  """The cortex VAE with another count likelihood, full-covariance or
  autoregressive latents, or dropout on the observation's raw params:
  the ELBO terms and gradients in training mode against JAX's."""
  pair = make_pair("VariationalAutoencoder",
                   networks=_variant_networks(get_networks, variant),
                   jax_networks=_variant_networks(jax_get_networks, variant))
  terms_and_grads_match(pair, gene_batch(558, 7, seed=11))
