"""Shared set-up of the training parity tests (tests/test_torch_elbo.py,
tests/test_torch_training*.py): the JAX package's and the port's dSprites
beta-VAE on the same params, and the JAX package's noise replayed from its
keys.

Params after N Adam steps (``assert_params_close``): every element within
2·lr·N of JAX's, the most Adam can move an element apart (each update is
mu_hat/sqrt(nu_hat), at most lr in size whatever the gradient), and all but
2e-5 of the elements (7 of the model's 373,685) within atol 1e-5, 1 % of
one step at lr 1e-3.  The share is for elements whose gradient is small
against its running RMS: the update divides by that RMS and carries the
packages' float32 rounding differences into the param magnified (measured:
single elements 1.1e-6 to 1.5e-4 apart after two steps).

The JAX model is not built (flax's init takes about 10 s here): its state
is made from the port's freshly built params, carried across with
``to_jax_params``, with the PRNG key ``build(seed=1)`` would give it.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu.training.core import TrainState as JaxTrainState
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.weights import from_jax_params, to_jax_params

ZDIM = 10


def make_pair(seed=1, cls="BetaVAE", **kwargs):
  """(JAX model, the port's model on the CPU), same params: the class
  `cls` of both packages' ``bay.vi`` (the BetaVAE by default)."""
  vae = getattr(port_vi, cls)(**kwargs, **get_networks(
      "dsprites", zdim=ZDIM)).build(seed=seed, device="cpu")
  jvae = getattr(jax_vi, cls)(**kwargs, **jax_get_networks("dsprites",
                                                          zdim=ZDIM))
  jvae.input_shape = (64, 64, 1)
  jvae.state = JaxTrainState(
      params={"vae": to_jax_params(vae.core)}, opt_states={},
      step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(seed + 1),
      mutables={})
  return jvae, vae


def binary_images(n, seed):
  return (np.random.RandomState(seed).rand(n, 64, 64, 1) < 0.5).astype(
      np.float32)


def step_noise(rng, batch, dtype=jnp.float32, accum_steps=1):
  """(next key, eps) of one JAX training step from the state's key: the
  step splits the key (training/core.py:251), the loss splits its share
  again and draws ``normal(k2, (B, zdim))`` (variational_autoencoder.py:333,
  continuous.py:417-419); with microbatches the share is split once per
  microbatch first."""
  rng, step_rng = jax.random.split(rng)

  def draw(key, n):
    return jax.random.normal(jax.random.split(key)[1], (n, ZDIM), dtype)

  if accum_steps == 1:
    eps = draw(step_rng, batch)
  else:
    eps = jnp.stack([draw(k, batch // accum_steps)
                     for k in jax.random.split(step_rng, accum_steps)])
  return rng, np.array(eps.astype(jnp.float32))


def port_tree(tree):
  """A JAX {partition: flax tree} -> the port's {partition: state_dict}."""
  return {k: from_jax_params(v) for k, v in tree.items()}


def np_tree(tree):
  return {k: {n: t.detach().cpu().numpy() for n, t in v.items()}
          for k, v in tree.items()}


def jax_adam(opt_state):
  """The ScaleByAdamState inside an optax state (a chain is a tuple)."""
  return next(n for n in jax.tree_util.tree_leaves(
      opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(n, "mu"))


PARAM_ATOL = 1e-5
FAR_SHARE = 2e-5


def assert_params_close(got, want, n_steps, lr=1e-3, atol=PARAM_ATOL,
                        share=FAR_SHARE):
  """`got` (port) and `want` (numpy or tensors) {name: array} after
  `n_steps` Adam steps at `lr`: the rule in this module's docstring."""
  assert set(got) == set(want)
  n_far = n_all = 0
  for k, w in want.items():
    d = np.abs(np.asarray(got[k], np.float32) - np.asarray(w, np.float32))
    assert d.max() <= 2 * lr * n_steps + 1e-6, (k, float(d.max()))
    n_far += int((d > atol).sum())
    n_all += d.size
  assert n_far <= share * n_all, f"{n_far} of {n_all} elements beyond {atol}"


def run_both(pair, n_steps=2, batch=4, lr=1e-3, jax_dtype=jnp.float32,
             **kwargs):
  """`n_steps` of both packages' step built with `kwargs` (a torch
  ``compute_dtype`` becomes JAX's bfloat16), from the same state and back:
  ((JAX metrics, port metrics) per step, JAX state, port state)."""
  jvae, vae = pair
  start = (jvae.state, vae.state)
  jkw = dict(kwargs)
  if "compute_dtype" in jkw:
    jkw["compute_dtype"] = jnp.bfloat16
  jstep = jax.jit(jvae.make_step_fn(learning_rate=lr, jit=False, **jkw))
  step = vae.make_step_fn(learning_rate=lr, **kwargs)
  js, s = jvae.state, vae.state
  rng, mets = js.rng, []
  accum = kwargs.get("accum_steps", 1)
  for i in range(n_steps):
    x = binary_images(batch, 40 + i)
    rng, eps = step_noise(rng, batch, jax_dtype, accum)
    js, jm = jstep(js, x)
    s, m = step(s, x, eps=torch.from_numpy(eps))
    mets.append((jax.device_get(jm), m))
  jvae.state, vae.state = start
  return mets, jax.device_get(js), s


def check_run(mets, js, s, loss_rtol=1e-4, lr=1e-3, adam_count=True,
              **close):
  """Losses at `loss_rtol`, params by ``assert_params_close``, Adam's
  count (with `adam_count`) and the step count exactly."""
  for jm, m in mets:
    assert set(jm) == set(m)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=loss_rtol)
  assert_params_close(np_tree(s.params)["vae"], port_tree(js.params)["vae"],
                      len(mets), lr=lr, **close)
  if adam_count:
    assert int(s.opt_states["vae"]["count"]) == \
        int(jax_adam(js.opt_states["vae"]).count)
  assert int(s.step) == int(js.step)
