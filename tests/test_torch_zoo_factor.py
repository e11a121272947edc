"""FactorVAE of the port against the JAX package on the CPU (the checks
of tests/test_torch_zoo.py; Factor2VAE's in
tests/test_torch_zoo_factor2.py), and what is FactorVAE's own:
the discriminator's params and its Adam state (b1 0.5, b2 0.9, lr 1e-4)
after a step (its moments within 1e-4 of each tensor's largest element:
a gradient's float32 rounding), ``pretrain()`` building a step without
the discriminator, an odd batch refused, and the discriminator with
BatchNorm against flax's module (its running statistics carried in the
state's mutables)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.bay.vi.autoencoder.factor_discriminator import (
    FactorDiscriminator as JaxDiscriminator)
from odin_tpu_torch.bay.vi.autoencoder import FactorDiscriminator
from odin_tpu_torch.weights import (from_jax_mutables, to_jax_mutables,
                                    to_jax_params)
from torch_training_common import jax_adam
from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              port_tree, step_matches_jax)

torch.set_num_threads(2)

DISC = dict(discriminator_units=(16, 16))
CLASSES = {
    "FactorVAE": dict(tc_coef=35.0, **DISC),
    "FactorVAE-maximize": dict(tc_coef=6.4, maximize_tc=True, **DISC),
}


def _pair(case):
  return make_pair(case.split("-")[0], **CLASSES[case])


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_matches_jax(case):
  check_class(_pair(case))


def check_class(pair):
  """The ELBO terms and one full step of `pair` against JAX, and the
  discriminator's Adam moments after that step."""
  elbo_matches_jax(pair, binary_images(B, 60))
  js, s, _, m = step_matches_jax(pair, binary_images(2 * B, 61))
  assert {"elbo/loss", "disc/loss", "disc/dtc_loss"} <= set(m)
  # the discriminator's Adam: its moments after one step are (1 - b) g
  # and (1 - b) g^2 of the same gradient
  adam = jax_adam(js.opt_states["discriminator"])
  for field in ("mu", "nu"):
    want = port_tree(getattr(adam, field))["discriminator"]
    got = s.opt_states["discriminator"][field]["discriminator"]
    for k in want:  # each within 1e-4 of the tensor's largest element
      w = want[k].numpy()
      np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                 atol=1e-4 * float(np.abs(w).max()),
                                 err_msg=f"{field} {k}")


def test_discriminator_optimizer_is_adam_at_its_own_settings():
  _, vae = _pair("FactorVAE")
  step = vae.make_step_fn(learning_rate=3e-3)
  opt = step.optimizers["discriminator"]
  assert (opt.alias, opt.learning_rate, opt.b1, opt.b2) == (
      "adam", 1e-4, 0.5, 0.9)
  assert step.optimizers["vae"].learning_rate == 3e-3


def test_pretrain_builds_a_step_without_the_discriminator():
  jvae, vae = _pair("FactorVAE")
  vae.pretrain()
  jvae.pretrain()
  step = vae.make_step_fn()
  assert [ts.name for ts in step.train_steps] == ["elbo"]
  assert set(vae.state.opt_states) == {"vae"}
  js, s, _, m = step_matches_jax((jvae, vae), binary_images(2 * B, 3))
  assert "tc" not in m  # no TC term while pretraining
  for k, v in s.params["discriminator"].items():
    assert torch.equal(v, vae.state.params["discriminator"][k])
  vae.finetune()
  assert [ts.name for ts in vae.make_step_fn().train_steps] == ["elbo",
                                                                "disc"]


def test_an_odd_batch_is_refused():
  _, vae = _pair("FactorVAE")
  with pytest.raises(ValueError, match="odd size"):
    vae.make_step_fn()(vae.state, binary_images(2 * B + 1, 4))


def test_discriminator_with_batchnorm_matches_flax():
  """Training mode: the batch statistics normalise and the running ones
  move (flax's apply with mutable=['batch_stats']); eval mode: the running
  ones normalise."""
  units = (12, 12)
  disc = FactorDiscriminator(units=units, batchnorm=True)
  disc.build((4,), torch.Generator().manual_seed(0))
  jdisc = JaxDiscriminator(units=units, batchnorm=True)
  z = np.random.RandomState(0).randn(16, 4).astype(np.float32)
  params = {k: v.detach() for k, v in disc.named_parameters()}
  stats = {k: v.detach() for k, v in disc.named_buffers()}
  variables = {"params": to_jax_params(disc), **to_jax_mutables(disc)}
  want, new = jdisc.apply(variables, jnp.asarray(z), training=True,
                          mutable=["batch_stats"])
  from odin_tpu_torch.networks.base import collecting_updates
  disc.train()
  with collecting_updates() as updates:
    got = torch.func.functional_call(disc, {**params, **stats},
                                     (torch.from_numpy(z),))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-5, atol=1e-5)
  moved = {f"{name}.{buf}": v for (m, buf), v in updates.items()
           for name, mm in disc.named_modules() if mm is m}
  want_stats = from_jax_mutables(jax.device_get(new))
  assert set(moved) == set(want_stats) == set(stats)
  for k, v in want_stats.items():
    np.testing.assert_allclose(moved[k].detach().numpy(), v.numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=k)
  disc.eval()
  variables = {"params": to_jax_params(disc), **jax.device_get(new)}
  want = jdisc.apply(variables, jnp.asarray(z), training=False)
  got = torch.func.functional_call(
      disc, {**params, **{k: v.detach() for k, v in moved.items()}},
      (torch.from_numpy(z),))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-5, atol=1e-5)


def test_batchnorm_discriminator_trains_its_running_statistics():
  """The JAX package's FactorVAE drops an extra network's batch_stats at
  build, so its batchnorm=True cannot step; the port carries them in
  ``state.mutables['discriminator']``, moved by both training steps."""
  _, vae = make_pair("FactorVAE", discriminator_units=(8,), batchnorm=True)
  before = dict(vae.state.mutables["discriminator"])
  assert set(before) == {"BatchNorm_0.mean", "BatchNorm_0.var"}
  s, m = vae.make_step_fn()(vae.state, binary_images(2 * B, 5))
  after = s.mutables["discriminator"]
  assert not torch.equal(after["BatchNorm_0.mean"], before["BatchNorm_0.mean"])
  assert all(torch.isfinite(v).all() for v in after.values())
  assert int(s.skipped_updates) == 0
  # the state's own tensors were not written
  for k, v in before.items():
    assert torch.equal(v, vae.state.mutables["discriminator"][k])
