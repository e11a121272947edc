"""The port's VQ-VAE (``bay/vi/autoencoder/vq_vae.py``) against the JAX
package on the CPU: the quantizer's codes, indices, commitment and
codebook losses; VQVAE with a gradient-trained and with an EMA codebook
(the checks of tests/test_torch_zoo.py, the EMA statistics after a step
within 1e-6); a dead-code restart with JAX's draws injected; and the
spatial VQ-VAE on ``vq_dsprites_networks`` at full width (B = 4)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.bay.vi.autoencoder.vq_vae import (
    VectorQuantizer as JaxQuantizer)
from odin_tpu.networks.image_networks import (
    vq_dsprites_networks as jax_vq_networks)
from odin_tpu_torch.bay.vi.autoencoder import VectorQuantizer
from odin_tpu_torch.networks import vq_dsprites_networks
from odin_tpu_torch.weights import to_jax_mutables, to_jax_params
from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              port_mutables, step_matches_jax)

torch.set_num_threads(2)


@pytest.mark.parametrize("ema", [False, True])
@pytest.mark.parametrize("shape", [(12, 6), (3, 4, 4, 6)])
def test_quantizer_matches_flax(ema, shape):
  vq = VectorQuantizer(n_codes=8, code_dim=5, commitment_weight=0.3, ema=ema)
  vq.build(shape[1:], torch.Generator().manual_seed(0))
  jvq = JaxQuantizer(n_codes=8, code_dim=5, commitment_weight=0.3, ema=ema)
  h = np.random.RandomState(1).randn(*shape).astype(np.float32)
  variables = {"params": to_jax_params(vq), **to_jax_mutables(vq)}
  want = jvq.apply(variables, jnp.asarray(h))
  got = vq.eval()(torch.from_numpy(h))
  np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
  for name in ("codes", "inputs"):
    np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                               np.asarray(getattr(want, name)), rtol=1e-5,
                               atol=1e-6, err_msg=name)
  for name in ("commitment_loss", "codebook_loss", "kl_divergence"):
    np.testing.assert_allclose(getattr(got, name)().detach().numpy(),
                               np.asarray(getattr(want, name)()), rtol=1e-5,
                               atol=1e-6, err_msg=name)


CLASSES = {
    "codebook": dict(n_codes=8),
    "ema": dict(n_codes=8, ema=True, ema_decay=0.9),
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_vqvae_matches_jax(case):
  pair = make_pair("VQVAE", **CLASSES[case])
  elbo_matches_jax(pair, binary_images(B, 60))
  js, s, _, m = step_matches_jax(pair, binary_images(B, 61))
  assert "perplexity" in m
  if case == "ema":  # the codebook moved by its EMA, not by gradient
    assert set(s.mutables["vae"]) == {"latents.codebook", "latents.counts",
                                      "latents.means"}
    assert "latents.codebook" not in s.params["vae"]
    assert not torch.equal(s.mutables["vae"]["latents.counts"],
                           pair[1].state.mutables["vae"]["latents.counts"])


def test_dead_code_restart_with_injected_draws():
  """With a fast decay the codes no row picked fall below the usage
  threshold in one step (0.1 against 0.9 of the uniform share): they are
  re-seeded with the batch rows JAX's randint draw picks."""
  pair = make_pair("VQVAE", n_codes=8, ema=True, restart_dead=True,
                   dead_frac=0.9, ema_decay=0.1)
  js, s, _, _ = step_matches_jax(pair, binary_images(B, 62))
  counts = s.mutables["vae"]["latents.counts"].numpy()
  restarted = counts == 1.0
  assert 0 < restarted.sum() < len(counts)
  cb = s.mutables["vae"]["latents.codebook"].numpy()
  np.testing.assert_allclose(cb, port_mutables(js.mutables)[
      "latents.codebook"], rtol=1e-6, atol=1e-6)


def test_codes_round_trip():
  _, vae = make_pair("VQVAE", n_codes=8)
  x = binary_images(B, 63)
  idx = vae.encode_codes(x)
  assert idx.shape == (B,) and idx.dtype == torch.int64
  px = vae.decode_codes(idx)
  _, want = vae.reconstruct(x)
  np.testing.assert_allclose(px.mean().detach().numpy(),
                             want.mean().detach().numpy(), rtol=1e-5)


def test_spatial_vqvae_on_the_dsprites_map_networks():
  kw = dict(spatial=True, ema=True, n_codes=16, code_dim=8)
  pair = make_pair("VQVAE", networks=vq_dsprites_networks(),
                   jax_networks=jax_vq_networks(), **kw)
  x = binary_images(4, 64, shape=(64, 64, 1))
  jvae, vae = pair
  qz, px = vae.reconstruct(x)
  assert qz.indices.shape == (4, 8, 8) and px.mean().shape == (4, 64, 64, 1)
  elbo_matches_jax(pair, x, steps=(0,))
  step_matches_jax(pair, binary_images(4, 65, shape=(64, 64, 1)))
