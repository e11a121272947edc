"""StochasticVAE and ImputeVAE of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/stochastic_vae.py``)."""
from __future__ import annotations

from typing import List

import torch

from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE
from odin_tpu_torch.training.core import TrainStep

__all__ = ["StochasticVAE", "ImputeVAE"]


class StochasticVAE(BetaVAE):
  """Two training steps a iteration over the same ELBO and partition, with
  one shared optimizer: 'posterior' (reporting the KL terms), then
  'likelihood' (reporting the llk terms) on the params the first
  updated."""

  def _encoder_loss(self, params, batch, rng, step, mutables):
    llk, kl, _ = self.elbo_components(params, batch, rng, step,
                                      training=True, mutables=mutables)
    loss = -torch.mean(self.elbo(llk, kl))
    return loss, ({f"enc_{k}": torch.mean(v) for k, v in kl.items()},
                  mutables)

  def _decoder_loss(self, params, batch, rng, step, mutables):
    llk, kl, _ = self.elbo_components(params, batch, rng, step,
                                      training=True, mutables=mutables)
    loss = -torch.mean(self.elbo(llk, kl))
    return loss, ({f"dec_{k}": torch.mean(v) for k, v in llk.items()},
                  mutables)

  def train_steps(self) -> List[TrainStep]:
    return [
        TrainStep(loss_fn=self._encoder_loss, partitions=("vae",),
                  optimizer="vae", name="posterior"),
        TrainStep(loss_fn=self._decoder_loss, partitions=("vae",),
                  optimizer="vae", name="likelihood"),
    ]


class ImputeVAE(BetaVAE):
  """A VAE that fills in missing entries by repeated encode and decode."""

  @torch.no_grad()
  def impute(self, x, mask, n_iter: int = 10, seed: int = 0) -> torch.Tensor:
    """`x` with its entries where `mask` is 0 (1: observed) replaced, `n_iter`
    times, by the mean of px at the posterior mean."""
    x = self._tensor(x)
    mask = self._tensor(mask).to(x.dtype)
    x_hat = x * mask
    for _ in range(int(n_iter)):
      _, px = self.reconstruct(x_hat)
      x_hat = x * mask + px.mean() * (1.0 - mask)
    return x_hat
