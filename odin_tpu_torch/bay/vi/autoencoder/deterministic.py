"""DistEncoder of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/deterministic.py``); ``Autoencoder`` lives
with the core in ``variational_autoencoder.py``."""
from __future__ import annotations

from typing import Optional

import torch

from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    Autoencoder,
    VariationalAutoencoder,
)
from odin_tpu_torch.training.core import as_noise

__all__ = ["Autoencoder", "DistEncoder"]


class DistEncoder(VariationalAutoencoder):
  """An encoder and its distribution head trained by the likelihood of the
  target: batches are (x, y) and the loss is ``-log q(y | encoder(x))``
  (y = x where a batch has no target)."""

  def __init__(self, latents: Optional[RVconf] = None, **kwargs):
    if latents is None:
      latents = RVconf(10, "onehot", projection=True, name="targets")
    super().__init__(latents=latents, **kwargs)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    if y is None:
      y = x
    qy = self._apply(params, "encode", x, training, mutables, as_noise(rng))
    llk = {"llk_targets": qy.log_prob(y)}
    kl = {"kl": torch.zeros(x.shape[0], dtype=torch.float32,
                            device=x.device)}
    return llk, kl, dict(qz=qy, px=qy, z=qy.mean(), x=x, y=y)

  def predict(self, x):
    return self.encode(x)
