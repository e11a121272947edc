"""The implicit rank-minimising autoencoders of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/irm_vae.py``): a chain of linear layers with
no bias and no activation after the encoder, which gradient descent drives
toward low-rank codes (Jing, Zbontar & LeCun 2020)."""
from __future__ import annotations

from torch import nn

from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    Autoencoder,
    VariationalAutoencoder,
)
from odin_tpu_torch.networks.base import Dense, SequentialNetwork

__all__ = ["ImplicitRankMinimizer", "irmVAE", "irmAE"]


class ImplicitRankMinimizer(nn.Module):
  """`n_layers` linear maps to `units` (flax's ``irm_<i>`` Dense layers, or
  one ``irm_shared`` applied `n_layers` times, which needs an input of
  `units` features)."""

  def __init__(self, units: int = 64, n_layers: int = 3,
               share_weights: bool = False):
    super().__init__()
    self.units = int(units)
    self.n_layers = int(n_layers)
    self.share_weights = bool(share_weights)
    names = ["irm_shared"] if share_weights else \
        [f"irm_{i}" for i in range(self.n_layers)]
    for name in names:
      self.add_module(name, Dense(self.units, use_bias=False, bare=True))

  def build(self, in_shape, generator=None):
    shape = tuple(in_shape)
    for layer in self.children():
      shape = layer.build(shape, generator)
    return shape

  def forward(self, x):
    if self.share_weights:
      for _ in range(self.n_layers):
        x = self.irm_shared(x)
      return x
    for layer in self.children():
      x = layer(x)
    return x


class irmVAE(VariationalAutoencoder):
  """A VAE whose encoder ends in an ``ImplicitRankMinimizer``."""

  def __init__(self,
               latents=None,
               n_layers: int = 3,
               share_weights: bool = False,
               irm_units: int = 64,
               encoder=None,
               **kwargs):
    if latents is None:
      latents = RVconf(64, "mvndiag", projection=True, name="latents")
    if encoder is not None:
      layers = list(encoder.layers) if isinstance(encoder, SequentialNetwork) \
          else [encoder]
      encoder = SequentialNetwork(layers + [ImplicitRankMinimizer(
          units=int(irm_units), n_layers=int(n_layers),
          share_weights=share_weights)])
    super().__init__(latents=latents, encoder=encoder, **kwargs)


class irmAE(irmVAE):
  """The deterministic IRM autoencoder: 'vdeterministic' latents, z their
  value, a KL term of 0."""

  def __init__(self, latents=None, **kwargs):
    if latents is None:
      latents = RVconf(64, "vdeterministic", projection=True, name="latents")
    elif isinstance(latents, RVconf):
      latents = latents.copy(posterior="vdeterministic")
    super().__init__(latents=latents, **kwargs)

  # the deterministic autoencoder's terms
  elbo_components = Autoencoder.elbo_components
