"""VariationalAutoencoder of the port: build, encode, decode, reconstruct
(PyTorch port of ``VAECore`` and parts of ``VariationalAutoencoder``,
``odin_tpu/bay/vi/autoencoder/variational_autoencoder.py:55-101,193-310``).
Training (``elbo_components``, ``fit``) comes with a later slice."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from odin_tpu_torch.bay.distributions import Distribution
from odin_tpu_torch.bay.layers.dense_distribution import DistributionDense
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi._base import VariationalModel
from odin_tpu_torch.device import resolve_device

__all__ = ["VAECore", "VariationalAutoencoder"]


def _as_head(head) -> DistributionDense:
  if isinstance(head, RVconf):
    return head.create_posterior()
  if isinstance(head, DistributionDense):
    return head
  raise ValueError(f"cannot interpret {head!r} as a distribution head")


class VAECore(nn.Module):
  """encoder -> latents head; decoder -> observation head.  Its parameter
  names follow the flax tree (``encoder.layers.1.weight`` is
  ``encoder/layers_1/Conv_0/kernel``; see ``odin_tpu_torch.weights``)."""

  def __init__(self, encoder: nn.Module, decoder: nn.Module,
               latents: DistributionDense, observation: DistributionDense):
    super().__init__()
    self.encoder = encoder
    self.decoder = decoder
    self.latents = latents
    self.observation = observation

  def build(self, input_shape, generator=None):
    h = self.encoder.build(tuple(input_shape), generator)
    z = self.latents.build(h, generator)
    self.observation.build(self.decoder.build(z, generator), generator)

  def encode(self, x) -> Distribution:
    return self.latents(self.encoder(x))

  def decode(self, z) -> Distribution:
    return self.observation(self.decoder(z))

  def forward(self, x):
    qz = self.encode(x)
    return self.decode(qz.mean()), qz


class VariationalAutoencoder(VariationalModel):
  """Vanilla VAE: ``vae = BetaVAE(**get_networks('dsprites')).build()``,
  then ``qz = vae.encode(x)``, ``px = vae.decode(z)``,
  ``qz, px = vae.reconstruct(x)``.  Images are NHWC."""

  def __init__(self,
               encoder: nn.Module,
               decoder: nn.Module,
               latents: Union[RVconf, DistributionDense],
               observation: Union[RVconf, DistributionDense],
               input_shape: Optional[Tuple[int, ...]] = None,
               analytic: bool = False,
               reverse: bool = True,
               free_bits: Optional[float] = None,
               sample_shape: Union[int, Tuple[int, ...]] = (),
               allow_negative_kl: bool = True,
               name: Optional[str] = None,
               **kwargs):
    super().__init__(analytic=analytic, reverse=reverse, free_bits=free_bits,
                     sample_shape=sample_shape,
                     allow_negative_kl=allow_negative_kl, name=name)
    if kwargs.get("labels") is not None:
      raise NotImplementedError("labels heads are not ported yet")
    self.latents_conf = latents if isinstance(latents, RVconf) else None
    self.core = VAECore(encoder, decoder, _as_head(latents),
                        _as_head(observation))
    self.input_shape = tuple(input_shape) if input_shape is not None else None
    self.device: Optional[torch.device] = None

  @property
  def zdim(self) -> int:
    return int(np.prod(self.core.latents.event_shape))

  @property
  def latents_prior(self) -> Optional[Distribution]:
    return (self.latents_conf.create_prior() if self.latents_conf is not None
            else self.core.latents.prior)

  def build(self, input_shape: Optional[Sequence[int]] = None, seed: int = 1,
            device: Union[str, torch.device] = "cuda"
            ) -> "VariationalAutoencoder":
    """Create the parameters from `seed` (drawn on the CPU, so that a seed
    gives the same weights on every device) and move them to `device`."""
    if input_shape is not None:
      self.input_shape = tuple(i for i in input_shape if i is not None)
    if self.input_shape is None:
      raise ValueError("input_shape must be provided")
    device = resolve_device(device)
    self.core.build(self.input_shape, torch.Generator().manual_seed(seed))
    self.core.to(device).eval()
    self.device = device
    return self

  def _tensor(self, x) -> torch.Tensor:
    if self.device is None:
      raise RuntimeError("call build() first")
    return torch.as_tensor(x, dtype=torch.float32).to(self.device)

  def encode(self, x) -> Distribution:
    """x (B, H, W, C) -> qz."""
    return self.core.encode(self._tensor(x))

  def decode(self, z) -> Union[Distribution,
                               Tuple[Distribution, Tuple[int, ...]]]:
    """z (B, zdim) -> px.  z with leading sample dims (S..., B, zdim) is
    decoded as (S·...·B, zdim) and returns ``(px, lead)``, ``lead`` the
    shape z had without its last dim, as in the JAX package."""
    z = self._tensor(z)
    if z.ndim > 2:
      lead = tuple(z.shape[:-1])
      return self.core.decode(z.reshape(-1, z.shape[-1])), lead
    return self.core.decode(z)

  def reconstruct(self, x) -> Tuple[Distribution, Distribution]:
    """x -> (qz, px) through the posterior mean: encode, then decode E[z|x]."""
    qz = self.encode(x)
    return qz, self.core.decode(qz.mean())
