"""The hyperspherical VAEs of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/hyperbolic_vae.py``): a von Mises-Fisher or
Power Spherical posterior on the unit sphere, the uniform prior, the
analytic KL, and beta annealed linearly as in ``AnnealingVAE``."""
from __future__ import annotations

from typing import Optional, Union

from odin_tpu_torch.backend.interpolation import Interpolation, linear
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE

__all__ = ["HypersphericalVAE", "PowersphericalVAE"]


class HypersphericalVAE(BetaVAE):
  """Hyperspherical VAE (Davidson et al. 2018)."""

  def __init__(self,
               latents: Optional[RVconf] = None,
               distribution: str = "vonmisesfisher",
               beta: Union[float, Interpolation] = None,
               **kwargs):
    if beta is None:
      beta = linear(vmin=1e-6, vmax=1.0, steps=2000, delay_in=0)
    if latents is None:
      latents = RVconf(64, name="latents")
    alias = {"vonmisesfisher": "vmf", "vmf": "vmf",
             "powerspherical": "powerspherical"}[str(distribution).lower()]
    kwargs.setdefault("analytic", True)
    super().__init__(latents=latents.copy(posterior=alias), beta=beta,
                     **kwargs)


class PowersphericalVAE(HypersphericalVAE):
  """HypersphericalVAE with the Power Spherical posterior."""

  def __init__(self, **kwargs):
    kwargs.pop("distribution", None)
    super().__init__(distribution="powerspherical", **kwargs)
